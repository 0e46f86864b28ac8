"""Triplet pretraining fed from host memory.

Set-up draws a pool of uint8 batches from the seed (each view of B clips,
pre-cropped or at the loader's buffer size, and B labels), keeps it in
pinned host memory and builds the program's step once: model, SGD and
step (``train/driver.py::make_train_step``). The first three steps go
through the program's own epoch (``triplet_train_epoch``) on three
different pool batches, and what they did is kept for the check: each
step's loss and the miner's negatives, the first step's embeddings (a
forward hook), the first gradient as the optimizer holds it after one
step (SGD's momentum buffer), and the parameters after the third. Two
more steps warm up, then the window hands the same objects the pool,
cycled, through the same epoch function until its time is up: the
program uploads each batch and augments it on the device.

After the window the plain reference (``reference/triplet.py``) runs the
three checked steps from the same weights, inputs and seeds in float32.
"""

from __future__ import annotations

import statistics
import time
from typing import Optional

import numpy as np
import torch

from .. import common, flops
from ..reference import triplet as ref

CHECK_STEPS = 3
WARM_STEPS = 2


def spec(cfg, views) -> dict:
    """What the reference needs to know of the configuration."""
    llc = bool(cfg.LOSS.LOCAL_LOCAL_CONTRAST)
    return {"views": list(views), "size": int(cfg.DATA.SAMPLE_SIZE),
            "crop": not bool(cfg.TPU.HOST_RRC),
            "dataset": str(cfg.TRAIN.DATASET),
            "margin": float(cfg.LOSS.MARGIN),
            "llc_weight": float(cfg.LOSS.LOCAL_LOCAL_WEIGHT),
            "llc_margin": float(cfg.LOSS.LOCAL_LOCAL_MARGIN) if llc else None,
            "lr": float(cfg.OPTIM.LR), "momentum": float(cfg.OPTIM.MOMENTUM),
            "alpha": int(cfg.SLOWFAST.ALPHA)}


class Setup:
    """The program's step with its model and optimizer, the pool, and what
    the checked steps did."""

    def __init__(self, ctx: common.Ctx, warm: bool = True):
        from video_similarity_search_tpu_torch.models import model_selector
        from video_similarity_search_tpu_torch.train.driver import \
            make_train_step
        from video_similarity_search_tpu_torch.train.state import \
            make_optimizer

        dev = ctx.device
        self.ctx = ctx
        self.cfg = cfg = common.port_cfg(ctx)
        self.views = ctx.workload["traffic_params"]["views"]
        self.b = int(cfg.TRAIN.BATCH_SIZE)
        self.model = model = model_selector(cfg)
        state = common.seeded_state(model.state_dict(), ctx.seed, dev)
        model.load_state_dict(state)
        self.init = {k: v.cpu() for k, v in state.items()}
        del state
        model.to(dev)
        if dev.type == "cuda":
            model.to(memory_format=torch.channels_last_3d)
        self.opt, sched = make_optimizer(cfg, model.parameters())
        self.step_fn, self.epoch_fn = make_train_step(
            cfg, model, self.opt, sched, {}, device=dev)
        self.gen = torch.Generator(device=dev)
        self.check_epoch = 2 * ctx.seed
        self.window_epoch = 2 * ctx.seed + 1
        self.make_feed()
        self.checked = self._checked_steps()
        if warm:
            self._run_epoch(self.warm_batches(), self.step_fn,
                            self.check_epoch)
        common.synchronize(dev)

    # the feed: a pool of batches in pinned host memory

    def make_feed(self) -> None:
        ctx, cfg, b = self.ctx, self.cfg, self.b
        t, hw = int(cfg.DATA.SAMPLE_DURATION), int(ctx.param("frame_hw"))
        n_pool = int(ctx.param("pool_batches"))
        rng = np.random.default_rng(ctx.seed)
        classes = int(ctx.param("classes"))
        self.labels = rng.integers(0, classes, (n_pool, b))
        self.pool = common.uint8_pool(
            (len(self.views) * b, t, hw, hw, 3),
            np.tile(self.labels, len(self.views)), classes, ctx.seed,
            ctx.device, pin=ctx.device.type == "cuda")

    def batch(self, i: int) -> dict:
        j = i % len(self.pool)
        clips, b = self.pool[j], self.b
        out = {v: clips[k * b:(k + 1) * b] for k, v in enumerate(self.views)}
        out["targets"] = np.concatenate([self.labels[j], self.labels[j]])
        out["__size__"] = b
        return out

    def check_batches(self):
        return [self.batch(i) for i in range(CHECK_STEPS)]

    def warm_batches(self):
        return [self.batch(CHECK_STEPS + i) for i in range(WARM_STEPS)]

    def window_source(self, i: int) -> dict:
        return self.batch(CHECK_STEPS + WARM_STEPS + i)

    def reference_batches(self, half: bool) -> list:
        """The checked steps' uint8 views on the device and targets;
        ``half`` keeps the first half of each."""
        out = []
        for i in range(CHECK_STEPS):
            b = self.batch(i)
            keep = self.b // 2 if half else self.b
            out.append({
                **{v: b[v][:keep].to(self.ctx.device) for v in self.views},
                "targets": torch.as_tensor(np.concatenate(
                    [self.labels[i][:keep]] * 2), device=self.ctx.device)})
        return out

    def _run_epoch(self, loader, step_fn, epoch: int) -> None:
        self.epoch_fn(step_fn, loader, self.cfg, epoch, self.gen,
                      is_master=True, device=self.ctx.device)

    def _checked_steps(self) -> dict:
        names = dict(self.model.named_parameters())
        losses, picks, first, emb = [], [], {}, []

        def keep_embeddings(module, inputs, out):
            emb.append(out.detach().float().cpu())

        def step(batch, gen):
            hook = (self.model.register_forward_hook(keep_embeddings)
                    if not losses else None)
            m = self.step_fn(batch, gen)
            if hook is not None:
                hook.remove()
            losses.append(m["loss"].detach().clone())
            picks.append(m["negatives"].detach().clone())
            if len(losses) == 1:
                # a parameter the optimizer holds no buffer for after a
                # step has not been given its gradient
                norms = torch.stack([
                    self.opt.state.get(p, {}).get(
                        "momentum_buffer", torch.zeros((), device=p.device)
                    ).norm() for p in names.values()]).tolist()
                first.update(zip(names, norms))
            return m

        self._run_epoch(self.check_batches(), step, self.check_epoch)
        change = torch.stack([
            (p.detach() - self.init[k].to(p.device)).norm()
            for k, p in names.items()]).tolist()
        return {"loss": [float(v) for v in losses], "grad1": first,
                "change": dict(zip(names, change)),
                "picks": [p.cpu() for p in picks], "emb1": emb[0]}

    def window(self) -> dict:
        """The measured window -> the run's counts and times."""
        ctx = self.ctx
        prof = common.make_profiler(ctx.device) if ctx.trace else None
        win = common.Window(self.window_source,
                            ctx.seconds, ctx.device, "driver.step",
                            profiler=prof, limit=ctx.scale.get("window_steps"))
        setup_s = time.perf_counter() - ctx.t_start
        _, elapsed = common.run_window(
            win, lambda w: self._run_epoch(w, self.step_fn,
                                           self.window_epoch))
        clips = len(self.views) * self.b
        out = {"setup_s": setup_s, "steps": win.count, "clips": clips,
               "elapsed_s": elapsed,
               "train_clips_per_s": win.count * clips / elapsed,
               "percentiles": common.step_percentiles(
                   win.stamps, win.t0 + elapsed),
               "win": win, "prof": prof}
        return out

    def release(self) -> None:
        del self.model, self.opt, self.step_fn, self.epoch_fn
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, quant=None, half: bool = False,
                  picks=None) -> dict:
        """The reference's checked steps; ``picks``: the judged run's
        negatives, which the reference's losses take; ``quant`` computes
        them in a lower precision (the control), ``half`` leaves out the
        second half of every batch (a fault, read to set the limits)."""
        dev = self.ctx.device
        arch = self.ctx.config["reference"]
        batches = self.reference_batches(half)
        seeds = [ref.step_seed(self.check_epoch, i)
                 for i in range(CHECK_STEPS)]
        state = {k: v.to(dev) for k, v in self.init.items()}
        return ref.run_steps(arch, state, batches, seeds,
                             spec(self.cfg, self.views), dev, quant=quant,
                             picks=picks)


def compare(prog: dict, reference: dict) -> dict:
    """The numbers: the largest relative gap of a step's loss and the
    first step's alone; the worst row's relative gap of the first step's
    train-mode embeddings; the reference's judgement of the judged run's
    negative picks (``reference`` took them: ``reference/triplet.py``);
    and the worst and the median leaf's gap of the first gradient's norm
    and of the norm of the change over the checked steps. With ``top`` a
    leaf's largest reference gradient norm over the steps, a leaf whose
    ``top`` is under a thousandth of the median leaf's is left out of both
    (a bias under BatchNorm has a gradient of rounding alone), and one
    whose first gradient is under that is left out of the first
    gradient's (a branch behind a zero-scale BatchNorm gets none in the
    first step). The workload's ``limits`` say which of them decide
    ``correct``."""
    grads = reference["grads"]
    names = list(reference["grad1"])
    top = {k: max(g[k] for g in grads) for k in names}
    med = float(np.median(list(top.values())))
    keep = [k for k in names if top[k] >= 1e-3 * med]
    keep1 = [k for k in keep if reference["grad1"][k] >= 1e-3 * med]
    gaps = [abs(p - r) / max(abs(r), 1e-6)
            for p, r in zip(prog["loss"], reference["loss"])]
    grads1 = common.leaf_gaps(prog["grad1"], reference["grad1"], keep1)
    changes = common.leaf_gaps(prog["change"], reference["change"], keep)

    def worst(g):
        return max(g, key=g.get)

    if prog["emb1"].shape == reference["emb1"].shape:
        rows = (torch.linalg.vector_norm(prog["emb1"] - reference["emb1"],
                                         dim=1)
                / torch.linalg.vector_norm(reference["emb1"], dim=1))
    else:  # embeddings of another batch
        rows = torch.tensor([float("inf")])
    change_med = statistics.median(reference["change"][k] for k in keep)
    worst3 = sorted(changes, key=changes.get, reverse=True)[:3]
    return {"loss_gap": max(gaps), "loss1_gap": gaps[0],
            "emb1_gap": float(rows.max()),
            "pick_gap": reference["pick_gap"],
            "grad_gap": grads1[worst(grads1)],
            "grad_med_gap": float(np.median(list(grads1.values()))),
            "change_gap": changes[worst(changes)],
            "change_med_gap": float(np.median(list(changes.values()))),
            "_leaves": {"grad": worst(grads1), "change": worst(changes),
                        # the three worst leaves of the change: gap, the
                        # program's and the reference's norm; the median
                        "change_worst": [[k, changes[k], prog["change"][k],
                                          reference["change"][k]]
                                         for k in worst3],
                        "change_median_norm": change_med,
                        "losses": [list(prog["loss"]),
                                   list(reference["loss"])],
                        "left_out": sorted(set(names) - set(keep)),
                        "left_out_first": len(set(names) - set(keep1))}}


def run(ctx: common.Ctx) -> dict:
    s = Setup(ctx)
    w = s.window()
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    s.release()
    numbers = compare(s.checked, s.reference(picks=s.checked["picks"]))
    extra: Optional[dict] = None
    if ctx.trace:
        extra = {"clips_per_step": w["clips"],
                 "flops_per_clip": flops.clip_flops(ctx.config)["train"],
                 **common.outside(w["win"], w["elapsed_s"])}
    return {"attempted": w["steps"], "failed": 0, "peak": peak,
            "e2e": {ctx.workload["rate_metric"]: w["train_clips_per_s"],
                    "setup_s": w["setup_s"]},
            "numbers": numbers, "window": w, "trace_extra": extra,
            "info": {"percentiles": w["percentiles"],
                     "checked_losses": s.checked["loss"]}}


def calibrate(ctx: common.Ctx, control: bool) -> dict:
    """The readings that the limits are set from: the program's numbers
    against the reference on ``ctx.seed``; with ``control`` also those of
    the reference computed in fp8 and of the reference fed half of each
    batch (a fault), each against the float32 reference."""
    s = Setup(ctx, warm=False)
    s.release()
    return readings(s, control)


def readings(s: Setup, control: bool) -> dict:
    from ..reference.precision import fp8

    out = {"program": compare(s.checked,
                              s.reference(picks=s.checked["picks"]))}
    stem = next(iter(s.checked["change"]))
    out["look"] = {"leaf": stem, "change_over_norm":
                   s.checked["change"][stem] / float(s.init[stem].norm())}
    if control:
        low = s.reference(quant=fp8)
        out["control"] = compare(low, s.reference(picks=low["picks"]))
        full = s.reference()
        v, d = len(s.views), full["emb1"].shape[1]
        full["emb1"] = full["emb1"].view(v, s.b, d)[:, :s.b // 2].reshape(
            -1, d)  # the rows the half batch has
        out["half_batch"] = compare(s.reference(half=True), full)
    return out
