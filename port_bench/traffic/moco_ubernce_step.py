"""MoCo UberNCE pretraining of S3D fed from host memory.

Set-up draws a pool of uint8 batches from the seed (each an anchor and a
positive view of B clips, pre-cropped, and B labels), keeps it in pinned
host memory and builds the program's model, bank, Adam and step through
the entry points the training CLI uses (``model_selector``,
``make_banks``, ``make_optimizer``, ``make_train_step``). The bank's queue
is filled with K seeded unit keys and labels uniform over the classes,
the state the queue is in once an epoch has run K / B steps.

The first three steps go through the program's own epoch
(``ubernce_train_epoch``) on three pool batches, and what they did is kept
for the check: each step's loss, the first step's queries (a forward
hook), the keys each step enqueued, the first gradient as Adam holds it
(its first moment after one step, over 1 - beta1), the key encoder's
change and the queue's labels and pointer. Two more steps warm up, then
the window hands the same objects the pool, cycled, through the same
epoch function until its time is up.

After the window the plain reference (``reference/moco_s3d.py``) runs the
three checked steps from the same weights, queue, inputs and seeds in
float32.
"""

from __future__ import annotations

import statistics
import time
from typing import Optional

import numpy as np
import torch

from .. import common, flops
from ..reference import moco_s3d as ref
from ..reference.triplet import step_seed

CHECK_STEPS = 3
WARM_STEPS = 2
VIEWS = ("anchor", "positive")


def spec(cfg) -> dict:
    """What the reference needs to know of the configuration."""
    return {"size": int(cfg.DATA.SAMPLE_SIZE),
            "dataset": str(cfg.TRAIN.DATASET),
            "lr": float(cfg.OPTIM.LR), "wd": float(cfg.OPTIM.WD)}


def seeded_queue(k: int, dim: int, classes: int, seed: int,
                 device: torch.device):
    """K unit keys from a normal draw and their labels uniform over
    ``classes``, from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) + 2)
    keys = torch.randn(k, dim, generator=g, device=device)
    keys = keys / keys.norm(dim=1, keepdim=True)
    labels = torch.randint(0, classes, (k,), generator=g, device=device)
    return keys, labels


class Setup:
    """The program's step with its model, bank and optimizer, the pool,
    and what the checked steps did."""

    def __init__(self, ctx: common.Ctx, warm: bool = True):
        from video_similarity_search_tpu_torch.models import model_selector
        from video_similarity_search_tpu_torch.train.driver import \
            make_train_step
        from video_similarity_search_tpu_torch.train.state import \
            make_optimizer
        from video_similarity_search_tpu_torch.train.steps import make_banks

        dev = ctx.device
        self.ctx = ctx
        self.cfg = cfg = common.port_cfg(ctx)
        self.b = int(cfg.TRAIN.BATCH_SIZE)
        self.classes = int(ctx.param("classes"))
        self.model = model = model_selector(cfg)
        state = common.seeded_state(model.state_dict(), ctx.seed, dev)
        model.load_state_dict(state)
        self.init = {k: v.cpu() for k, v in state.items()}
        del state
        self.banks = make_banks(cfg, 0, model)
        self.bank = self.banks["moco"]
        self.opt, sched = make_optimizer(cfg, model.parameters())
        self.step_fn, self.epoch_fn = make_train_step(
            cfg, model, self.opt, sched, self.banks, device=dev)
        keys, labels = seeded_queue(self.bank.queue.shape[0],
                                    self.bank.queue.shape[1], self.classes,
                                    ctx.seed, dev)
        self.bank.queue.copy_(keys)
        self.bank.queue_labels.copy_(labels)
        self.bank.queue_ptr.zero_()
        self.queue0 = (keys.cpu(), labels.cpu())
        self.key_init = {k: p.detach().clone()
                         for k, p in self.bank.encoder_k.named_parameters()}
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
        self.labels = rng.integers(0, self.classes, (n_pool, b))
        self.pool = common.uint8_pool(
            (2 * b, t, hw, hw, 3), np.tile(self.labels, 2), self.classes,
            ctx.seed, ctx.device, pin=ctx.device.type == "cuda")

    def batch(self, i: int) -> dict:
        j = i % len(self.pool)
        clips, b = self.pool[j], self.b
        return {"anchor": clips[:b], "positive": clips[b:],
                "targets": np.concatenate([self.labels[j]] * 2),
                "__size__": b}

    def check_batches(self):
        return [self.batch(i) for i in range(CHECK_STEPS)]

    def warm_batches(self):
        return [self.batch(CHECK_STEPS + i) for i in range(WARM_STEPS)]

    def window_source(self, i: int) -> dict:
        return self.batch(CHECK_STEPS + WARM_STEPS + i)

    def _run_epoch(self, loader, step_fn, epoch: int) -> None:
        self.epoch_fn(step_fn, loader, self.cfg, epoch, self.gen,
                      is_master=True, device=self.ctx.device)

    def _checked_steps(self) -> dict:
        names = dict(self.model.named_parameters())
        beta1 = self.opt.param_groups[0]["betas"][0]
        losses, first, queries = [], {}, []

        def keep_queries(module, inputs, out):
            queries.append(out.detach().float().cpu())

        def step(batch, gen):
            hook = (self.model.register_forward_hook(keep_queries)
                    if not losses else None)
            m = self.step_fn(batch, gen)
            if hook is not None:
                hook.remove()
            losses.append(m["loss"].detach().clone())
            if len(losses) == 1:
                # Adam's first moment after one step is (1 - beta1) times
                # the gradient it took (the weight decay added)
                norms = torch.stack([
                    self.opt.state[p]["exp_avg"].norm() / (1 - beta1)
                    for p in names.values()]).tolist()
                first.update(zip(names, norms))
            return m

        self._run_epoch(self.check_batches(), step, self.check_epoch)
        n = CHECK_STEPS * self.b
        bank = self.bank
        # the key encoder copies the query network, ``encoder_q``
        key_names = ["encoder_q." + k for k in self.key_init]
        change = torch.stack([
            (p.detach() - self.key_init[k]).norm()
            for k, p in bank.encoder_k.named_parameters()]).tolist()
        q = ref.l2norm(queries[0])
        keys = bank.queue[:n].detach().float().cpu().clone()
        queue0 = self.queue0[0]
        logits1 = torch.cat([(q * keys[:self.b]).sum(1, keepdim=True),
                             q @ queue0.T], dim=1) / ref.T_MOCO
        return {"loss": [float(v) for v in losses], "grad1": first,
                "logits1": logits1, "keys": keys,
                "key_change": dict(zip(key_names, change)),
                "queue_labels": bank.queue_labels.detach().cpu().clone(),
                "queue_ptr": int(bank.queue_ptr)}

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
        clips = len(VIEWS) * self.b
        return {"setup_s": setup_s, "steps": win.count, "clips": clips,
                "elapsed_s": elapsed,
                "train_clips_per_s": win.count * clips / elapsed,
                "percentiles": common.step_percentiles(
                    win.stamps, win.t0 + elapsed),
                "win": win, "prof": prof}

    def release(self) -> None:
        del self.model, self.opt, self.step_fn, self.epoch_fn
        del self.bank, self.banks
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, quant=None, fault: Optional[str] = None) -> dict:
        """The reference's checked steps; ``quant`` computes them in a lower
        precision (the control), ``fault`` computes a known-wrong step
        (``reference/moco_s3d.py``), both read to set the limits."""
        dev = self.ctx.device
        batches = []
        for i in range(CHECK_STEPS):
            b = self.batch(i)
            batches.append({**{v: b[v].to(dev) for v in VIEWS},
                            "labels": torch.as_tensor(self.labels[i],
                                                      device=dev)})
        seeds = [step_seed(self.check_epoch, i) for i in range(CHECK_STEPS)]
        state = {k: v.to(dev) for k, v in self.init.items()}
        return ref.run_steps(state, self.queue0[0], self.queue0[1], batches,
                             seeds, spec(self.cfg), dev, quant=quant,
                             fault=fault)


def compare(prog: dict, reference: dict) -> dict:
    """The numbers: the worst row's relative gap of the first step's
    logits (``logit_gap``); the worst enqueued key's distance from the
    reference's, both unit rows (``key_gap``); the largest relative gap
    of a step's loss (``loss_gap``); the worst and the median leaf's gap
    of the first gradient's norm (``grad_gap``, ``grad_med_gap``); the
    median leaf's gap of the norm of the key encoder's change over the
    three momentum updates (``key_enc_gap``); and the count of queue
    labels and pointer positions that differ (``queue_gap``, which has to
    be 0). A leaf whose reference gradient is under a thousandth of the
    median leaf's in every step is left out of the gradient's gaps (its
    gradient is rounding alone)."""
    grads = reference["grads"]
    names = list(reference["grad1"])
    top = {k: max(g[k] for g in grads) for k in names}
    med = float(np.median(list(top.values())))
    keep = [k for k in names if reference["grad1"][k] >= 1e-3 * med]
    grads1 = common.leaf_gaps(prog["grad1"], reference["grad1"], keep)
    kc = common.leaf_gaps(prog["key_change"], reference["key_change"],
                          list(reference["key_change"]))
    losses = [abs(p - r) / max(abs(r), 1e-6)
              for p, r in zip(prog["loss"], reference["loss"])]
    lp, lr = prog["logits1"], reference["logits1"]
    rows = (torch.linalg.vector_norm(lp - lr, dim=1)
            / torch.linalg.vector_norm(lr, dim=1))
    kp, kr = prog["keys"], reference["keys"]
    key_rows = (torch.linalg.vector_norm(kp - kr, dim=1)
                if kp.shape == kr.shape else torch.tensor([float("inf")]))
    queue_gap = (int((prog["queue_labels"] != reference["queue_labels"])
                     .sum())
                 + abs(prog["queue_ptr"] - reference["queue_ptr"]))

    def worst(g):
        return max(g, key=g.get)

    return {"logit_gap": float(rows.max()), "key_gap": float(key_rows.max()),
            "loss_gap": max(losses),
            "grad_gap": grads1[worst(grads1)],
            "grad_med_gap": statistics.median(grads1.values()),
            "key_enc_gap": statistics.median(kc.values()),
            "queue_gap": float(queue_gap),
            "_leaves": {"grad": worst(grads1), "key_enc": worst(kc),
                        "losses": [list(prog["loss"]),
                                   list(reference["loss"])],
                        "left_out": sorted(set(names) - set(keep))}}


def clip_flops(config: dict) -> float:
    """Model FLOPs a clip of a step: a pair's query forward and backward
    (3 x the forward, less the stem's input gradient) and its key forward,
    over the pair's two clips, by forward hooks over the reference
    encoder on the ``meta`` device."""
    spec_ = config["flops"]
    with torch.device("meta"):
        model = ref.MoCoS3D().eval()
        clip = torch.empty((1, spec_["frames"], spec_["size"],
                            spec_["size"], 3))
    counts = flops.model_flops_per_clip(model, clip, ref.stems(model))
    return (flops.train_flops_per_clip(counts) + counts["forward"]) / 2


def run(ctx: common.Ctx) -> dict:
    s = Setup(ctx)
    w = s.window()
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    s.release()
    numbers = compare(s.checked, s.reference())
    extra: Optional[dict] = None
    if ctx.trace:
        extra = {"clips_per_step": w["clips"],
                 "flops_per_clip": clip_flops(ctx.config),
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
    the reference computed in bf16 (the control: the precision below the
    configuration's float32), in fp8, and with each of the reference's
    faults, each against the float32 reference."""
    from ..reference.precision import fp8

    s = Setup(ctx, warm=False)
    s.release()
    full = s.reference()
    out = {"program": compare(s.checked, full)}
    if control:
        out["control"] = compare(s.reference(quant=ref.bf16), full)
        out["fp8"] = compare(s.reference(quant=fp8), full)
        for fault in ref.FAULTS:
            out[fault] = compare(s.reference(fault=fault), full)
    return out
