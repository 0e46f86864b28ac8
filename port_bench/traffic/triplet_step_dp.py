"""Data-parallel triplet pretraining over the cards of one host, one rank a
card on NCCL (the program's ``parallel/dist.py``), fed from host memory.

Rank 0 runs in the benchmark's own process on ``ctx.device``; it starts
ranks 1 .. W-1 itself, as processes of this module (``python -m
port_bench.traffic.triplet_step_dp <arguments as JSON>``) on cards 1 ..
W-1, and they meet at a ``tcp://`` rendezvous on localhost. Each rank
builds the program's model, SGD and step (``train/driver.py::
make_train_step``) from the same seeded weights, and keeps in pinned host
memory its rows of a pool of global batches drawn from the seed as the
one-card cell draws its own (``common.uint8_pool``): W x B anchors,
positives and extras a step, rank r holding rows [r B, (r + 1) B) of each
view. The program's step then gathers the global batch: triplet mining
over it, BatchNorm statistics all-reduced, gradients summed.

The first step goes through the program's epoch (``triplet_train_epoch``)
on every rank and is kept for the check: the global step-1 embeddings
(each rank's, gathered), the miner's negatives, the loss and rank 0's
summed first gradient (SGD's momentum buffer after one step). Two more
steps warm up. Then rank 0's window (``common.Window``) decides how many
steps the epoch takes: before each step it tells the other ranks, over a
gloo group on the host, whether one more follows, so that every rank
takes the same number. Only rank 0 is profiled. The rate counts the
global W x 3B clips a step; the peak memory is the largest of the ranks'.

A rank that dies ends the run with an error: rank 0 watches its children
and leaves at once when one fails; a rank whose parent is gone leaves
too; every collective has ``RANK_TIMEOUT_S``.

For the calibration, ``scale["fault"]`` plants one of ``FAULTS`` in every
rank's program: an exchange between the cards left out, which the check
is there to catch.

After the window the plain reference (``reference/triplet.py``, with its
R3D-18 from ``reference/models.py``) runs the first step on the global
batch in float32, each residual block recomputed in the backward pass
(``torch.utils.checkpoint``) and the activations it keeps for the stem and
the first stage held in host memory, so that the whole global batch fits
on one card.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from dataclasses import replace
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import common, flops
from ..reference import models
from ..reference import triplet as ref
from .triplet_step import spec

CHECK_STEPS = 1
WARM_STEPS = 2
RANK_TIMEOUT_S = 300  # rendezvous and each collective
JOIN_S = 120  # the other ranks' exit after the window
POLL_S = 0.5  # the watchdogs' period
# the program's exchanges between the cards, each left out: the gradients
# not summed (``sum_gradients`` a no-op), BatchNorm on each rank's own
# statistics (``_SyncBatchNorm``'s all-reduces the identity)
FAULTS = ("grad_sum_skipped", "bn_local_stats")


def rank_device(ctx: common.Ctx, rank: int) -> torch.device:
    if ctx.device.type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def pool_rows(shape, labels, classes: int, seed: int, device: torch.device,
              rows: torch.Tensor, pin: bool) -> list:
    """``common.uint8_pool``'s clips, drawn alike on every rank, of which
    each batch keeps ``rows`` in (pinned) host memory."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) + 1)
    colors = torch.randint(30, 226, (classes, 3), generator=g, device=device,
                           dtype=torch.int16)
    rows = rows.to(device)
    out = []
    for row in labels:
        lab = torch.as_tensor(row, device=device).long()
        x = torch.randint(-60, 61, shape, generator=g, device=device,
                          dtype=torch.int16)
        x += colors[lab].view(-1, *([1] * (len(shape) - 2)), 3)
        keep = x.index_select(0, rows).clamp_(0, 255).to(torch.uint8)
        host = torch.empty(keep.shape, dtype=torch.uint8, pin_memory=pin)
        host.copy_(keep)
        out.append(host)
    return out


class Rank:
    """One rank: the program's step, this rank's rows of the pool, and
    what the checked step did."""

    def __init__(self, ctx: common.Ctx, rank: int, world: int,
                 warm: bool = True):
        from video_similarity_search_tpu_torch.models import model_selector
        from video_similarity_search_tpu_torch.parallel import \
            broadcast_module
        from video_similarity_search_tpu_torch.train.driver import \
            make_train_step
        from video_similarity_search_tpu_torch.train.state import \
            make_optimizer

        self.ctx, self.rank, self.world = ctx, rank, world
        self.dev = dev = rank_device(ctx, rank)
        self.views = ctx.workload["traffic_params"]["views"]
        self.b = int(ctx.param("anchors_per_rank"))
        self.cfg = cfg = common.port_cfg(ctx)
        cfg.merge_from_list(["TRAIN.BATCH_SIZE", str(self.b * world)])
        self.model = model = model_selector(cfg)
        state = common.seeded_state(model.state_dict(), ctx.seed, dev)
        model.load_state_dict(state)
        if rank == 0:
            self.init = {k: v.cpu() for k, v in state.items()}
        del state
        model.to(dev)
        broadcast_module(model)
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

    def make_feed(self) -> None:
        ctx, b, v = self.ctx, self.b, len(self.views)
        t = int(self.cfg.DATA.SAMPLE_DURATION)
        hw = int(ctx.param("frame_hw"))
        n_pool = int(ctx.param("pool_batches"))
        classes = int(ctx.param("classes"))
        bg = b * self.world
        rng = np.random.default_rng(ctx.seed)
        self.labels = rng.integers(0, classes, (n_pool, bg))
        self.shape = (v * bg, t, hw, hw, 3)
        rows = torch.cat([torch.arange(k * bg + self.rank * b,
                                       k * bg + (self.rank + 1) * b)
                          for k in range(v)])
        self.pool = pool_rows(self.shape, np.tile(self.labels, v), classes,
                              ctx.seed, self.dev, rows,
                              pin=self.dev.type == "cuda")

    def batch(self, i: int) -> dict:
        j = i % len(self.pool)
        clips, b = self.pool[j], self.b
        mine = self.labels[j][self.rank * b:(self.rank + 1) * b]
        out = {v: clips[k * b:(k + 1) * b] for k, v in enumerate(self.views)}
        out["targets"] = np.concatenate([mine, mine])
        out["__size__"] = b
        return out

    def check_batches(self):
        return [self.batch(i) for i in range(CHECK_STEPS)]

    def warm_batches(self):
        return [self.batch(CHECK_STEPS + i) for i in range(WARM_STEPS)]

    def source(self, i: int) -> dict:
        return self.batch(CHECK_STEPS + WARM_STEPS + i)

    def _run_epoch(self, loader, step_fn, epoch: int) -> None:
        self.epoch_fn(step_fn, loader, self.cfg, epoch, self.gen,
                      is_master=self.rank == 0, device=self.dev)

    def _checked_steps(self) -> dict:
        from video_similarity_search_tpu_torch.parallel import gather_parts

        names = dict(self.model.named_parameters())
        out, emb = {}, []

        def keep_embeddings(module, inputs, o):
            emb.append(o.detach().float())

        def step(batch, gen):
            hook = self.model.register_forward_hook(keep_embeddings)
            m = self.step_fn(batch, gen)
            hook.remove()
            out["loss"] = float(m["loss"])
            out["picks"] = m["negatives"].detach().cpu()
            # a parameter the optimizer holds no buffer for after a step has
            # not been given its gradient
            norms = torch.stack([
                self.opt.state.get(p, {}).get(
                    "momentum_buffer", torch.zeros((), device=p.device)
                ).norm() for p in names.values()]).tolist()
            out["grad1"] = dict(zip(names, norms))
            return m

        self._run_epoch(self.check_batches(), step, self.check_epoch)
        with torch.no_grad():
            out["emb1"] = gather_parts(emb[0], len(self.views)).cpu()
        return out

    def release(self) -> None:
        del self.model, self.opt, self.step_fn, self.epoch_fn, self.pool
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# the ranks and their agreement on the number of steps

class Flags:
    """Rank 0 tells the other ranks, over a gloo group on the host, whether
    one more step follows; a host-side exchange, so it never waits on a
    card."""

    def __init__(self, timeout: float):
        import torch.distributed as dist

        self.dist = dist
        self.group = dist.new_group(backend="gloo",
                                    timeout=timedelta(seconds=timeout))

    def send(self, more: bool) -> None:
        self.dist.broadcast(torch.tensor([int(more)]), 0, group=self.group)

    def receive(self) -> bool:
        t = torch.zeros(1, dtype=torch.int64)
        self.dist.broadcast(t, 0, group=self.group)
        return bool(t.item())

    def largest(self, values) -> list:
        t = torch.tensor(values, dtype=torch.float64)
        self.dist.all_reduce(t, op=self.dist.ReduceOp.MAX, group=self.group)
        return t.tolist()


def leading(win, flags: Flags):
    """Rank 0's loader: the window's items, each announced to the others;
    the end announced when the window stops."""
    for item in win:
        flags.send(True)
        yield item
    flags.send(False)


class Following:
    """Another rank's loader: an item for each step rank 0 announces."""

    def __init__(self, source, flags: Flags):
        self.source, self.flags, self.count = source, flags, 0

    def __iter__(self):
        while self.flags.receive():
            yield self.source(self.count)
            self.count += 1


def join_group(ctx: common.Ctx, rank: int, world: int, port: int) -> None:
    from video_similarity_search_tpu_torch.parallel import \
        initialize_distributed

    dev = rank_device(ctx, rank)
    backend = ctx.param("backend")
    if backend == "auto":
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    initialize_distributed(f"tcp://127.0.0.1:{port}", world, rank,
                           backend=backend,
                           timeout=timedelta(seconds=timeout_s(ctx)))


def timeout_s(ctx: common.Ctx) -> float:
    return float(ctx.scale.get("rank_timeout_s", RANK_TIMEOUT_S))


class _LocalStats:
    """``parallel/dist.py`` as ``models/layers.py`` sees it, its sum over
    ranks left out."""

    def __init__(self, pdist):
        self._pdist = pdist

    def __getattr__(self, name):
        return getattr(self._pdist, name)

    @staticmethod
    def all_reduce_sum(x):
        return x


@contextlib.contextmanager
def planted(fault: Optional[str]):
    """The program with ``fault`` (one of ``FAULTS``, or None) in it."""
    from video_similarity_search_tpu_torch.models import layers
    from video_similarity_search_tpu_torch.train import steps

    assert fault is None or fault in FAULTS, fault
    saved = steps.sum_gradients, layers.pdist
    if fault == "grad_sum_skipped":
        steps.sum_gradients = lambda params: None
    elif fault == "bn_local_stats":
        layers.pdist = _LocalStats(layers.pdist)
    try:
        yield
    finally:
        steps.sum_gradients, layers.pdist = saved


def rank_main(ctx: common.Ctx, rank: int, world: int, port: int,
              window: bool) -> Optional[dict]:
    """One rank from the rendezvous to the end of the window (``window``
    False: to the end of the checked step) -> on rank 0 its ``Rank``, the
    window's counts and times, whether every rank took as many steps, and
    the largest peak memory of the ranks."""
    from video_similarity_search_tpu_torch.parallel import destroy

    join_group(ctx, rank, world, port)
    try:
        with planted(ctx.scale.get("fault")):
            flags = Flags(timeout_s(ctx))
            r = Rank(ctx, rank, world, warm=window)
            w, steps = None, 0
            if window and rank == 0:
                w = window_rank0(r, flags)
                steps = w["steps"]
            elif window:
                fed = Following(r.source, flags)
                r._run_epoch(fed, r.step_fn, r.window_epoch)
                common.synchronize(r.dev)
                steps = fed.count
            peak = (torch.cuda.max_memory_allocated(r.dev)
                    if r.dev.type == "cuda" else 0)
            most, least, top = flags.largest([steps, -steps, float(peak)])
            if rank != 0:
                return None
            return {"rank": r, "window": w, "steps_agree": most == -least,
                    "peak": int(top)}
    finally:
        destroy()


def window_rank0(r: Rank, flags: Flags) -> dict:
    """Rank 0's measured window -> the run's counts and times."""
    ctx = r.ctx
    prof = common.make_profiler(r.dev) if ctx.trace else None
    win = common.Window(r.source, ctx.seconds, r.dev, "driver.step",
                        profiler=prof, limit=ctx.scale.get("window_steps"))
    setup_s = time.perf_counter() - ctx.t_start
    _, elapsed = common.run_window(
        win, lambda w: r._run_epoch(leading(w, flags), r.step_fn,
                                    r.window_epoch))
    clips = len(r.views) * r.b * r.world
    return {"setup_s": setup_s, "steps": win.count, "clips": clips,
            "elapsed_s": elapsed,
            "train_clips_per_s": win.count * clips / elapsed,
            "percentiles": common.step_percentiles(win.stamps,
                                                   win.t0 + elapsed),
            "win": win, "prof": prof}


class Ranks:
    """Ranks 1 .. W-1 as processes of this module, and a watch over them:
    on the card, a rank that fails ends this process at once (rank 0 may be
    waiting in a collective that would otherwise only time out)."""

    def __init__(self, ctx: common.Ctx, world: int, port: int,
                 window: bool):
        args = {"workload": ctx.workload, "config": ctx.config,
                "seed": ctx.seed, "seconds": ctx.seconds,
                "scale": ctx.scale, "world": world, "port": port,
                "window": window, "cuda": ctx.device.type == "cuda"}
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "port_bench.traffic.triplet_step_dp",
             json.dumps({**args, "rank": rank})],
            cwd=common.ROOT, stdout=subprocess.DEVNULL)
            for rank in range(1, world)]
        self.hard = ctx.device.type == "cuda"
        self.done = threading.Event()
        threading.Thread(target=self._watch, daemon=True).start()

    def failed(self) -> list:
        return [(i + 1, p.returncode) for i, p in enumerate(self.procs)
                if p.poll() not in (None, 0)]

    def _watch(self) -> None:
        while not self.done.wait(POLL_S):
            bad = self.failed()
            if bad and self.hard:
                print(f"rank(s) {bad} (rank, exit code) failed: no result",
                      file=sys.stderr, flush=True)
                os._exit(1)

    def join(self) -> None:
        """Wait for every rank to exit; raise unless each exited with 0."""
        self.done.set()
        for p in self.procs:
            try:
                p.wait(timeout=JOIN_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        codes = [p.returncode for p in self.procs]
        if any(codes):
            raise RuntimeError(f"ranks 1..{len(codes)} exited with {codes}")

    def kill(self) -> None:
        self.done.set()
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def drive(ctx: common.Ctx, window: bool) -> dict:
    """Every rank, this process rank 0 -> rank 0's results."""
    from video_similarity_search_tpu_torch.parallel import free_port

    world = int(ctx.param("ranks"))
    port = free_port()
    ranks = Ranks(ctx, world, port, window)
    try:
        out = rank_main(ctx, 0, world, port, window)
    except BaseException:
        ranks.kill()
        raise
    ranks.join()
    if not out["steps_agree"]:
        raise RuntimeError("the ranks took different numbers of steps")
    return out


# --------------------------------------------------------------------------
# the reference on the global batch

def forward_in_blocks(model: models.R3D18, x: torch.Tensor) -> torch.Tensor:
    """``R3D18.forward`` with each residual block recomputed in the backward
    pass, and what the stem and the first stage keep for it held in host
    memory: the float32 global batch then fits on one card."""
    from torch.utils.checkpoint import checkpoint

    with torch.autograd.graph.save_on_cpu(pin_memory=x.is_cuda):
        h = x.permute(0, 4, 1, 2, 3).contiguous()
        h = F.relu(model.bn1(model.conv1(h)))
        for block in model.layer1:
            h = checkpoint(block, h, use_reentrant=True)
    for s in (2, 3, 4):
        for block in getattr(model, f"layer{s}"):
            h = checkpoint(block, h, use_reentrant=False)
    feat = h.mean(dim=(2, 3, 4))
    return model.fc2(F.relu(model.bn_proj(model.fc1(feat))))


def reference_step(state, batch: dict, labels: torch.Tensor, seed: int,
                   spec_: dict, device: torch.device, quant=None,
                   picks=None) -> dict:
    """The reference's first step on the global batch (``batch``: uint8
    views on ``device``), its generator seeded from ``seed``: each view's
    augmentation draws, one train-mode forward over [anchors; positives;
    extras], the triplet loss (the judged run's ``picks`` taken) and the
    local-local term, backward. -> the loss, each parameter's gradient
    norm, the embeddings, the own picks and the judged picks' gap."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = models.build("r3d18").to(device)
    model.load_state_dict(state)
    model.train()
    model.set_quant(quant)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    views = []
    for v in spec_["views"]:
        x = batch[v]
        crop = tuple(x.shape[2:4]) if spec_["crop"] else None
        views.append(ref.augment(x, ref.draw_params(g, x.shape[0], crop),
                                 spec_["size"], spec_["dataset"]))
    clips = torch.cat(views)
    del views
    emb = forward_in_blocks(model, clips).float()
    del clips
    b = emb.shape[0] // len(spec_["views"])
    loss, own, gap = ref.triplet_loss(emb[:2 * b], labels, spec_["margin"],
                                      g, picks)
    if spec_["llc_margin"] is not None:
        loss = loss + spec_["llc_weight"] * ref.local_local(
            emb[:b], emb[b:2 * b], emb[2 * b:], spec_["llc_margin"])
    loss.backward()
    grad1 = {k: float(p.grad.norm()) for k, p in model.named_parameters()}
    return {"loss": float(loss.detach()), "grad1": grad1,
            "emb1": emb.detach().cpu(), "picks": own.cpu(),
            "pick_gap": float(gap.detach())}


def reference(r: Rank, quant=None, half: bool = False, picks=None) -> dict:
    """The reference's first step from rank 0's seeded weights on the
    first global batch of the pool; ``quant`` computes it in a lower
    precision (the control), ``half`` keeps the first half of every view
    (a fault), both read to set the limits."""
    ctx, dev = r.ctx, r.ctx.device
    v, bg = len(r.views), r.b * r.world
    clips = common.uint8_pool(r.shape, np.tile(r.labels[:1], v),
                              int(ctx.param("classes")), ctx.seed, dev,
                              pin=False)[0].to(dev)
    keep = bg // 2 if half else bg
    batch = {view: clips[k * bg:k * bg + keep]
             for k, view in enumerate(r.views)}
    labels = torch.as_tensor(np.concatenate([r.labels[0][:keep]] * 2),
                             device=dev)
    out = reference_step(r.init, batch, labels,
                         ref.step_seed(r.check_epoch, 0),
                         spec(r.cfg, r.views), dev, quant=quant, picks=picks)
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        torch.cuda.empty_cache()
    return out


def compare(prog: dict, reference_: dict) -> dict:
    """The numbers, as the one-card cell's (``triplet_step.compare``) for
    the first step: the worst row's relative gap of the global step-1
    embeddings, the reference's judgement of the judged run's negatives,
    the step's relative loss gap, and the worst and the median leaf's gap
    of the summed first gradient's norm (a leaf whose reference gradient
    is under a thousandth of the median leaf's is left out: its gradient
    is rounding alone)."""
    names = list(reference_["grad1"])
    med = float(np.median([reference_["grad1"][k] for k in names]))
    keep = [k for k in names if reference_["grad1"][k] >= 1e-3 * med]
    grads1 = common.leaf_gaps(prog["grad1"], reference_["grad1"], keep)
    if prog["emb1"].shape == reference_["emb1"].shape:
        rows = (torch.linalg.vector_norm(prog["emb1"] - reference_["emb1"],
                                         dim=1)
                / torch.linalg.vector_norm(reference_["emb1"], dim=1))
    else:
        rows = torch.tensor([float("inf")])
    worst = max(grads1, key=grads1.get)
    return {"emb1_gap": float(rows.max()),
            "pick_gap": reference_["pick_gap"],
            "loss_gap": abs(prog["loss"] - reference_["loss"])
            / max(abs(reference_["loss"]), 1e-6),
            "grad_gap": grads1[worst],
            "grad_med_gap": statistics.median(grads1.values()),
            "_leaves": {"grad": worst,
                        "losses": [prog["loss"], reference_["loss"]],
                        "left_out": sorted(set(names) - set(keep)),
                        "reference_peak_gib": reference_.get("peak_gib")}}


def run(ctx: common.Ctx) -> dict:
    out = drive(ctx, window=True)
    r, w = out["rank"], out["window"]
    r.release()
    numbers = compare(r.checked, reference(r, picks=r.checked["picks"]))
    extra: Optional[dict] = None
    if ctx.trace:
        # the model FLOPs of rank 0's own clips: the card's share of the
        # peak (every rank runs as many)
        extra = {"clips_per_step": len(r.views) * r.b,
                 "flops_per_clip": flops.clip_flops(ctx.config)["train"],
                 **common.outside(w["win"], w["elapsed_s"])}
    return {"attempted": w["steps"], "failed": 0, "peak": out["peak"],
            "e2e": {ctx.workload["rate_metric"]: w["train_clips_per_s"],
                    "setup_s": w["setup_s"]},
            "numbers": numbers, "window": w, "trace_extra": extra,
            "info": {"percentiles": w["percentiles"], "ranks": r.world,
                     "checked_losses": [r.checked["loss"]]}}


def calibrate(ctx: common.Ctx, control: bool) -> dict:
    """The readings that the limits are set from: the program's numbers
    against the reference on ``ctx.seed`` (the ranks take the checked step
    alone); with ``control`` also those of the reference computed in fp8,
    of the reference fed half of each view (a fault) and of the program
    with each of ``FAULTS`` planted, each against the float32 reference."""
    from ..reference.precision import fp8

    r = drive(ctx, window=False)["rank"]
    r.release()
    out = {"program": compare(r.checked,
                              reference(r, picks=r.checked["picks"]))}
    if control:
        for fault in FAULTS:
            bad = drive(replace(ctx, scale={**ctx.scale, "fault": fault}),
                        window=False)["rank"]
            bad.release()
            out[fault] = compare(bad.checked,
                                 reference(bad, picks=bad.checked["picks"]))
        low = reference(r, quant=fp8)
        out["control"] = compare(low, reference(r, picks=low["picks"]))
        full = reference(r)
        v, d = len(r.views), full["emb1"].shape[1]
        bg = r.b * r.world
        full["emb1"] = full["emb1"].view(v, bg, d)[:, :bg // 2].reshape(
            -1, d)  # the rows the half batch has
        out["half_batch"] = compare(reference(r, half=True), full)
    return out


def _orphaned(parent: int) -> None:
    """Leave when the process that started this rank is gone."""
    while True:
        time.sleep(POLL_S)
        if os.getppid() != parent:
            os._exit(1)


def main(argv=None) -> int:
    """A rank other than 0: ``python -m port_bench.traffic.triplet_step_dp
    '<JSON>'`` (written by ``Ranks``)."""
    a = json.loads((argv or sys.argv[1:])[0])
    threading.Thread(target=_orphaned, args=(os.getppid(),),
                     daemon=True).start()
    if a["scale"].get("threads"):
        torch.set_num_threads(int(a["scale"]["threads"]))
    device = torch.device("cuda" if a["cuda"] else "cpu")
    ctx = common.Ctx(workload=a["workload"], config=a["config"],
                     seed=a["seed"], seconds=a["seconds"], trace=False,
                     device=device, scale=a["scale"])
    rank_main(ctx, a["rank"], a["world"], a["port"], a["window"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
