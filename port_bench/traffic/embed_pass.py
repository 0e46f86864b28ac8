"""The embedding pass before each clustering, fed from host memory.

Set-up draws a pool of uint8 batches of clips from the seed and keeps it
in pinned host memory, and loads the seeded weights into the program's
encoder. The window runs the program's pass
(``evaluation/embed.py::get_embeddings_and_labels``, through
``make_embed_step``) over passes of ``clips_per_pass`` clips in batches of
``batch`` (the last one ragged, as UCF-101 split 1's train set ends),
each batch a pool batch, cycled, which the pass uploads and normalises
itself. One pass warms up every shape first: the full batch and the
ragged one.

After the window, the plain reference (``reference/models.py``, eval
mode, float32) embeds a sample of the window's batches, drawn from the
seed, and the program's embeddings of them are held to it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import common, flops
from ..reference import models
from ..reference.triplet import MEAN_STD

SAMPLED_BATCHES = 2


class Setup:
    def __init__(self, ctx: common.Ctx):
        from video_similarity_search_tpu_torch.models import model_selector

        dev = ctx.device
        self.ctx = ctx
        self.cfg = cfg = common.port_cfg(ctx)
        self.bsz = int(ctx.param("batch"))
        self.n_pass = int(ctx.param("clips_per_pass"))
        t, s = int(cfg.DATA.SAMPLE_DURATION), int(cfg.DATA.SAMPLE_SIZE)
        n_pool = int(ctx.param("pool_batches"))
        self.model = model_selector(cfg)
        state = common.seeded_state(self.model.state_dict(), ctx.seed, dev)
        self.model.load_state_dict(state)
        self.init = {k: v.cpu() for k, v in state.items()}
        del state
        self.model.to(dev)
        rng = np.random.default_rng(ctx.seed)
        classes = int(ctx.param("classes"))
        self.pool = common.uint8_pool(
            (self.bsz, t, s, s, 3), rng.integers(0, classes, (n_pool,
                                                              self.bsz)),
            classes, ctx.seed, dev, pin=dev.type == "cuda")
        self.fed = []  # (pool batch, clips) of each batch the window fed
        full, last = divmod(self.n_pass, self.bsz)
        self.sizes = [self.bsz] * full + ([last] if last else [])
        self.run_passes(common.Window(self.batch, float("inf"), dev,
                                      "embed.batch",
                                      limit=len(self.sizes)))
        self.fed.clear()
        common.synchronize(dev)

    def batch(self, i: int) -> dict:
        j = i % len(self.pool)
        n = self.sizes[i % len(self.sizes)]
        self.fed.append((j, n))
        idx = np.arange(n, dtype=np.int32)
        return {"clip": self.pool[j][:n], "target": np.zeros(n, np.int32),
                "index": idx, "window_counts": np.ones(n, np.int32),
                "__size__": n}

    def run_passes(self, win: common.Window) -> list:
        """Passes of the program's embedding over ``win``'s batches until
        it stops -> each pass's embeddings."""
        from video_similarity_search_tpu_torch.evaluation import \
            get_embeddings_and_labels

        it = iter(win)
        out, done = [], False

        def one_pass():
            nonlocal done
            for _ in self.sizes:
                try:
                    yield next(it)
                except StopIteration:
                    done = True
                    return

        while not done:
            emb, _, _ = get_embeddings_and_labels(
                self.model, self.cfg, one_pass(), split="train",
                batch_pad=self.bsz, verbose=False, device=self.ctx.device)
            if len(emb):
                out.append(emb)
        return out

    def window(self) -> dict:
        ctx = self.ctx
        prof = common.make_profiler(ctx.device) if ctx.trace else None
        win = common.Window(lambda i: self.batch(i), ctx.seconds, ctx.device,
                            "embed.batch", profiler=prof,
                            limit=ctx.scale.get("window_steps"))
        setup_s = time.perf_counter() - ctx.t_start
        passes, elapsed = common.run_window(win, self.run_passes)
        clips = sum(n for _, n in self.fed)
        return {"setup_s": setup_s, "batches": win.count, "clips": clips,
                "elapsed_s": elapsed, "embed_clips_per_s": clips / elapsed,
                "percentiles": common.step_percentiles(
                    win.stamps, win.t0 + elapsed),
                "win": win, "prof": prof,
                "emb": np.concatenate(passes) if passes else np.zeros(0)}

    def release(self) -> None:
        del self.model
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, rows: list, quant=None) -> np.ndarray:
        """float32 reference embeddings of the fed batches ``rows``."""
        dev = self.ctx.device
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        model = models.build(self.ctx.config["reference"]).to(dev)
        model.load_state_dict({k: v.to(dev) for k, v in self.init.items()})
        model.eval()
        model.set_quant(quant)
        ds = str(self.cfg.TRAIN.DATASET)
        mean, std = MEAN_STD["kinetics" if ds == "kinetics" else "imagenet"]
        mean, std = torch.tensor(mean, device=dev), torch.tensor(std,
                                                                 device=dev)
        out = []
        with torch.no_grad():
            for r in rows:
                j, n = self.fed[r]
                x = (self.pool[j][:n].to(dev).float() / 255.0 - mean) / std
                out.append(model(x).float().cpu().numpy())
        return np.concatenate(out)


def sample(ctx: common.Ctx, n_fed: int) -> list:
    """The fed batches that are checked, drawn from the seed."""
    rng = np.random.default_rng(ctx.seed + 7)
    return sorted(rng.choice(n_fed, min(SAMPLED_BATCHES, n_fed),
                             replace=False).tolist())


def program_rows(s: Setup, emb: np.ndarray, rows: list) -> np.ndarray:
    starts = np.cumsum([0] + [n for _, n in s.fed])
    return np.concatenate([emb[starts[r]:starts[r + 1]] for r in rows])


def compare(prog: np.ndarray, ref: np.ndarray) -> dict:
    """The worst row's |program - reference| / |reference|."""
    err = np.linalg.norm(prog - ref, axis=1) / np.linalg.norm(ref, axis=1)
    return {"emb_gap": float(err.max()),
            "_leaves": {"median_row_gap": float(np.median(err))}}


def run(ctx: common.Ctx) -> dict:
    s = Setup(ctx)
    w = s.window()
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    s.release()
    rows = sample(ctx, len(s.fed))
    numbers = compare(program_rows(s, w["emb"], rows), s.reference(rows))
    extra = None
    if ctx.trace:
        out = common.outside(w["win"], w["elapsed_s"])
        lo = common.TRACE_AT
        hi = lo + w["win"].n_profiled
        extra = {**out, "clips_per_step": 1,
                 "flops_per_clip": flops.clip_flops(ctx.config)["forward"],
                 "outside_steps": sum(n for _, n in s.fed[:lo] + s.fed[hi:])}
    return {"attempted": w["batches"], "failed": 0, "peak": peak,
            "e2e": {"embed_clips_per_s": w["embed_clips_per_s"],
                    "setup_s": w["setup_s"]},
            "numbers": numbers, "window": w, "trace_extra": extra,
            "info": {"percentiles": w["percentiles"], "clips": w["clips"],
                     "sampled_batches": rows}}


def calibrate(ctx: common.Ctx, control: bool) -> dict:
    """The program's embeddings of the first pass (every batch size)
    against the reference, and with ``control`` the fp8 reference's."""
    from ..reference.precision import fp8

    s = Setup(ctx)
    win = common.Window(s.batch, float("inf"), ctx.device, "embed.batch",
                        limit=len(s.sizes))
    emb = np.concatenate(s.run_passes(win))
    s.release()
    rows = sorted(set(sample(ctx, len(s.fed))) | {len(s.fed) - 1})
    ref = s.reference(rows)
    out = {"program": compare(program_rows(s, emb, rows), ref)}
    if control:
        out["control"] = compare(s.reference(rows, quant=fp8), ref)
    return out
