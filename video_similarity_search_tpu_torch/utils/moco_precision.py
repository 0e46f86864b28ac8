"""How far one fp32 MoCo (UberNCE) step of S3D sits from fp64, on the CPU
and on the card, clip size by clip size.

    python3 -m video_similarity_search_tpu_torch.utils.moco_precision \\
        [--sizes 8x32 16x32 8x64 16x64 32x64 32x128] [--anchors 4]

For each T x S clip size: one step from the same seeded weights, queue
(``LOSS.K`` 8) and batch (``anchors`` rows of normal noise, labels 0, 1,
0, 2, ...) in fp32 and fp64 on the CPU and on the card (TF32 off), and
prints one JSON line: the fewest values any BatchNorm channel normalizes
over, each run's loss, the update's relative distance of each fp32 run
from each fp64 run, and the card against the CPU. In train mode a
BatchNorm over a handful of values a channel (S3D's Mixed_5 blocks at
8x32x32 see batch x 1 x 1 x 1) amplifies the summation order of the
convolutions it follows, so the two devices' fp32 updates can differ by
far more than either device's rounding elsewhere; this sweep shows where
that stops. ``tests/test_torch_port_hygiene.py`` holds the card at a size
it picks from here.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

RUNS = (("cpu", "cpu", torch.float32), ("cpu64", "cpu", torch.float64),
        ("cuda", "cuda", torch.float32), ("cuda64", "cuda", torch.float64))


def moco_cfg():
    from ..config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.ARCH", "uber_nce", "LOSS.TYPE", "UberNCE",
                         "LOSS.K", 8, "TPU.COMPUTE_DTYPE", "float32",
                         "OPTIM.LR", 0.01])
    return cfg


def bn_values_per_channel(model: torch.nn.Module, t: int, s: int,
                          b: int) -> int:
    """The fewest values any BatchNorm of ``model`` normalizes a channel
    over, for a batch of ``b`` clips of t x s x s (an eval forward on the
    CPU; train mode normalizes over the same values)."""
    counts = []

    def hook(mod, inp, out):
        counts.append(out.numel() // out.shape[1])

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    training = model.training
    model.eval()
    try:
        with torch.no_grad():
            model(torch.zeros(b, t, s, s, 3))
    finally:
        for h in hooks:
            h.remove()
        model.train(training)
    return min(counts)


def moco_step_runs(t: int, s: int, b: int = 4, runs=RUNS
                   ) -> Tuple[dict, Dict[str, tuple]]:
    """One UberNCE step of S3D for each (name, device, dtype) of ``runs``
    from the same weights, queue and batch. -> (the initial state_dict,
    {name: (loss, state as fp64 CPU tensors incl. ``bank.*``, seconds)})."""
    from ..models import model_selector
    from ..train import make_banks, make_moco_train_step, make_optimizer

    cfg = moco_cfg()
    torch.manual_seed(0)
    init = model_selector(cfg).state_dict()
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(0.5 * rng.normal(size=(b, t, s, s, 3))
                                 .astype(np.float32)) for k in ("x1", "x2")}
    batch["label"] = torch.tensor([0, 1, 0, 2] * (b // 4) + [0] * (b % 4))
    out = {}
    for name, dev, dtype in runs:
        t0 = time.perf_counter()
        model = model_selector(cfg)
        model.load_state_dict(init)
        bank = make_banks(cfg, 0, model)["moco"]
        model.to(dtype)
        bank.encoder_k.to(dtype)
        step = make_moco_train_step(cfg, model,
                                    *make_optimizer(cfg, model.parameters()),
                                    bank, uber=True, device=dev)
        loss = float(step({k: v.to(dev, dtype) if v.is_floating_point()
                           else v.to(dev) for k, v in batch.items()})["loss"])
        sd = {k: v.detach().cpu().double()
              for k, v in model.state_dict().items()}
        sd.update({"bank." + k: v.detach().cpu().double()
                   for k, v in bank.state_dict().items()})
        out[name] = (loss, sd, time.perf_counter() - t0)
    return init, out


def update_distance(init: dict, out: dict, name: str, ref: str) -> float:
    """The relative L2 distance of run ``name``'s update of the query and
    key parameters from run ``ref``'s (BatchNorm statistics, counters
    and the queue left out)."""
    num = den = 0.0
    for k, r in out[ref][1].items():
        if k.startswith("bank.queue") or k.endswith((
                "running_mean", "running_var", "num_batches_tracked")):
            continue
        p0 = init[k] if k in init else init[k.replace("bank.encoder_k.",
                                                      "encoder_q.")]
        u, rr = out[name][1][k] - p0.double(), r - p0.double()
        num += float(((u - rr) ** 2).sum())
        den += float((rr ** 2).sum())
    return (num / den) ** 0.5


def report(t: int, s: int, b: int = 4) -> dict:
    from ..models import model_selector

    init, out = moco_step_runs(t, s, b)
    loss = {k: v[0] for k, v in out.items()}
    pairs = (("cpu", "cpu64"), ("cuda", "cuda64"), ("cuda", "cpu64"),
             ("cpu", "cuda64"), ("cuda64", "cpu64"))
    return {
        "clip": [t, s, s], "anchors": b,
        "bn_values_per_channel_min": bn_values_per_channel(
            model_selector(moco_cfg()), t, s, b),
        "loss": loss,
        "loss_rel": {f"{a}_vs_{r}": abs(loss[a] - loss[r]) / abs(loss[r])
                     for a, r in (("cuda", "cuda64"), ("cpu", "cpu64"),
                                  ("cuda", "cpu"))},
        "update_rel": {f"{a}_vs_{r}": update_distance(init, out, a, r)
                       for a, r in pairs},
        "queue_max_abs_diff_cuda_vs_cuda64": float(
            (out["cuda"][1]["bank.queue"]
             - out["cuda64"][1]["bank.queue"]).abs().max()),
        "seconds": {k: v[2] for k, v in out.items()}}


def main(argv: Sequence[str] = None) -> None:
    parser = argparse.ArgumentParser("moco_precision")
    parser.add_argument("--sizes", nargs="*",
                        default=["8x32", "16x32", "8x64", "16x64", "32x64",
                                 "32x128"])
    parser.add_argument("--anchors", type=int, default=4)
    args = parser.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for size in args.sizes:
        t, s = (int(v) for v in size.split("x"))
        print(json.dumps(report(t, s, args.anchors)), flush=True)


if __name__ == "__main__":
    main()
