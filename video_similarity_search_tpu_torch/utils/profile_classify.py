"""Where the port's classifier step spends its time on one NVIDIA GPU.

The S3D ``LinearClassifier`` at ``cli/coclr_classify.py``'s defaults (32
clips of 32x128x128, 101 classes, dropout 0.9, ``--train_what all``,
float32 as the CLI runs it, random seeded weights and uint8 clips), the
same setup as ``chip_smoke.py``'s classify_step phase. Prints one JSON
line per measurement:

  stem_ms   the stem ``Conv_1a.conv1`` (3 -> 64 channels, 1x7x7, stride
            (1, 2, 2)) on the step's normalized clips in float32: forward
            and weight gradient; CUDA events, median of 5
  max_pool  every max-pool of one forward (the four between the blocks
            and each Inception block's 3x3x3 branch pool) on the inputs it
            gets in the step, in channels_last_3d as the step runs them and
            in the contiguous layout: forward ms summed over the calls
  profile   torch.profiler over 3 steps: device time by kernel (top 20),
            and the kernels' summed time over the window's host time (the
            busy share); the full table goes to runs/port_classify_profile.txt
            (git-ignored)

Usage, from the root of a checkout (one CUDA card):
    python3 -m video_similarity_search_tpu_torch.utils.profile_classify
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BATCH, T, S, CLASSES = 32, 32, 128, 101


def emit(name, **fields):
    print(json.dumps({"exp": name, **fields}), flush=True)


def median_ms(fn, reps=5):
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return float(np.median(out))


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def stem_ms(conv, x) -> dict:
    """Forward and weight-gradient ms of the stem convolution ``conv`` in
    float32 on the normalized clips ``x`` (B, T, H, W, 3)."""
    import torch
    import torch.nn.functional as F

    inp = x.permute(0, 4, 1, 2, 3)
    weight = conv.weight.detach().contiguous(
        memory_format=torch.channels_last_3d).requires_grad_(True)

    def fwd():
        return F.conv3d(inp, weight, None, conv.stride, conv.padding)

    g = torch.randn_like(fwd())

    def wgrad():
        return torch.autograd.grad(fwd(), weight, g)[0]

    return {"forward": median_ms(fwd), "forward_plus_wgrad": median_ms(wgrad)}


def kernel_profile(one_step, table_name: str, steps: int = 3) -> dict:
    """torch.profiler over ``steps`` calls of ``one_step``: device ms a
    step by kernel (top 20) and the kernels' summed time over the window's
    host time (the busy share); the full table goes to runs/<table_name>
    (git-ignored)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        one_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            one_step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: an aten op's row repeats the device time of its kernels,
    # and a record_function range's device-side span that of the kernels in
    # it
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0
              and not e.is_user_annotation]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total_us = sum(e.self_device_time_total for e in events)
    top = [{"name": e.key[:90], "device_ms_per_step":
            e.self_device_time_total / (steps * 1e3), "calls": e.count}
           for e in events[:20]]
    out_dir = os.path.join(ROOT, "runs")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, table_name), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=80))
    return {"steps": steps, "window_ms": window_ms,
            "device_ms_per_step": total_us / (steps * 1e3),
            "busy_share": (total_us / 1e3) / window_ms if window_ms else None,
            "top": top}


def pool_inputs(model, x):
    """The (input, args) of every ``F.max_pool3d`` call of one eval-mode
    forward of ``model`` on ``x``."""
    import torch
    import torch.nn.functional as F

    calls, pool = [], F.max_pool3d

    def record(inp, *args, **kw):
        calls.append((inp.detach(), args, kw))
        return pool(inp, *args, **kw)

    F.max_pool3d = record
    try:
        with torch.no_grad():
            model(x)
    finally:
        F.max_pool3d = pool
    return calls


def max_pool_ms(calls) -> dict:
    import torch
    import torch.nn.functional as F

    out = {"calls": len(calls),
           "shapes": [list(c[0].shape) for c in calls],
           "dtype": str(calls[0][0].dtype)}
    for layout in ("channels_last_3d", "contiguous"):
        fmt = getattr(torch, layout if layout != "contiguous"
                      else "contiguous_format")
        inputs = [(c[0].contiguous(memory_format=fmt), c[1], c[2])
                  for c in calls]
        out[f"{layout}_ms"] = float(sum(
            median_ms(lambda i=i, a=a, k=k: F.max_pool3d(i, *a, **k))
            for i, a, k in inputs))
    return out


def main():
    import torch

    from video_similarity_search_tpu_torch.config import get_cfg
    from video_similarity_search_tpu_torch.data.augment import normalize_only
    from video_similarity_search_tpu_torch.models.heads import LinearClassifier
    from video_similarity_search_tpu_torch.train import (
        make_classify_optimizer, make_classify_train_step, make_lr_schedule)

    if not torch.cuda.is_available():
        print("needs one CUDA card", file=sys.stderr)
        return 2
    smi = nvidia_smi()
    cfg = get_cfg()
    cfg.MODEL.ARCH = "s3d"
    cfg.TPU.COMPUTE_DTYPE = "float32"  # as cli/coclr_classify.py sets it
    torch.manual_seed(0)
    model = LinearClassifier(num_class=CLASSES, dropout=0.9)
    optimizer, schedule = make_classify_optimizer(
        model, "all", make_lr_schedule(1e-3, 150, [60, 100], False, 100), 1e-3)
    step = make_classify_train_step(cfg, model, optimizer, schedule,
                                    device="cuda")
    rng = np.random.default_rng(0)
    clips = torch.from_numpy(rng.integers(0, 256, (BATCH, T, S, S, 3),
                                          np.uint8)).cuda()
    labels = torch.from_numpy(rng.integers(0, CLASSES, BATCH)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def one_step():
        step({"clips": normalize_only(clips), "label": labels}, generator=gen)

    x = normalize_only(clips)
    stem = model.backbone.Conv_1a.conv1
    flop = 2 * BATCH * 64 * (T * S * S // 4) * 3 * 7 * 7
    emit("stem_ms", device=smi, clips=BATCH, clip=[T, S, S, 3],
         forward_gflop=flop / 1e9,
         **stem_ms(stem, x))
    model.eval()
    emit("max_pool", device=smi, **max_pool_ms(pool_inputs(model, x)))
    del x
    emit("profile", device=smi,
         **kernel_profile(one_step, "port_classify_profile.txt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
