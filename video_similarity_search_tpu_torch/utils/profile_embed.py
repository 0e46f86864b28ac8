"""Where the port's embed pass spends its time on one NVIDIA GPU.

R3D-18 at the Kinetics config (16x128x128 clips, bf16 autocast, random
seeded weights, batches of 256 uint8 clips), the same setup as
``chip_smoke.py``'s embed phase. Prints one JSON line per measurement:

  stage_ms     per batch: host->device copy of the uint8 clips (pageable
               and pinned), normalize, the bf16 forward, and one whole
               ``get_embeddings_and_labels`` batch (CUDA events / host
               clock after a synchronize; median of 5 after warm-up)
  forward_sweep  forward-only clips/s at batch 64/128/256, with the
               weights in channels_last_3d (what the port uses) and in
               the default contiguous layout
  profile      torch.profiler over 2 forward batches: device time by
               kernel (top 15), and the kernels' summed time over the
               window's host time (the busy share); the full table goes to
               runs/port_embed_profile.txt (git-ignored)

Usage, from the root of a checkout (one CUDA card, pyyaml):
    python3 -m video_similarity_search_tpu_torch.utils.profile_embed
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIG = os.path.join(ROOT, "configs", "resnet_kin_itercluster_flow.yaml")


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


def main():
    import torch

    from video_similarity_search_tpu_torch.config import get_cfg
    from video_similarity_search_tpu_torch.data.augment import normalize_only
    from video_similarity_search_tpu_torch.evaluation.embed import \
        get_embeddings_and_labels
    from video_similarity_search_tpu_torch.models import model_selector
    from video_similarity_search_tpu_torch.train.steps import make_embed_step

    if not torch.cuda.is_available():
        print("needs one CUDA card", file=sys.stderr)
        return 2
    smi = nvidia_smi()
    cfg = get_cfg()
    cfg.merge_from_file(CONFIG)
    t, s = cfg.DATA.SAMPLE_DURATION, cfg.DATA.SAMPLE_SIZE
    torch.manual_seed(0)
    model = model_selector(cfg)
    step = make_embed_step(cfg, model, device="cuda")
    rng = np.random.default_rng(0)
    clips = rng.integers(0, 256, (256, t, s, s, 3), np.uint8)
    pinned = torch.from_numpy(clips).pin_memory()
    on_dev = pinned.cuda()
    x = normalize_only(on_dev, "kinetics")

    def whole_batch():
        batch = {"clip": clips, "target": np.zeros(256, np.int32),
                 "index": np.arange(256, dtype=np.int32),
                 "window_counts": np.ones(256, np.int32)}
        get_embeddings_and_labels(model, cfg, [batch], verbose=False,
                                  device="cuda")

    emit("stage_ms", device=smi, batch=256, clip=[t, s, s, 3],
         h2d_pageable=median_ms(lambda: torch.from_numpy(clips).cuda()),
         h2d_pinned=median_ms(lambda: pinned.cuda(non_blocking=True)),
         normalize=median_ms(lambda: normalize_only(on_dev, "kinetics")),
         forward_bf16=median_ms(lambda: step(x)),
         whole_batch=median_ms(whole_batch))

    sweep = {}
    for layout in ("channels_last_3d", "contiguous"):
        fmt = (torch.channels_last_3d if layout == "channels_last_3d"
               else torch.contiguous_format)
        model.to(memory_format=fmt)
        for b in (64, 128, 256):
            ms = median_ms(lambda: step(x[:b]))
            sweep[f"{layout}_b{b}_clips_per_s"] = b / ms * 1e3
    model.to(memory_format=torch.channels_last_3d)
    emit("forward_sweep", device=smi, **sweep)

    from torch.profiler import ProfilerActivity, profile

    step(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step(x)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: an aten op's row repeats the device time of its kernels
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total_us = sum(e.self_device_time_total for e in events)
    top = [{"name": e.key[:90], "device_ms": e.self_device_time_total / 1e3,
            "calls": e.count} for e in events[:15]]
    out_dir = os.path.join(ROOT, "runs")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "port_embed_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=60))
    emit("profile", device=smi, batches=2, window_ms=window_ms,
         device_ms=total_us / 1e3,
         busy_share=(total_us / 1e3) / window_ms if window_ms else None,
         top=top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
