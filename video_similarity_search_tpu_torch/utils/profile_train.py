"""Where the port's triplet train step spends its time on one NVIDIA GPU.

R3D-18 at the UCF config (configs/resnet_ucf_itercluster_flow.yaml: 32
anchors + 32 positives + 32 anchor2 = 96 pre-cropped clips of 16x128x128,
bf16 autocast, random seeded weights and uint8 clips), the same setup as
``chip_smoke.py``'s train_step phase. Prints one JSON line per
measurement:

  stem_ms   the stem conv (3 -> 64 channels, 7x7x7, stride (1, 2, 2)) on
            the step's 96 normalized clips under bf16 autocast: forward and
            weight gradient (the step needs no input gradient there), at 3
            input channels and with input and weight zero-padded to 8
            (the same numbers); CUDA events, median of 5 after warm-up
  profile   torch.profiler over 3 steps (augmentation included): device
            time by kernel (top 20), and the kernels' summed time over the
            window's host time (the busy share); the full table goes to
            runs/port_train_profile.txt (git-ignored)

Usage, from the root of a checkout (one CUDA card, pyyaml):
    python3 -m video_similarity_search_tpu_torch.utils.profile_train
"""

import json
import os
import sys
import time

import numpy as np

from .profile_embed import median_ms, nvidia_smi

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIG = os.path.join(ROOT, "configs", "resnet_ucf_itercluster_flow.yaml")
VIEWS = ("anchor", "positive", "extra")


def emit(name, **fields):
    print(json.dumps({"exp": name, **fields}), flush=True)


def stem_ms(model, x) -> dict:
    """Forward and weight-gradient ms of ``model.conv1`` on the normalized
    clips ``x`` (B, T, H, W, 3), at 3 channels and zero-padded to 8."""
    import torch
    import torch.nn.functional as F

    conv = model.conv1
    out = {}
    for cin in (3, 8):
        inp = F.pad(x, (0, cin - 3)).permute(0, 4, 1, 2, 3)
        weight = F.pad(conv.weight.detach(), (0, 0, 0, 0, 0, 0, 0, cin - 3))
        weight = weight.contiguous(memory_format=torch.channels_last_3d)
        weight.requires_grad_(True)

        def fwd():
            with torch.autocast("cuda", dtype=torch.bfloat16):
                return F.conv3d(inp, weight, None, conv.stride, conv.padding)

        y = fwd()
        g = torch.randn_like(y)

        def wgrad():
            return torch.autograd.grad(fwd(), weight, g)[0]

        out[f"cin{cin}"] = {"forward": median_ms(fwd),
                            "forward_plus_wgrad": median_ms(wgrad),
                            "output": y.detach().float()}
    diff = float((out["cin3"].pop("output")
                  - out["cin8"].pop("output")).abs().max())
    out["cin3_vs_cin8_max_abs_diff"] = diff
    return out


def main():
    import torch

    from video_similarity_search_tpu_torch.config import get_cfg
    from video_similarity_search_tpu_torch.data.augment import train_augment
    from video_similarity_search_tpu_torch.models import model_selector
    from video_similarity_search_tpu_torch.train import (
        make_optimizer, make_triplet_train_step)

    if not torch.cuda.is_available():
        print("needs one CUDA card", file=sys.stderr)
        return 2
    smi = nvidia_smi()
    cfg = get_cfg()
    cfg.merge_from_file(CONFIG)
    b, t, s = cfg.TRAIN.BATCH_SIZE, cfg.DATA.SAMPLE_DURATION, cfg.DATA.SAMPLE_SIZE
    torch.manual_seed(0)
    model = model_selector(cfg)
    optimizer, schedule = make_optimizer(cfg, model.parameters())
    step = make_triplet_train_step(cfg, model, optimizer, schedule,
                                   device="cuda")
    rng = np.random.default_rng(0)
    clips = {k: torch.from_numpy(rng.integers(0, 256, (b, t, s, s, 3),
                                              np.uint8)).cuda()
             for k in VIEWS}
    labels = torch.from_numpy(rng.integers(0, 16, b)).cuda()
    targets = torch.cat([labels, labels])
    gen = torch.Generator(device="cuda").manual_seed(0)

    def augment():
        out = {k: train_augment(v, gen, s, dataset=cfg.TRAIN.DATASET,
                                pre_cropped=True) for k, v in clips.items()}
        out["targets"] = targets
        return out

    def one_step():
        step(augment(), gen)

    x = torch.cat([v for k, v in augment().items() if k in VIEWS])
    emit("stem_ms", device=smi, clips=int(x.shape[0]), clip=[t, s, s, 3],
         **stem_ms(model, x))
    del x

    for _ in range(2):
        one_step()
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            one_step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: an aten op's row repeats the device time of its kernels
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    total_us = sum(e.self_device_time_total for e in events)
    top = [{"name": e.key[:90], "device_ms_per_step":
            e.self_device_time_total / 3e3, "calls": e.count}
           for e in events[:20]]
    out_dir = os.path.join(ROOT, "runs")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "port_train_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=80))
    emit("profile", device=smi, steps=3, window_ms=window_ms,
         device_ms_per_step=total_us / 3e3,
         busy_share=(total_us / 1e3) / window_ms if window_ms else None,
         top=top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
