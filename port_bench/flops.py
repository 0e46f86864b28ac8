"""Frozen FLOP counts and the H100's peak table.

Copied from ``video_similarity_search_tpu_torch/utils/flops.py`` at commit
f61503500a14f114e7bf022962bdb138585f8add (``resnet3d_flops_per_clip``,
``model_flops_per_clip`` and ``H100_PEAKS`` / ``peaks_for``), so that a
later change to the program cannot move the yardstick. The hook count runs
over the benchmark's own reference models (``reference/models.py``), never
over the program's modules: a kernel that later replaces a ``Conv3d`` in the
program leaves the count as it is.

FLOPs are 2 x multiply-adds of every convolution and dense layer;
BatchNorm, pooling and elementwise work are left out (under 1%).
"""

from __future__ import annotations

from typing import Sequence, Tuple

_DEPTH_TO_SPEC = {
    10: ("basic", (1, 1, 1, 1)),
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
}


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def resnet3d_flops_per_clip(depth: int = 18, t: int = 16, size: int = 128,
                            in_channels: int = 3, conv1_t_size: int = 7,
                            conv1_t_stride: int = 1, no_max_pool: bool = True,
                            widen_factor: float = 1.0,
                            projection_head: bool = True,
                            hidden_layer: int = 2048,
                            out_dim: int = 128) -> dict:
    """FLOPs of one clip through the 3-D ResNet forward -> {"forward",
    "first"}: the whole forward and the stem's share (the stem's input
    needs no gradient, so a training step skips that product)."""
    block, layers = _DEPTH_TO_SPEC[depth]
    expansion = 1 if block == "basic" else 4
    planes = [int(p * widen_factor) for p in (64, 128, 256, 512)]

    def conv(out_thw: Tuple[int, int, int], k: Sequence[int], cin: int,
             cout: int) -> int:
        ot, oh, ow = out_thw
        return 2 * ot * oh * ow * cout * k[0] * k[1] * k[2] * cin

    T, H, W = _ceil_div(t, conv1_t_stride), size // 2, size // 2
    stem = conv((T, H, W), (conv1_t_size, 7, 7), in_channels, planes[0])
    flops = stem
    ch = planes[0]
    if not no_max_pool:
        T, H, W = _ceil_div(T, 2), _ceil_div(H, 2), _ceil_div(W, 2)
    for stage, (p, n_blocks) in enumerate(zip(planes, layers)):
        stage_stride = 1 if stage == 0 else 2
        out_ch = p * expansion
        for b in range(n_blocks):
            s = stage_stride if b == 0 else 1
            oT, oH, oW = _ceil_div(T, s), _ceil_div(H, s), _ceil_div(W, s)
            if block == "basic":
                flops += conv((oT, oH, oW), (3, 3, 3), ch, p)
                flops += conv((oT, oH, oW), (3, 3, 3), p, p)
            else:
                flops += conv((T, H, W), (1, 1, 1), ch, p)
                flops += conv((oT, oH, oW), (3, 3, 3), p, p)
                flops += conv((oT, oH, oW), (1, 1, 1), p, out_ch)
            if s != 1 or ch != out_ch:  # shortcut-B downsample conv
                flops += conv((oT, oH, oW), (1, 1, 1), ch, out_ch)
            T, H, W, ch = oT, oH, oW, out_ch
    if projection_head:
        flops += 2 * ch * hidden_layer + 2 * hidden_layer * out_dim
    return {"forward": flops, "first": stem}


def model_flops_per_clip(model, example_input, firsts=()) -> dict:
    """FLOPs a clip of ``model``'s forward on ``example_input`` (a batched
    clip, or a [slow, fast] list), by forward hooks: a ``Conv3d`` gives 2 x
    its output elements x the weights of one output channel, a ``Linear``
    2 x its output elements x ``in_features``. -> {"forward", "first"}:
    the whole forward and that of the ``firsts`` layers (stems). The input
    may lie on the ``meta`` device: only shapes are read."""
    import torch

    count = {"forward": 0, "first": 0}

    def hook(mod, inp, out):
        per_out = (mod.weight[0].numel() if isinstance(mod, torch.nn.Conv3d)
                   else mod.in_features)
        flops = 2 * out.numel() * per_out
        count["forward"] += flops
        if any(mod is f for f in firsts):
            count["first"] += flops

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (torch.nn.Conv3d, torch.nn.Linear))]
    try:
        with torch.no_grad():
            model(example_input)
    finally:
        for h in hooks:
            h.remove()
    x = example_input[0] if isinstance(example_input, (list, tuple)) \
        else example_input
    return {k: v // x.shape[0] for k, v in count.items()}


def train_flops_per_clip(counts: dict) -> int:
    """A training step's model FLOPs a clip: the forward, and twice it for
    the backward (input and weight gradients), less the stems' input
    gradient, which is not computed."""
    return 3 * counts["forward"] - counts["first"]


# the H100's dense peaks by form factor, from NVIDIA's data sheet (the
# tensor-core figures are half the sparse ones): (fp32 on the CUDA cores,
# tf32, memory bytes/s, bf16). The SXM card's name carries no form factor
# ("NVIDIA H100 80GB HBM3"), so an H100 name without "PCIe" or "NVL" is SXM.
H100_PEAKS = {"PCIe": (51e12, 378e12, 2.0e12, 756e12),
              "NVL": (60e12, 417.5e12, 3.9e12, 835.5e12),
              "SXM": (67e12, 495e12, 3.35e12, 989e12)}


def peaks_for(name: str):
    """The H100 named ``name`` -> (form factor, (fp32, tf32, bytes/s, bf16)
    peaks). Raises on any other device: there is no peak for it here."""
    if "H100" not in name:
        raise ValueError(f"no peak rates for {name!r}: the table holds the "
                         "H100's form factors only")
    for key, val in H100_PEAKS.items():
        if key in name:
            return key, val
    return "SXM", H100_PEAKS["SXM"]


def bf16_peak(name: str) -> float:
    """Dense bf16 FLOP/s of the H100 named ``name``."""
    return peaks_for(name)[1][3]


def clip_flops(config: dict) -> dict:
    """A configuration's FLOPs a clip -> {"forward", "first", "train"}:
    the frozen formula for a 3-D ResNet, else forward hooks over the
    reference model on the ``meta`` device (shapes only, no arithmetic)."""
    import torch

    spec = config["flops"]
    if spec["count"] == "resnet3d":
        counts = resnet3d_flops_per_clip(
            depth=spec["depth"], t=spec["frames"], size=spec["size"])
    else:
        from .reference import models

        with torch.device("meta"):
            model = models.build(config["reference"]).eval()
            clip = torch.empty((1, spec["frames"], spec["size"],
                                spec["size"], 3))
        x = (models.slow_fast_input(clip, spec["alpha"])
             if config["reference"] == "slowfast50" else clip)
        counts = model_flops_per_clip(model, x, models.stems(model))
    return {**counts, "train": train_flops_per_clip(counts)}
