"""FLOP counts for the encoders; port of the JAX package's
``utils/flops.py``.

Counts multiply-add FLOPs (2 * MACs) of every convolution and dense layer:
``resnet3d_flops_per_clip`` by formula for the 3-D ResNet forward
(reference architecture models/resnet.py:100-312), ``model_flops_per_clip``
for any module of the port from forward hooks (the JAX function traces
flax instead). ``peaks_for`` gives the H100's peak rates by form factor,
so a throughput can be put beside the card's roofline.
"""

from __future__ import annotations

from typing import Sequence, Tuple

_DEPTH_TO_SPEC = {
    10: ("basic", (1, 1, 1, 1)),
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
    200: ("bottleneck", (3, 24, 36, 3)),
}


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def resnet3d_flops_per_clip(
    depth: int = 18,
    t: int = 16,
    size: int = 128,
    in_channels: int = 3,
    conv1_t_size: int = 7,
    conv1_t_stride: int = 1,
    no_max_pool: bool = True,
    widen_factor: float = 1.0,
    projection_head: bool = True,
    hidden_layer: int = 2048,
    out_dim: int = 128,
) -> int:
    """FLOPs (2*MACs) for one clip through the ResNet3D forward.

    Mirrors the layer dims of models/resnet3d.py: conv1 stride
    (conv1_t_stride, 2, 2); stages 2-4 stride 2 in all three dims;
    shortcut-B 1x1x1 downsample convs counted. Elementwise/BN/pool FLOPs
    are ignored (<1% of total).
    """
    block, layers = _DEPTH_TO_SPEC[depth]
    expansion = 1 if block == "basic" else 4
    planes = [int(p * widen_factor) for p in (64, 128, 256, 512)]

    def conv_flops(out_thw: Tuple[int, int, int], k: Sequence[int],
                   cin: int, cout: int) -> int:
        ot, oh, ow = out_thw
        return 2 * ot * oh * ow * cout * k[0] * k[1] * k[2] * cin

    flops = 0
    T, H, W = _ceil_div(t, conv1_t_stride), size // 2, size // 2
    flops += conv_flops((T, H, W), (conv1_t_size, 7, 7), in_channels,
                        planes[0])
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
                flops += conv_flops((oT, oH, oW), (3, 3, 3), ch, p)
                flops += conv_flops((oT, oH, oW), (3, 3, 3), p, p)
            else:
                flops += conv_flops((T, H, W), (1, 1, 1), ch, p)
                flops += conv_flops((oT, oH, oW), (3, 3, 3), p, p)
                flops += conv_flops((oT, oH, oW), (1, 1, 1), p, out_ch)
            if s != 1 or ch != out_ch:  # shortcut-B downsample conv
                flops += conv_flops((oT, oH, oW), (1, 1, 1), ch, out_ch)
            T, H, W, ch = oT, oH, oW, out_ch

    if projection_head:
        flops += 2 * ch * hidden_layer + 2 * hidden_layer * out_dim
    return flops


def model_flops_per_clip(model, example_input, firsts=()) -> dict:
    """FLOPs (2*MACs) per clip of ``model``'s forward on ``example_input``
    (a batched clip, or the [slow, fast] list of SlowFast), counted from
    the model's own layers by forward hooks: a ``Conv3d`` gives 2 x its
    output elements x the weights of one output channel (``cin/groups *
    kt * kh * kw``), a ``Linear`` 2 x its output elements x
    ``in_features``. BatchNorm, pooling and elementwise work are left out,
    as in ``resnet3d_flops_per_clip``. -> {"forward": FLOPs a clip,
    "first": those of the ``firsts`` layers (stems whose input needs no
    gradient)}. The forward runs once under ``no_grad``."""
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


# the H100's dense peaks by form factor, from NVIDIA's data sheet (the
# tensor-core figures are half the sparse ones): (fp32 on the CUDA cores,
# tf32, memory bytes/s, bf16). The SXM card's name carries no form factor
# ("NVIDIA H100 80GB HBM3"), so an H100 name without "PCIe" or "NVL" is SXM.
H100_PEAKS = {"PCIe": (51e12, 378e12, 2.0e12, 756e12),
              "NVL": (60e12, 417.5e12, 3.9e12, 835.5e12),
              "SXM": (67e12, 495e12, 3.35e12, 989e12)}


def peaks_for(name: str):
    """The H100 named ``name`` (torch.cuda.get_device_name, or nvidia-smi's
    name) -> (form factor, (fp32, tf32, bytes/s, bf16) peaks). Raises on
    any other device: the port has no peaks for it."""
    if "H100" not in name:
        raise ValueError(f"no peak rates for {name!r}: the table holds the "
                         "H100's form factors only")
    for key, val in H100_PEAKS.items():
        if key in name:
            return key, val
    return "SXM", H100_PEAKS["SXM"]


def chip_peak_tflops(device_kind: str, dtype: str = "bfloat16") -> float:
    """Dense peak TFLOP/s of the H100 named ``device_kind`` for ``dtype``
    ("bfloat16" or "float32"), from :func:`peaks_for`."""
    fp32, _, _, bf16 = peaks_for(device_kind)[1]
    return {"bfloat16": bf16, "float32": fp32}[dtype] / 1e12
