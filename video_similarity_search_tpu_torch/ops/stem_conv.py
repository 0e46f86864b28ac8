"""The 3-D ResNet family's 3-channel stem convolution on Hopper's tensor
cores (``conv1``: a (kT, 7, 7) kernel, stride (1, 2, 2), zero padding
(kT // 2, 3, 3), no bias).

``stem_conv3d(x, weight)`` takes the model's (B, T, H, W, 3) clips and
the (Cout, 3, kT, 7, 7) weight and returns (B, Cout, T, ceil(H / 2),
ceil(W / 2)). On a CUDA tensor it casts both to bf16, as autocast would,
and launches the hand-written kernel ``csrc/stem_conv3d.cu`` (bf16
products summed in fp32 on the tensor cores; the output is bf16 in
``channels_last_3d``); its gradient is the weight's alone, through
``aten.convolution_backward`` (the cuDNN weight-gradient kernel the
autocast convolution runs). A CPU tensor takes the plain version,
``F.conv3d`` on the same operands. A CUDA tensor never falls back: the
kernel launches or the call raises.

``engages`` is the routing rule ``ResNet3D.forward`` applies: the kernel
replaces ``conv1`` on CUDA under bf16 autocast, for the shapes it takes;
float32 compute, the CPU and every other stem keep ``conv1``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

# kernel launches since the last reset; a run sets it to 0 and reads it to
# show that its path went through the kernel
LAUNCHES = 0

STRIDE = (1, 2, 2)
TILE_N = 64  # output channels a kernel pass
# the kernel reads 16-byte chunks of channels-last rows: 8 pixels of W,
# from a 16-byte aligned start
_W_ALIGN = 8
_BYTE_ALIGN = 16


def padding(kt: int):
    return (kt // 2, 3, 3)


def engages(conv: torch.nn.Conv3d, device_type: str,
            compute_dtype: Optional[torch.dtype]) -> bool:
    """Whether the kernel computes ``conv``'s forward for an input on
    ``device_type`` under autocast in ``compute_dtype`` (None: no
    autocast): on CUDA in bf16, for 3 input channels, a (kT, 7, 7) kernel
    with odd kT <= 7, stride (1, 2, 2), padding (kT // 2, 3, 3), no bias,
    no groups or dilation, and a multiple of 64 output channels."""
    kt = conv.kernel_size[0]
    return (device_type == "cuda" and compute_dtype == torch.bfloat16
            and conv.in_channels == 3 and conv.out_channels % TILE_N == 0
            and kt % 2 == 1 and kt <= 7 and conv.kernel_size[1:] == (7, 7)
            and tuple(conv.stride) == STRIDE
            and tuple(conv.padding) == padding(kt) and conv.bias is None
            and conv.groups == 1 and tuple(conv.dilation) == (1, 1, 1))


def autocast_dtype(device_type: str) -> Optional[torch.dtype]:
    """The autocast dtype in force on ``device_type``, or None."""
    if torch.is_autocast_enabled(device_type):
        return torch.get_autocast_dtype(device_type)
    return None


def conv3d_plain(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The plain version: ``F.conv3d`` of (B, T, H, W, 3) ``x`` (as its
    channels_last_3d view) with ``weight``."""
    return F.conv3d(x.permute(0, 4, 1, 2, 3), weight, None, STRIDE,
                    padding(weight.shape[2]))


def _lib():
    from . import cuda_build

    fn = cuda_build.load("stem_conv3d").stem_conv3d
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def stem_conv3d_cuda(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: bf16 contiguous (B, T, H, W, 3) ``x`` and bf16
    (Cout, 3, kT, 7, 7) ``weight`` on one card -> bf16 (B, Cout, T, Ho, Wo)
    in channels_last_3d. W not a multiple of 8 is zero-padded up to one
    first (the padded columns only add zeros that the convolution's own
    padding reads), and a view that starts off 16 bytes is copied."""
    global LAUNCHES
    if not (x.is_cuda and weight.is_cuda and x.device == weight.device):
        raise ValueError("stem_conv3d: x and weight must be on one CUDA "
                         f"device, got {x.device} and {weight.device}")
    if x.dtype != torch.bfloat16 or weight.dtype != torch.bfloat16:
        raise ValueError("stem_conv3d: x and weight must be bfloat16, got "
                         f"{x.dtype} and {weight.dtype}")
    if x.dim() != 5 or x.shape[4] != 3 or not x.is_contiguous():
        raise ValueError("stem_conv3d: x must be a contiguous (B, T, H, W, "
                         f"3) tensor, got {tuple(x.shape)} with strides "
                         f"{x.stride()}")
    cout, cin, kt = weight.shape[:3]
    if (weight.dim() != 5 or cin != 3 or tuple(weight.shape[3:]) != (7, 7)
            or kt % 2 == 0 or kt > 7 or cout % TILE_N):
        raise ValueError("stem_conv3d: weight must be (64 n, 3, kT, 7, 7) "
                         f"with odd kT <= 7, got {tuple(weight.shape)}")
    b, t, h, w, _ = x.shape
    ho, wo = (h + 1) // 2, (w + 1) // 2
    if max(b * t * h, 3 * w, b * t, cout) >= 2 ** 31:
        raise ValueError("stem_conv3d: sizes must fit in int32")
    out = torch.empty((b, t, ho, wo, cout), dtype=torch.bfloat16,
                      device=x.device)
    if out.numel() == 0:
        return out.permute(0, 4, 1, 2, 3)
    if w % _W_ALIGN:
        x = F.pad(x, (0, 0, 0, _W_ALIGN - w % _W_ALIGN))
    elif x.data_ptr() % _BYTE_ALIGN:
        x = x.clone()
    # the kernel reads the weight in its channels_last_3d memory order
    w_cl = weight.permute(0, 2, 3, 4, 1).contiguous()
    with torch.cuda.device(x.device):
        # the stream of x's device, named: without a device the lookup asks
        # the driver for the device count, ~10 ms on the H100's host
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib()(x.data_ptr(), w_cl.data_ptr(), out.data_ptr(), b, t, h,
                    x.shape[3], ho, wo, cout, kt, stream)
    if rc != 0:
        raise RuntimeError(f"stem_conv3d launch failed: code {rc} (a "
                           "cudaError_t; -1: shapes the kernel does not "
                           "take)")
    LAUNCHES += 1
    return out.permute(0, 4, 1, 2, 3)


class StemConv3d(torch.autograd.Function):
    """The stem convolution with the weight's gradient alone: the clip is
    an input, never a parameter, so an input gradient is refused rather
    than computed by another route."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        if ctx.needs_input_grad[0]:
            raise RuntimeError("stem_conv3d computes no gradient for its "
                               "input clips")
        ctx.save_for_backward(x, weight)
        if x.is_cuda:
            return stem_conv3d_cuda(x, weight)
        return conv3d_plain(x, weight)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        x, weight = ctx.saved_tensors
        _, grad_w, _ = torch.ops.aten.convolution_backward(
            grad, x.permute(0, 4, 1, 2, 3), weight, None, list(STRIDE),
            list(padding(weight.shape[2])), [1, 1, 1], False, [0, 0, 0], 1,
            [False, True, False])
        return None, grad_w


def stem_conv3d(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, 3) clips -> conv1's (B, Cout, T, ceil(H/2), ceil(W/2))
    output: the kernel in bf16 on CUDA, the plain version on the CPU."""
    if x.is_cuda:
        x = x.to(torch.bfloat16).contiguous()
        weight = weight.to(torch.bfloat16)
    return StemConv3d.apply(x, weight)
