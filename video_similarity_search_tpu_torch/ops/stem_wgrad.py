"""The float32 weight gradient of S3D's 3-channel stem convolution
(``Conv_1a.conv1``: a (1, 7, 7) kernel, stride (1, 2, 2), zero padding
(0, 3, 3), no bias) as a hand-written kernel.

``StemWgradF32`` is an autograd Function whose forward is ``F.conv3d``
exactly as ``nn.Conv3d`` calls it, and whose backward computes the
weight's gradient alone: on a CUDA tensor by the kernel
``csrc/stem_wgrad_f32.cu`` (IEEE float32 FMAs on the CUDA cores, a fixed
summation order, so bitwise the same from run to run), on a CPU tensor by
the plain version, ``aten.convolution_backward``'s weight gradient on the
same operands. A CUDA tensor never falls back: the kernel launches or the
call raises.

``engages`` is the routing rule ``S3D.forward`` applies to its stem: the
kernel computes the gradient on CUDA in float32 (no autocast) when the
weight takes a gradient and the clip does not, for the stem's shape.
The key encoder of MoCo (no gradient), bf16 autocast, the 2-channel flow
stem and every other convolution keep ``nn.Conv3d``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

# kernel launches since the last reset; a run sets it to 0 and reads it to
# show that its path went through the kernel
LAUNCHES = 0

KERNEL = (1, 7, 7)
STRIDE = (1, 2, 2)
PADDING = (0, 3, 3)
TILE_N = 64  # output channels a kernel pass
# the kernel copies 16-byte chunks of channels-last rows: 4 pixels of W,
# from a 16-byte aligned start
_W_ALIGN = 4
_BYTE_ALIGN = 16


def engages(conv: torch.nn.Conv3d, x: torch.Tensor,
            compute_dtype: Optional[torch.dtype]) -> bool:
    """Whether the kernel computes the weight gradient of ``conv`` applied
    to the clip ``x`` under autocast in ``compute_dtype`` (None: no
    autocast): a float32 CUDA clip without autocast, grad mode on, a
    float32 weight that requires a gradient and a clip that does not; 3
    input channels, a (1, 7, 7) kernel, stride (1, 2, 2), padding (0, 3,
    3), no bias, groups and dilation 1, zero padding, and a multiple of 64
    output channels."""
    return (x.device.type == "cuda" and compute_dtype is None
            and x.dtype == torch.float32
            and conv.weight.dtype == torch.float32
            and torch.is_grad_enabled() and conv.weight.requires_grad
            and not x.requires_grad
            and conv.in_channels == 3 and conv.out_channels % TILE_N == 0
            and tuple(conv.kernel_size) == KERNEL
            and tuple(conv.stride) == STRIDE
            and tuple(conv.padding) == PADDING and conv.bias is None
            and conv.groups == 1 and tuple(conv.dilation) == (1, 1, 1)
            and conv.padding_mode == "zeros")


def weight_grad_plain(x: torch.Tensor, grad: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """The plain version: ``aten.convolution_backward``'s weight gradient
    for the (B, 3, T, H, W) input ``x``, the output gradient ``grad`` and
    ``weight`` (the call autograd makes for ``nn.Conv3d``)."""
    _, grad_w, _ = torch.ops.aten.convolution_backward(
        grad, x, weight, None, list(STRIDE), list(PADDING), [1, 1, 1], False,
        [0, 0, 0], 1, [False, True, False])
    return grad_w


def _lib():
    from . import cuda_build

    lib = cuda_build.load("stem_wgrad_f32")
    size = lib.stem_wgrad_f32_workspace
    size.argtypes = [ctypes.c_int] * 7
    size.restype = ctypes.c_longlong
    fn = lib.stem_wgrad_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return size, fn


def _aligned(t: torch.Tensor) -> torch.Tensor:
    return t if t.data_ptr() % _BYTE_ALIGN == 0 else t.clone()


def weight_grad_cuda(x: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: float32 (B, T, H, W, 3) clips ``x`` and the
    float32 (B, Cout, T, ceil(H / 2), ceil(W / 2)) output gradient
    ``grad`` on one card -> the (Cout, 3, 1, 7, 7) weight gradient in
    channels_last_3d memory. W not a multiple of 4 is zero-padded up to
    one first (the padded columns lie where the convolution's own padding
    reads zeros), and an operand that starts off 16 bytes is copied."""
    global LAUNCHES
    if not (x.is_cuda and grad.is_cuda and x.device == grad.device):
        raise ValueError("stem_wgrad: x and grad must be on one CUDA "
                         f"device, got {x.device} and {grad.device}")
    if x.dtype != torch.float32 or grad.dtype != torch.float32:
        raise ValueError("stem_wgrad: x and grad must be float32, got "
                         f"{x.dtype} and {grad.dtype}")
    if x.dim() != 5 or x.shape[4] != 3:
        raise ValueError("stem_wgrad: x must be a (B, T, H, W, 3) tensor, "
                         f"got {tuple(x.shape)}")
    b, t, h, w, _ = x.shape
    ho, wo = (h + 1) // 2, (w + 1) // 2
    cout = grad.shape[1] if grad.dim() == 5 else 0
    if tuple(grad.shape) != (b, cout, t, ho, wo) or cout % TILE_N or not cout:
        raise ValueError(f"stem_wgrad: grad must be ({b}, 64 n, {t}, {ho}, "
                         f"{wo}), got {tuple(grad.shape)}")
    if max(b * t * h, 3 * w, b * t * ho, cout) >= 2 ** 31:
        raise ValueError("stem_wgrad: sizes must fit in int32")
    dw = torch.empty((cout, 1, 7, 7, 3), dtype=torch.float32,
                     device=x.device)
    if x.numel() == 0:
        return dw.zero_().permute(0, 4, 1, 2, 3)
    x = x.contiguous()
    if w % _W_ALIGN:
        x = F.pad(x, (0, 0, 0, _W_ALIGN - w % _W_ALIGN))
    x = _aligned(x)
    dy = _aligned(grad.contiguous(memory_format=torch.channels_last_3d))
    size, fn = _lib()
    with torch.cuda.device(x.device):
        floats = size(b, t, h, x.shape[3], ho, wo, cout)
        if floats < 0:
            raise RuntimeError(f"stem_wgrad: cannot size the launch: code "
                               f"{floats} (-1: shapes the kernel does not "
                               "take; -2: a CUDA error)")
        workspace = torch.empty(floats, dtype=torch.float32,
                                device=x.device)
        # the stream of x's device, named: without a device the lookup asks
        # CUDA for the device count, ~10 ms on the H100's host
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), dy.data_ptr(), dw.data_ptr(),
                workspace.data_ptr(), b, t, h, x.shape[3], ho, wo, cout,
                stream)
    if rc != 0:
        raise RuntimeError(f"stem_wgrad launch failed: code {rc} (a "
                           "cudaError_t; -1: shapes the kernel does not "
                           "take; -2: a CUDA error while sizing the grid)")
    LAUNCHES += 1
    return dw.permute(0, 4, 1, 2, 3)


class StemWgradF32(torch.autograd.Function):
    """The stem convolution of the (B, 3, T, H, W) clip view ``x`` (the
    channels_last_3d view of the (B, T, H, W, 3) clips), ``F.conv3d`` as
    ``nn.Conv3d`` runs it, with the weight's gradient alone: the clip is an
    input, never a parameter, so an input gradient is refused rather than
    computed by another route."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        if ctx.needs_input_grad[0]:
            raise RuntimeError("stem_wgrad computes no gradient for its "
                               "input clips")
        ctx.save_for_backward(x, weight)
        return F.conv3d(x, weight, None, STRIDE, PADDING)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        x, weight = ctx.saved_tensors
        if not grad.is_cuda:
            return None, weight_grad_plain(x, grad, weight)
        grad_w = weight_grad_cuda(x.permute(0, 2, 3, 4, 1), grad)
        # the gradient in the weight's memory order (channels_last_3d, as
        # the models keep their weights on the card, needs no copy)
        return None, grad_w.contiguous() if weight.is_contiguous() else grad_w
