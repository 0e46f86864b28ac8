"""The 3-D ResNet's eval-mode BatchNorm epilogue as one pass over the
activation: ``relu(bn(x))``, ``relu(bn(x) + r)`` or, with shortcut B's
downsample BatchNorm folded in, ``relu(bn(x) + bn_ds(r))``.

``bn_act_cuda(x, bn, residual, residual_bn, out)`` computes it from the
BatchNorms' running statistics by the hand-written kernel
``csrc/bn_act.cu`` (one read of ``x`` and of ``residual``, one write,
float32 arithmetic, one rounding); ``bn_act_plain`` is the same arithmetic
in PyTorch. A CUDA tensor never falls back: the kernel launches or the
call raises. The kernel replaces no TPU kernel (the JAX package leaves
BatchNorm, the add and ReLU to XLA, which fuses them); it is bound by
bytes.

``engages`` is the routing rule the 3-D ResNet's blocks and stem apply
(``bn_relu``): the fused pass where the BatchNorms are in eval mode, no
autograd graph is recorded (the pass has no backward), the device is CUDA
and the tensors lie in ``channels_last_3d`` memory, bf16 or float32, with a
multiple of 8 channels. Train mode, the CPU and every other layout or type
keep the modules' own calls. As ``stem_conv.engages`` does, the rule takes
the device's type from its caller.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

# kernel launches since the last reset; a run sets it to 0 and reads it to
# show that its path went through the kernel
LAUNCHES = 0

DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_CHANNEL_ALIGN = 8  # the kernel moves 16 bytes of channels a thread
_BYTE_ALIGN = 16
_CL = torch.channels_last_3d


def _takes(x: torch.Tensor) -> bool:
    """A (N, C, T, H, W) bf16 or float32 tensor in channels_last_3d memory,
    16-byte aligned, with a multiple of 8 channels."""
    return (x.dim() == 5 and x.dtype in DTYPES
            and x.shape[1] % _CHANNEL_ALIGN == 0
            and x.is_contiguous(memory_format=_CL)
            and x.data_ptr() % _BYTE_ALIGN == 0)


def may_engage(module: nn.Module, device_type: str) -> bool:
    """Whether ``module``'s BatchNorm epilogues may take the fused pass for
    an input on ``device_type``: eval mode, no autograd graph recorded (the
    pass has no backward), CUDA. ``engages`` checks the rest at each
    pass."""
    return (not module.training and not torch.is_grad_enabled()
            and device_type == "cuda")


def _norm_takes(bn: nn.Module, x: torch.Tensor) -> bool:
    """An affine BatchNorm of x's channels whose parameters and running
    statistics are contiguous float32 vectors on x's device."""
    return (isinstance(bn, nn.modules.batchnorm._BatchNorm)
            and bn.affine and bn.track_running_stats
            and bn.num_features == x.shape[1]
            and all(p.dtype == torch.float32 and p.device == x.device
                    and p.is_contiguous() for p in _params(bn)))


def _params(bn: nn.Module) -> tuple:
    return bn.weight, bn.bias, bn.running_mean, bn.running_var


def engages(bn: nn.Module, device_type: str, x: torch.Tensor,
            residual: Optional[torch.Tensor] = None,
            residual_bn: Optional[nn.Module] = None) -> bool:
    """Whether ``bn_relu`` takes the fused pass for these operands on
    ``device_type``: ``may_engage(bn, device_type)``, ``x`` as ``_takes``
    says, ``residual`` (if any) of x's shape, type and memory layout, and
    each BatchNorm in eval mode with its parameters float32 on x's
    device."""
    return (may_engage(bn, device_type) and _takes(x)
            and _norm_takes(bn, x)
            and (residual is None or _matches(residual, x))
            and (residual_bn is None
                 or (residual is not None and not residual_bn.training
                     and _norm_takes(residual_bn, x))))


def _matches(y: torch.Tensor, x: torch.Tensor) -> bool:
    return (y.shape == x.shape and y.dtype == x.dtype
            and y.device == x.device and _takes(y))


def _scale_shift(bn: nn.Module, dtype: torch.dtype):
    """BatchNorm's eval affine map: ``x * s + t`` with s = w / sqrt(var +
    eps), t = b - mean * s, in ``dtype``, shaped to broadcast over
    (N, C, T, H, W)."""
    w, b, mean, var = (p.to(dtype) for p in _params(bn))
    s = w * torch.rsqrt(var + bn.eps)
    t = b - mean * s
    return s.view(1, -1, 1, 1, 1), t.view(1, -1, 1, 1, 1)


def bn_act_plain(x: torch.Tensor, bn: nn.Module,
                 residual: Optional[torch.Tensor] = None,
                 residual_bn: Optional[nn.Module] = None) -> torch.Tensor:
    """The plain version: the kernel's arithmetic in PyTorch, in float32
    (float64 for a float64 ``x``), rounded once to x's type."""
    acc = torch.promote_types(x.dtype, torch.float32)
    s, t = _scale_shift(bn, acc)
    y = x.to(acc) * s + t
    if residual is not None:
        r = residual.to(acc)
        if residual_bn is not None:
            s2, t2 = _scale_shift(residual_bn, acc)
            r = r * s2 + t2
        y = y + r
    return y.relu_().to(x.dtype)


def _lib():
    from . import cuda_build

    fn = cuda_build.load("bn_act").bn_act
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
                   + [ctypes.c_float] + [ctypes.c_void_p] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


class BnAct(torch.autograd.Function):
    """The kernel's launch as an op a profiler names: a kernel launched
    from ctypes outside every op is linked to none, and device time summed
    by the ops of a span (``port_bench``'s per-layer readers) would leave
    it out. Takes the launch's arguments, returns its status code; no
    tensor, no gradient."""

    @staticmethod
    def forward(ctx, *args) -> int:
        return _lib()(*args)


def bn_act_cuda(x: torch.Tensor, bn: nn.Module,
                residual: Optional[torch.Tensor] = None,
                residual_bn: Optional[nn.Module] = None,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel on x's card -> ``out`` (a new tensor of x's shape,
    type and layout when None; ``x`` itself for the pass in place)."""
    global LAUNCHES
    if not x.is_cuda or not _takes(x):
        raise ValueError("bn_act: x must be a 16-byte aligned CUDA "
                         "(N, C, T, H, W) bf16 or float32 tensor in "
                         "channels_last_3d memory with C a multiple of 8, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device} "
                         f"with strides {x.stride()}")
    if residual is not None and not _matches(residual, x):
        raise ValueError("bn_act: residual must match x's shape, type, "
                         "device and layout")
    if out is None:
        out = torch.empty_like(x)
    elif not (out is x or _matches(out, x)):
        raise ValueError("bn_act: out must be x or match its shape, type, "
                         "device and layout")
    if residual_bn is not None and residual is None:
        raise ValueError("bn_act: residual_bn needs a residual")
    if not all(_norm_takes(m, x) for m in (bn, residual_bn) if m is not None):
        raise ValueError("bn_act: each BatchNorm must be affine, keep "
                         "running statistics of x's channels, and hold them "
                         "in float32 on x's device")
    if x.numel() == 0:
        return out
    mode = 0 if residual is None else 1 if residual_bn is None else 2
    c = x.shape[1]
    rows = x.numel() // c
    ptrs = [p.data_ptr() for p in _params(bn)]
    ptrs2 = ([p.data_ptr() for p in _params(residual_bn)]
             if residual_bn is not None else [None] * 4)
    eps2 = residual_bn.eps if residual_bn is not None else 0.0
    with torch.cuda.device(x.device):
        # the stream of x's device, named: without a device the lookup
        # counts the devices, ~10 ms on the H100's host
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = BnAct.apply(x.data_ptr(),
                         residual.data_ptr() if residual is not None
                         else None, out.data_ptr(), rows, c,
                         DTYPES[x.dtype], mode, *ptrs, bn.eps, *ptrs2, eps2,
                         stream)
    if rc != 0:
        raise RuntimeError(f"bn_act launch failed: code {rc} (a "
                           "cudaError_t; -1: arguments the kernel does not "
                           "take)")
    LAUNCHES += 1
    return out


def bn_relu(x: torch.Tensor, bn: nn.Module,
            residual: Optional[torch.Tensor] = None,
            residual_bn: Optional[nn.Module] = None) -> torch.Tensor:
    """A block's ``relu(bn(x) [+ residual_bn(residual) | + residual])``.
    ``x`` is a convolution's output that nothing else reads: where
    ``engages`` holds, the fused pass writes the result over it; elsewhere
    the modules' own calls run, as unfused eager code does."""
    if engages(bn, x.device.type, x, residual, residual_bn):
        return bn_act_cuda(x, bn, residual, residual_bn, out=x)
    if residual_bn is not None:
        residual = residual_bn(residual)
    y = bn(x)
    return F.relu(y if residual is None else y + residual)
