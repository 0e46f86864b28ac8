"""Fused exact 1-nearest-neighbor (port of the JAX package's
``ops/pallas_knn.py``).

``nearest_neighbor_fused`` keeps the JAX dispatch: cosine on a CUDA tensor
launches the hand-written kernel ``csrc/nn1_cosine.cu`` (3xTF32 on the
tensor cores, fed by TMA; it never forms the M x N distance matrix); a CPU
tensor takes the plain version,
``ops/pdist.nearest_neighbor`` (tiled ``torch.mm`` + masked argmin); the
euclidean metric takes the plain version on every device, as the JAX
dispatch does (``pallas_knn.py:136-141``). A CUDA tensor never falls back:
the kernel launches or the call raises.

The JAX signature's ``tile_m`` / ``tile_n`` / ``interpret`` are gone: the
kernel's tiles are compile-time constants, and there is no interpreter.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .pdist import l2_normalize, nearest_neighbor

# kernel launches since the last reset; a run sets it to 0 and reads it to
# show that its path went through the kernel
LAUNCHES = 0

_BIG = 3.4e38  # distance of a row with no candidate, as in the TPU kernel
K_CHUNK = 32  # the kernel's D chunk: 32 fp32, one 128-byte swizzle row
_TF32_DROP = 13  # fp32 keeps 23 fraction bits, TF32 10
_LOW_MASK = -(1 << _TF32_DROP)  # int32 with the low 13 bits clear


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest TF32 value (ties to even) with integer
    ops on the bits, so the low 13 bits of the result are zero. Adding to
    the bit pattern rounds the magnitude for either sign, and a carry out of
    the fraction steps the exponent up, as rounding does; inputs are finite
    and far from the largest float."""
    i = t.contiguous().view(torch.int32)
    odd = (i >> _TF32_DROP) & 1
    return ((i + ((1 << (_TF32_DROP - 1)) - 1) + odd) & _LOW_MASK).view(
        torch.float32)


def split_tf32(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 -> (hi, lo), both exact TF32 values: hi = tf32(t), lo =
    tf32(t - hi) (``t - hi`` is exact). Then |t - hi - lo| <= 2^-22 |t| for
    normal t; below 2^-126 TF32 holds only multiples of 2^-136, so the error
    there is at most 2^-137. hi.lo products are exact in fp32."""
    hi = _round_tf32(t)
    return hi, _round_tf32(t - hi)


def pad_to_k_chunk(t: torch.Tensor) -> torch.Tensor:
    """Zero-pad the columns of (rows, D) up to a multiple of ``K_CHUNK``;
    the padding adds nothing to a dot product."""
    pad = (-t.shape[1]) % K_CHUNK
    return torch.nn.functional.pad(t, (0, pad)) if pad else t.contiguous()


def prepare_operand(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the kernel reads of one side: the rows padded to ``K_CHUNK``
    columns and split into (hi, lo)."""
    return split_tf32(pad_to_k_chunk(t))


def _lib():
    from . import cuda_build

    lib = cuda_build.load("nn1_cosine")
    fn = lib.nn1_cosine
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def nn1_cosine_cuda(xn: torch.Tensor, yn: torch.Tensor, exclude_self: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on L2-normalized float32 CUDA rows; -> (idx int64
    (M,), dist float32 (M,)). ``exclude_self`` masks the diagonal (for a
    self-query, where ``yn`` is ``xn``, which is then padded and split only
    once). The padding and the hi/lo split happen here, in PyTorch."""
    global LAUNCHES
    for name, t in (("x", xn), ("y", yn)):
        if not t.is_cuda or t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError(f"nn1_cosine: {name} must be a 2-D float32 CUDA "
                             f"tensor, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if xn.shape[1] != yn.shape[1] or xn.device != yn.device:
        raise ValueError("nn1_cosine: x and y differ in width or device")
    if max(xn.shape[0], yn.shape[0], xn.shape[1]) >= 2 ** 31:
        raise ValueError("nn1_cosine: sizes must fit in int32")
    m, n = xn.shape[0], yn.shape[0]
    if m == 0 or n == 0:  # nothing to compare: every row has no candidate
        return (torch.zeros(m, dtype=torch.int64, device=xn.device),
                torch.full((m,), _BIG, dtype=torch.float32, device=xn.device))
    x_hi, x_lo = prepare_operand(xn)
    y_hi, y_lo = (x_hi, x_lo) if yn is xn else prepare_operand(yn)
    idx = torch.empty(m, dtype=torch.int64, device=xn.device)
    dist = torch.empty(m, dtype=torch.float32, device=xn.device)
    with torch.cuda.device(xn.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib()(x_hi.data_ptr(), x_lo.data_ptr(), y_hi.data_ptr(),
                    y_lo.data_ptr(), idx.data_ptr(), dist.data_ptr(), m, n,
                    x_hi.shape[1], int(exclude_self), stream)
    if rc != 0:
        raise RuntimeError(f"nn1_cosine launch failed: code {rc} (a "
                           "cudaError_t; 10000 + CUresult: TMA descriptor "
                           "refused; -2: no cuTensorMapEncodeTiled)")
    LAUNCHES += 1
    return idx, dist


def nearest_neighbor_fused(x: torch.Tensor, y: Optional[torch.Tensor] = None,
                           metric: str = "cosine", exclude_self: bool = True
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN of each row of x in y (default: in x, excluding self).
    Returns (indices int64 (M,), distances float32 (M,))."""
    if metric != "cosine" or not x.is_cuda:
        return nearest_neighbor(x, y, metric=metric,
                                exclude_self=exclude_self)
    self_query = y is None
    xn = l2_normalize(x.float())
    yn = xn if self_query else l2_normalize(y.float())
    return nn1_cosine_cuda(xn, yn, exclude_self and self_query)
