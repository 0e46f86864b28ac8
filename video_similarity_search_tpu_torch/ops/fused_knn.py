"""Fused exact 1-nearest-neighbor (port of the JAX package's
``ops/pallas_knn.py``).

``nearest_neighbor_fused`` keeps the JAX dispatch: cosine on a CUDA tensor
launches the hand-written kernel ``csrc/nn1_cosine.cu`` (which never forms
the M x N distance matrix); a CPU tensor takes the plain version,
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


def _lib():
    from . import cuda_build

    lib = cuda_build.load("nn1_cosine")
    fn = lib.nn1_cosine
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def nn1_cosine_cuda(xn: torch.Tensor, yn: torch.Tensor, exclude_self: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on L2-normalized float32 CUDA rows; -> (idx int64
    (M,), dist float32 (M,)). ``exclude_self`` masks the diagonal (for a
    self-query, where ``yn`` is ``xn``)."""
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
    xn, yn = xn.contiguous(), yn.contiguous()
    m = xn.shape[0]
    idx = torch.empty(m, dtype=torch.int64, device=xn.device)
    dist = torch.empty(m, dtype=torch.float32, device=xn.device)
    if m == 0:
        return idx, dist
    with torch.cuda.device(xn.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib()(xn.data_ptr(), yn.data_ptr(), idx.data_ptr(),
                    dist.data_ptr(), m, yn.shape[0], xn.shape[1],
                    int(exclude_self), stream)
    if rc != 0:
        raise RuntimeError(f"nn1_cosine launch failed: cudaError {rc}")
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
