"""The control's lower precision: fp8, the step below the bf16 that both
configurations state.

``fp8`` rounds a tensor to float8 e4m3 under a per-tensor scale that maps
its largest magnitude to 448 (e4m3's largest finite value), as an fp8
matrix product takes its operands; in the backward pass the incoming
gradient is rounded to e5m2 the same way (largest finite value 57344).
The products themselves then run in float32 on the rounded values. Put on
every convolution's and dense layer's input and weight
(``models.set_quant``), this is the reference computed in fp8.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _FP8.apply(x)
