"""Shared layer helpers for the video encoders (port of the JAX package's
``models/layers.py``).

Public model entry points keep the JAX layout ``(B, T, H, W, C)``; inside,
modules run torch's ``(B, C, T, H, W)``. A ``(B,T,H,W,C)``-contiguous
tensor permuted with ``.permute(0, 4, 1, 2, 3)`` is already
``(B,C,T,H,W)`` in ``torch.channels_last_3d`` memory, which is the layout
cuDNN prefers for 3-D convolutions on the card, so no copy is made.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

IntOr3 = Union[int, Sequence[int]]


def _triple(v: IntOr3) -> Tuple[int, int, int]:
    if isinstance(v, int):
        return (v, v, v)
    t = tuple(v)
    assert len(t) == 3
    return t  # type: ignore[return-value]


class Conv3d(nn.Conv3d):
    """3-D convolution with torch-style symmetric ``k//2`` padding by
    default (JAX ``layers.Conv3d``); He-normal fan-out init like the flax
    ``variance_scaling(2.0, "fan_out", "normal")``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOr3 = 3, stride: IntOr3 = 1,
                 padding: IntOr3 = None, bias: bool = False):
        k = _triple(kernel_size)
        pad = tuple(d // 2 for d in k) if padding is None else _triple(padding)
        super().__init__(in_channels, out_channels, k, _triple(stride), pad,
                         bias=bias)
        nn.init.kaiming_normal_(self.weight, mode="fan_out",
                                nonlinearity="relu")


class _FlaxRunningVar:
    """Train-mode BatchNorm with flax's running statistics (ROADMAP hazard
    H1). Both packages normalize with the biased batch variance; flax
    (``momentum=0.9``, the JAX package's ``layers.py:76``) then updates
    ``ra_var = 0.9 ra_var + 0.1 var`` with that same biased variance, where
    torch puts in the unbiased ``var * n / (n - 1)``. The forward runs
    torch's fused ``F.batch_norm`` (statistics accumulated in float32, also
    for a bf16 input under autocast, as flax takes them on a float32 copy)
    and then rewrites the C-length running variance to flax's value.
    Eval mode is torch's own."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        n = x.numel() // x.shape[1]
        # torch updates this copy in place (autograd keeps it for the
        # backward pass, so the buffer itself is written only below)
        var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, var, self.weight, self.bias,
                         True, self.momentum, self.eps)
        with torch.no_grad():
            # torch wrote keep + m var n/(n-1); flax wants keep + m var
            keep = self.running_var * (1.0 - self.momentum)
            self.running_var.copy_((var - keep) * ((n - 1) / n) + keep)
        return y


class BatchNorm(_FlaxRunningVar, nn.BatchNorm3d):
    """BatchNorm over (B, C, T, H, W) with eps 1e-5 and torch momentum 0.1
    (flax momentum 0.9); train mode keeps flax's running variance."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)


class BatchNorm1d(_FlaxRunningVar, nn.BatchNorm1d):
    """The projection head's BatchNorm over (B, C), as ``BatchNorm``."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)


def max_pool3d(x: torch.Tensor, kernel: int = 3, stride: int = 2,
               pad: int = 1) -> torch.Tensor:
    """``nn.MaxPool3d(kernel_size=3, stride=2, padding=1)`` on (B,C,T,H,W)."""
    return F.max_pool3d(x, kernel, stride, pad)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool3d((1,1,1)) + flatten: (B,C,T,H,W) -> (B,C)."""
    return x.mean(dim=(2, 3, 4))


class ProjectionHead(nn.Module):
    """Non-linear projection head: fc1 -> BN -> ReLU -> fc2
    (reference models/resnet.py:180-184, 294-299)."""

    def __init__(self, in_dim: int, hidden: int = 2048, out_dim: int = 128):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden)
        self.bn_proj = BatchNorm1d(hidden)
        self.fc2 = nn.Linear(hidden, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.bn_proj(self.fc1(x))))
