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


class BatchNorm(nn.BatchNorm3d):
    """BatchNorm over (B, C, T, H, W) with eps 1e-5 and torch momentum 0.1
    (flax momentum 0.9). This slice runs it in eval mode only; the
    running-variance update differs from flax in train mode (ROADMAP
    hazard H1) and is settled with the training slice."""

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
        self.bn_proj = nn.BatchNorm1d(hidden, eps=1e-5, momentum=0.1)
        self.fc2 = nn.Linear(hidden, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.bn_proj(self.fc1(x))))
