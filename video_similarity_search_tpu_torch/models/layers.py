"""Shared layer helpers for the video encoders (port of the JAX package's
``models/layers.py``).

Public model entry points keep the JAX layout ``(B, T, H, W, C)``; inside,
modules run torch's ``(B, C, T, H, W)``. A ``(B,T,H,W,C)``-contiguous
tensor permuted with ``.permute(0, 4, 1, 2, 3)`` is already
``(B,C,T,H,W)`` in ``torch.channels_last_3d`` memory, which is the layout
cuDNN prefers for 3-D convolutions on the card, so no copy is made.
"""

from __future__ import annotations

import contextlib
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
    ``variance_scaling(2.0, "fan_out", "normal")`` (untruncated; for a
    grouped convolution both count the fan-out as Cout x the window), a
    bias (when asked for) at zero like flax's."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOr3 = 3, stride: IntOr3 = 1,
                 padding: IntOr3 = None, bias: bool = False,
                 groups: int = 1, dilation: IntOr3 = 1):
        k = _triple(kernel_size)
        pad = tuple(d // 2 for d in k) if padding is None else _triple(padding)
        super().__init__(in_channels, out_channels, k, _triple(stride), pad,
                         dilation=_triple(dilation), groups=groups, bias=bias)
        nn.init.kaiming_normal_(self.weight, mode="fan_out",
                                nonlinearity="relu")
        if bias:
            nn.init.zeros_(self.bias)


class _FlaxRunningVar:
    """Train-mode BatchNorm with flax's running statistics (ROADMAP hazard
    H1). Both packages normalize with the biased batch variance; flax
    (``momentum=0.9``, the JAX package's ``layers.py:76``) then updates
    ``ra_var = 0.9 ra_var + 0.1 var`` with that same biased variance, where
    torch puts in the unbiased ``var * n / (n - 1)``. The forward runs
    torch's fused ``F.batch_norm`` (statistics accumulated in float32, also
    for a bf16 input under autocast, as flax takes them on a float32 copy)
    and then rewrites the C-length running variance to flax's value.
    Eval mode is torch's own.

    ``frozen_stats`` is set while ``torch.utils.checkpoint`` recomputes a
    block's forward for the backward pass: the layer then normalizes by the
    batch's statistics as before but leaves the running statistics as the
    first forward wrote them, once, as flax's ``nn.remat`` does (ROADMAP
    hazard H7)."""

    frozen_stats = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        self._check_input_dim(x)
        if self.frozen_stats:  # the same call on copies of both statistics
            return F.batch_norm(x, self.running_mean.clone(),
                                self.running_var.clone(), self.weight,
                                self.bias, True, self.momentum, self.eps)
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
    (flax momentum 0.9); train mode keeps flax's running variance.
    ``zero_scale``: the scale starts at zero (flax ``scale_init=zeros``,
    SlowFast's last BatchNorm of a bottleneck and of a Nonlocal block), so
    the residual branch starts as nothing."""

    def __init__(self, num_features: int, zero_scale: bool = False):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        if zero_scale:
            nn.init.zeros_(self.weight)


class BatchNorm1d(_FlaxRunningVar, nn.BatchNorm1d):
    """The projection head's BatchNorm over (B, C), as ``BatchNorm``."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)


class SubBatchNorm(nn.Module):
    """Split-batch BatchNorm over (B, C, T, H, W) (the JAX package's
    ``layers.SubBatchNorm``; reference SubBatchNorm3d,
    models/slowfast/slowfast/models/batchnorm_helper.py:41-120). In train
    mode the batch is cut into ``num_splits`` contiguous groups (items
    ``[g B/S, (g + 1) B/S)``), each normalized by its own mean and biased
    variance; the running statistics take one flax-momentum update with
    the mean of the group means and the mean of the group variances plus
    the spread of the group means. One affine ``weight`` / ``bias`` serves
    every group; eval mode normalizes by the running statistics.
    Statistics are taken in float32 (float64 for a float64 input)."""

    frozen_stats = False  # as ``_FlaxRunningVar.frozen_stats``

    def __init__(self, num_features: int, num_splits: int = 1,
                 eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.num_splits, self.eps, self.momentum = num_splits, eps, momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        shape = (1, -1, 1, 1, 1)
        if not self.training:
            mean = self.running_mean.to(xf.dtype).view(shape)
            var = self.running_var.to(xf.dtype).view(shape)
        else:
            b, s = x.shape[0], self.num_splits
            assert b % s == 0, f"batch {b} % num_splits {s} != 0"
            g = xf.reshape((s, b // s) + tuple(x.shape[1:]))
            mean = g.mean(dim=(1, 3, 4, 5))  # (splits, C)
            var = (g - mean[:, None, :, None, None, None]).square().mean(
                dim=(1, 3, 4, 5))
            if not self.frozen_stats:
                with torch.no_grad():
                    agg_mean = mean.mean(0)
                    agg_var = var.mean(0) + (mean - agg_mean).square().mean(0)
                    m = self.momentum
                    self.running_mean.copy_((1 - m) * self.running_mean
                                            + m * agg_mean)
                    self.running_var.copy_((1 - m) * self.running_var
                                           + m * agg_var)
            mean = mean.repeat_interleave(b // s, dim=0)[..., None, None, None]
            var = var.repeat_interleave(b // s, dim=0)[..., None, None, None]
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight.to(xf.dtype).view(shape) + \
            self.bias.to(xf.dtype).view(shape)
        return y.to(x.dtype)


@contextlib.contextmanager
def frozen_stats(module: nn.Module):
    """The BatchNorms of ``module`` normalize by the batch as in train mode
    but keep their running statistics (``_FlaxRunningVar.frozen_stats``):
    remat's recomputation (ROADMAP hazard H7) and the MoCo key encoder's
    forward, whose statistics the JAX step throws away (H9)."""
    norms = [m for m in module.modules()
             if isinstance(m, (_FlaxRunningVar, SubBatchNorm))]
    for m in norms:
        m.frozen_stats = True
    try:
        yield
    finally:
        for m in norms:
            m.frozen_stats = False


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
