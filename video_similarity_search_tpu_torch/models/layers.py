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

from ..parallel import dist as pdist
from ..utils.profiling import span

# the span around each all-reduce of BatchNorm's train-mode statistics
# (and of their gradients) over a process group
BN_STATS = "dist.bn_stats"

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


class _SyncBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the global batch of a process group (the
    JAX package's cross-replica BatchNorm): the forward all-reduces each
    channel's [sum x, sum x^2, n] and normalizes by the global mean and
    biased variance E[x^2] - E[x]^2 (flax's one-pass form); the backward
    all-reduces [sum dy, sum dy * xhat], so each rank's input gradient is
    that of the global normalization. The affine gradients stay this
    rank's sums (``sum_gradients`` adds them up). Statistics are float32
    (float64 for a float64 input); the output has the input's dtype."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        acc = torch.promote_types(x.dtype, torch.float32)
        with torch.autocast(x.device.type, enabled=False):
            xf = x.to(acc)
            # filled on the device: a tensor built from a host list would
            # be a blocking copy, one host wait a layer
            n = xf.new_full((1,), x.numel() // x.shape[1])
            local = torch.cat([xf.sum(dims), (xf * xf).sum(dims), n])
            with span(BN_STATS):
                sums = pdist.all_reduce_sum(local)
            c = x.shape[1]
            count = sums[2 * c]
            mean = sums[:c] / count
            var = (sums[c:2 * c] / count - mean * mean).clamp_min(0)
            invstd = torch.rsqrt(var + eps)
            scale = weight.to(acc) * invstd
            y = xf * scale.view(shape) + (bias.to(acc)
                                          - mean * scale).view(shape)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.count = count
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd = ctx.saved_tensors
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        acc = mean.dtype
        with torch.autocast(x.device.type, enabled=False):
            dyf = dy.to(acc)
            xhat = (x.to(acc) - mean.view(shape)) * invstd.view(shape)
            local = torch.cat([dyf.sum(dims), (dyf * xhat).sum(dims)])
            c = x.shape[1]
            dbias, dweight = local[:c].clone(), local[c:].clone()
            with span(BN_STATS):
                total = pdist.all_reduce_sum(local)
            total = total / ctx.count
            dx = (dyf - total[:c].view(shape)
                  - xhat * total[c:].view(shape)) \
                * (weight.to(acc) * invstd).view(shape)
        return (dx.to(x.dtype), dweight.to(weight.dtype),
                dbias.to(weight.dtype), None)


class _FlaxRunningVar:
    """Train-mode BatchNorm with flax's running statistics (ROADMAP hazard
    H1). Both packages normalize with the biased batch variance; flax
    (``momentum=0.9``, the JAX package's ``layers.py:76``) then updates
    ``ra_var = 0.9 ra_var + 0.1 var`` with that same biased variance, where
    torch puts in the unbiased ``var * n / (n - 1)``. The forward runs
    torch's fused ``F.batch_norm`` (statistics accumulated in float32, also
    for a bf16 input under autocast, as flax takes them on a float32 copy)
    and then rewrites the C-length running variance to flax's value.
    Eval mode is torch's own. With a process group up (at any world size)
    train mode normalizes by the global batch (``_SyncBatchNorm``) and
    writes flax's statistics of it (ROADMAP hazard H6).

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
        if pdist.is_active():
            y, mean, var = _SyncBatchNorm.apply(x, self.weight, self.bias,
                                                self.eps)
            if not self.frozen_stats:
                with torch.no_grad():
                    self.num_batches_tracked.add_(1)
                    m = self.momentum
                    self.running_mean.mul_(1.0 - m).add_(
                        m * mean.to(self.running_mean.dtype))
                    self.running_var.mul_(1.0 - m).add_(
                        m * var.to(self.running_var.dtype))
            return y
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
    Statistics are taken in float32 (float64 for a float64 input). With a
    process group up the groups are those of the global batch, and may
    span ranks (``_global_group_stats``)."""

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
            if pdist.is_active():
                mean, var, row_group = self._global_group_stats(xf)
            else:
                b, s = x.shape[0], self.num_splits
                assert b % s == 0, f"batch {b} % num_splits {s} != 0"
                g = xf.reshape((s, b // s) + tuple(x.shape[1:]))
                mean = g.mean(dim=(1, 3, 4, 5))  # (splits, C)
                var = (g - mean[:, None, :, None, None, None]).square().mean(
                    dim=(1, 3, 4, 5))
                row_group = torch.arange(s, device=x.device
                                         ).repeat_interleave(b // s)
            if not self.frozen_stats:
                with torch.no_grad():
                    agg_mean = mean.mean(0)
                    agg_var = var.mean(0) + (mean - agg_mean).square().mean(0)
                    m = self.momentum
                    self.running_mean.copy_((1 - m) * self.running_mean
                                            + m * agg_mean)
                    self.running_var.copy_((1 - m) * self.running_var
                                           + m * agg_var)
            mean = mean[row_group][..., None, None, None]
            var = var[row_group][..., None, None, None]
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight.to(xf.dtype).view(shape) + \
            self.bias.to(xf.dtype).view(shape)
        return y.to(x.dtype)

    def _global_group_stats(self, xf: torch.Tensor):
        """The groups' means and biased variances (splits, C) over the
        global batch of a process group, whose rank r holds global items
        [r b, (r + 1) b); a group may span ranks. Two passes, each one
        differentiable all-reduce. -> (mean, var, this rank's items'
        groups (b,))."""
        rank, world = pdist.get_rank(), pdist.get_world_size()
        b, s = xf.shape[0], self.num_splits
        total = b * world
        assert total % s == 0, f"global batch {total} % num_splits {s} != 0"
        per_item = xf[0, 0].numel()
        row_group = (rank * b + torch.arange(b, device=xf.device)
                     ) // (total // s)
        count = (total // s) * per_item
        zeros = xf.new_zeros((s, xf.shape[1]))
        sums = zeros.index_add(0, row_group, xf.sum(dim=(2, 3, 4)))
        with span(BN_STATS):
            sums = pdist.all_reduce_sum(sums)
        mean = sums / count
        dev = xf - mean[row_group][..., None, None, None]
        sums = zeros.index_add(0, row_group, dev.square().sum(dim=(2, 3, 4)))
        with span(BN_STATS):
            sums = pdist.all_reduce_sum(sums)
        var = sums / count
        return mean, var, row_group


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
