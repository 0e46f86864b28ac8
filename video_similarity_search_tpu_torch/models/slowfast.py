"""SlowFast and the single-pathway video ResNets in PyTorch (port of the JAX
package's ``models/slowfast.py``; reference pyslowfast
models/slowfast/slowfast/models/: stem_helper.py, resnet_helper.py,
nonlocal_helper.py, head_helper.py, video_model_builder.py).

Modules carry pyslowfast's torch names, the ones the JAX package's
``torch_slowfast_to_flax`` reads and its Caffe2 name rules produce:
``s1.pathway0_stem.conv``, ``s1_fuse.conv_f2s``,
``s2.pathway1_res0.branch2.b_bn``, ``s3.pathway0_nonlocal1.conv_theta``,
``fc1`` / ``fc2`` and the classifier's ``head.projection``. So a
pyslowfast ``state_dict``, or a converted Caffe2 one, loads without
renaming. Where pyslowfast gives a multi-pathway stage one module
(``s2`` holds ``pathway0_res*`` and ``pathway1_res*``), the JAX package
has one module a pathway; the port follows pyslowfast, and a one-pathway
``VideoModelStem`` / ``ResStage`` is the JAX module.

Public entry points take the JAX layout ``(B, T, H, W, C)``
(``multipathway_input``, ``SlowFast.forward``,
``SinglePathwayResNet.forward``); the blocks inside run ``(B, C, T, H,
W)``, where the fusion's channel concatenation is ``dim=1``. Every
BatchNorm is the port's flax-exact ``layers.BatchNorm`` (ROADMAP hazard
H1), the zero-initialised ones (bottleneck ``c_bn``, Nonlocal ``bn``)
included.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .heads import Dropout
from .layers import BatchNorm, Conv3d, global_avg_pool

# Temporal kernel basis per arch (video_model_builder.py:23-66).
TEMPORAL_KERNEL_BASIS = {
    "c2d": [[[1]], [[1]], [[1]], [[1]], [[1]]],
    "c2d_nopool": [[[1]], [[1]], [[1]], [[1]], [[1]]],
    "i3d": [[[5]], [[3]], [[3, 1]], [[3, 1]], [[1, 3]]],
    "i3d_nopool": [[[5]], [[3]], [[3, 1]], [[3, 1]], [[1, 3]]],
    "slow": [[[1]], [[1]], [[1]], [[3]], [[3]]],
    "slowfast": [[[1], [5]], [[1], [3]], [[1], [3]], [[3], [3]], [[3], [3]]],
}

# Pool after s2 per arch (video_model_builder.py:68-75).
POOL1 = {
    "c2d": [[2, 1, 1]],
    "c2d_nopool": [[1, 1, 1]],
    "i3d": [[2, 1, 1]],
    "i3d_nopool": [[1, 1, 1]],
    "slow": [[1, 1, 1]],
    "slowfast": [[1, 1, 1], [1, 1, 1]],
}

MODEL_STAGE_DEPTH = {18: (2, 2, 2, 2), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def slow_indices(t: int, alpha: int) -> np.ndarray:
    """The slow pathway's frames: JAX's ``linspace(0, t - 1, t // alpha)``
    in float32, truncated to int32 (reference models/model_utils.py:130-146
    takes ``linspace(...).long()``). jnp computes ``stop * (i / div)`` in
    float32 and sets the last point to ``stop``; a value a hair under an
    integer truncates down, so the arithmetic is reproduced exactly."""
    n = t // alpha
    if n <= 1:
        return np.zeros((n,), np.int64)
    div = np.float32(n - 1)
    step = np.arange(n - 1, dtype=np.float32) / div
    out = np.append(np.float32(t - 1) * step, np.float32(t - 1))
    return out.astype(np.int32).astype(np.int64)


def multipathway_input(frames: torch.Tensor, alpha: int,
                       fast_mask: bool = False) -> List[torch.Tensor]:
    """(B, T, H, W, C) clips -> [slow, fast] pathway inputs: fast takes all
    T frames, slow the ``T // alpha`` frames of ``slow_indices``. With
    ``fast_mask`` the 4th channel, repeated 3 times, feeds the fast
    pathway and RGB the slow one (reference model_utils.py:139-143)."""
    idx = torch.from_numpy(slow_indices(frames.shape[1], alpha)).to(
        frames.device)
    slow = frames.index_select(1, idx)
    fast = frames
    if fast_mask:
        slow = slow[..., :3]
        mask = frames[..., 3:4]
        fast = torch.cat([mask, mask, mask], dim=-1)
    return [slow, fast]


def _to_torch_layout(x: torch.Tensor) -> torch.Tensor:
    assert x.ndim == 5, f"expected (B,T,H,W,C), got {tuple(x.shape)}"
    return x.permute(0, 4, 1, 2, 3)  # channels_last_3d, no copy


class Nonlocal(nn.Module):
    """Non-local block (reference nonlocal_helper.py:10-148): 1x1x1
    ``conv_theta`` / ``conv_phi`` / ``conv_g`` to ``dim // 2`` channels
    (``phi`` and ``g`` after an optional max-pool of ``pool_size``), the
    affinity theta phi^T (``dot_product``: / N; ``softmax``: softmax of it
    x ``dim_inner ** -0.5``) taken in float32, then ``conv_out`` and a
    zero-scale ``bn``, added to the input. No convolution carries a bias,
    as in the JAX block."""

    def __init__(self, dim: int, instantiation: str = "dot_product",
                 pool_size: Optional[Sequence[int]] = None):
        super().__init__()
        assert instantiation in ("dot_product", "softmax"), instantiation
        dim_inner = dim // 2
        self.instantiation = instantiation
        self.pool_size = (tuple(pool_size) if pool_size is not None
                          and any(s > 1 for s in pool_size) else None)
        self.conv_theta = Conv3d(dim, dim_inner, 1)
        self.conv_phi = Conv3d(dim, dim_inner, 1)
        self.conv_g = Conv3d(dim, dim_inner, 1)
        self.conv_out = Conv3d(dim_inner, dim, 1)
        self.bn = BatchNorm(dim, zero_scale=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, t, h, w = x.shape
        theta = self.conv_theta(x)
        pooled = x if self.pool_size is None else F.max_pool3d(
            x, self.pool_size, self.pool_size)
        phi, g = self.conv_phi(pooled), self.conv_g(pooled)
        d = theta.shape[1]
        theta_f, phi_f, g_f = (v.flatten(2) for v in (theta, phi, g))  # (b, d, N)
        wide = torch.promote_types(theta_f.dtype, torch.float32)
        with torch.autocast(x.device.type, enabled=False):
            aff = torch.einsum("bdn,bdm->bnm", theta_f.to(wide),
                               phi_f.to(wide))
            if self.instantiation == "softmax":
                aff = torch.softmax(aff * (d ** -0.5), dim=-1)
            else:
                aff = aff / aff.shape[-1]
        out = torch.einsum("bnm,bdm->bdn", aff.to(g_f.dtype), g_f)
        out = out.reshape(b, d, t, h, w)
        return x + self.bn(self.conv_out(out))


class BasicTransform(nn.Module):
    """(T,3,3) -> (1,3,3) transform (reference resnet_helper.py:25-108)."""

    def __init__(self, dim_in: int, dim_out: int, temp_kernel_size: int,
                 stride: int):
        super().__init__()
        tk = temp_kernel_size
        self.a = Conv3d(dim_in, dim_out, (tk, 3, 3), (1, stride, stride),
                        (tk // 2, 1, 1))
        self.a_bn = BatchNorm(dim_out)
        self.b = Conv3d(dim_out, dim_out, (1, 3, 3), 1, (0, 1, 1))
        self.b_bn = BatchNorm(dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.b_bn(self.b(F.relu(self.a_bn(self.a(x)))))


class BottleneckTransform(nn.Module):
    """Tx1x1 -> 1x3x3 (grouped, dilated) -> 1x1x1 transform (reference
    resnet_helper.py:110-240); its last BatchNorm ``c_bn`` starts at zero
    scale."""

    def __init__(self, dim_in: int, dim_out: int, temp_kernel_size: int,
                 stride: int, dim_inner: int, num_groups: int = 1,
                 stride_1x1: bool = False, dilation: int = 1):
        super().__init__()
        s1, s3 = (stride, 1) if stride_1x1 else (1, stride)
        tk = temp_kernel_size
        self.a = Conv3d(dim_in, dim_inner, (tk, 1, 1), (1, s1, s1),
                        (tk // 2, 0, 0))
        self.a_bn = BatchNorm(dim_inner)
        self.b = Conv3d(dim_inner, dim_inner, (1, 3, 3), (1, s3, s3),
                        (0, dilation, dilation), groups=num_groups,
                        dilation=(1, dilation, dilation))
        self.b_bn = BatchNorm(dim_inner)
        self.c = Conv3d(dim_inner, dim_out, 1)
        self.c_bn = BatchNorm(dim_out, zero_scale=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.a_bn(self.a(x)))
        h = F.relu(self.b_bn(self.b(h)))
        return self.c_bn(self.c(h))


class ResBlock(nn.Module):
    """Residual block: shortcut (``branch1`` + ``branch1_bn`` when the
    width or the stride changes) + transform ``branch2``, then ReLU
    (reference resnet_helper.py:243-342)."""

    def __init__(self, dim_in: int, dim_out: int, temp_kernel_size: int,
                 stride: int, dim_inner: int, num_groups: int = 1,
                 trans_func: str = "bottleneck_transform",
                 dilation: int = 1):
        super().__init__()
        if dim_in != dim_out or stride != 1:
            self.branch1 = Conv3d(dim_in, dim_out, 1, (1, stride, stride))
            self.branch1_bn = BatchNorm(dim_out)
        if trans_func == "bottleneck_transform":
            self.branch2 = BottleneckTransform(
                dim_in, dim_out, temp_kernel_size, stride, dim_inner,
                num_groups, dilation=dilation)
        else:
            self.branch2 = BasicTransform(dim_in, dim_out, temp_kernel_size,
                                          stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = (self.branch1_bn(self.branch1(x))
                    if hasattr(self, "branch1") else x)
        return F.relu(shortcut + self.branch2(x))


class ResStage(nn.Module):
    """One stage over every pathway (reference resnet_helper.py:345-561):
    pathway p runs ``num_blocks`` ``pathway{p}_res{i}`` blocks, with a
    ``pathway{p}_nonlocal{i}`` block after each index in
    ``nonlocal_inds[p]``. Temporal kernels cycle through
    ``temp_kernel_sizes[p]`` for the first ``num_block_temp_kernel[p]``
    blocks (all of them when None) and are 1 after. Takes and returns a
    list of (B, C, T, H, W) tensors, one a pathway."""

    def __init__(self, dim_in: Sequence[int], dim_out: Sequence[int],
                 dim_inner: Sequence[int],
                 temp_kernel_sizes: Sequence[Sequence[int]], stride: int,
                 num_blocks: int, num_groups: int = 1,
                 num_block_temp_kernel: Optional[Sequence[int]] = None,
                 nonlocal_inds: Optional[Sequence[Sequence[int]]] = None,
                 nonlocal_pool: Optional[Sequence[int]] = None,
                 instantiation: str = "dot_product",
                 trans_func: str = "bottleneck_transform",
                 dilation: int = 1):
        super().__init__()
        self.num_pathways = len(dim_in)
        self.num_blocks = num_blocks
        self.nonlocal_inds = [tuple(v) for v in (
            nonlocal_inds or [()] * self.num_pathways)]
        for p in range(self.num_pathways):
            nbtk = (num_blocks if num_block_temp_kernel is None
                    or num_block_temp_kernel[p] is None
                    else num_block_temp_kernel[p])
            tks = ((list(temp_kernel_sizes[p]) * num_blocks)[:nbtk]
                   + [1] * (num_blocks - nbtk))
            for i in range(num_blocks):
                setattr(self, f"pathway{p}_res{i}", ResBlock(
                    dim_in[p] if i == 0 else dim_out[p], dim_out[p], tks[i],
                    stride if i == 0 else 1, dim_inner[p], num_groups,
                    trans_func, dilation))
                if i in self.nonlocal_inds[p]:
                    setattr(self, f"pathway{p}_nonlocal{i}", Nonlocal(
                        dim_out[p], instantiation, nonlocal_pool))

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        out = []
        for p, x in enumerate(xs):
            for i in range(self.num_blocks):
                x = getattr(self, f"pathway{p}_res{i}")(x)
                if i in self.nonlocal_inds[p]:
                    x = getattr(self, f"pathway{p}_nonlocal{i}")(x)
            out.append(x)
        return out


class ResNetBasicStem(nn.Module):
    """One pathway's stem: conv (T,7,7) / (1,2,2) + BN + ReLU + a (1,3,3)
    / (1,2,2) max-pool (reference stem_helper.py:9-178)."""

    def __init__(self, dim_in: int, dim_out: int, temp_kernel: int):
        super().__init__()
        tk = temp_kernel
        self.conv = Conv3d(dim_in, dim_out, (tk, 7, 7), (1, 2, 2),
                           (tk // 2, 3, 3))
        self.bn = BatchNorm(dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn(self.conv(x)))
        return F.max_pool3d(h, (1, 3, 3), (1, 2, 2), (0, 1, 1))


class VideoModelStem(nn.Module):
    """The stems of every pathway, ``pathway{p}_stem`` (reference
    stem_helper.py:9-178): a list of (B, C, T, H, W) tensors in and out."""

    def __init__(self, dim_in: Sequence[int], dim_out: Sequence[int],
                 temp_kernels: Sequence[int]):
        super().__init__()
        self.num_pathways = len(dim_in)
        for p in range(self.num_pathways):
            setattr(self, f"pathway{p}_stem",
                    ResNetBasicStem(dim_in[p], dim_out[p], temp_kernels[p]))

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        return [getattr(self, f"pathway{p}_stem")(x)
                for p, x in enumerate(xs)]


class FuseFastToSlow(nn.Module):
    """Lateral fast -> slow fusion (reference video_model_builder.py:78-137):
    ``conv_f2s`` (kernel (k,1,1), stride (alpha,1,1)) + BN + ReLU on the
    fast pathway, concatenated to the slow one on channels."""

    def __init__(self, dim_in: int, fusion_conv_channel_ratio: int,
                 fusion_kernel: int, alpha: int):
        super().__init__()
        k = fusion_kernel
        self.conv_f2s = Conv3d(dim_in, dim_in * fusion_conv_channel_ratio,
                               (k, 1, 1), (alpha, 1, 1), (k // 2, 0, 0))
        self.bn = BatchNorm(dim_in * fusion_conv_channel_ratio)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        x_s, x_f = xs
        fuse = F.relu(self.bn(self.conv_f2s(x_f)))
        return [torch.cat([x_s, fuse], dim=1), x_f]


class ClassifierHead(nn.Module):
    """``dropout`` (flax ``nn.Dropout``, mask given or drawn) then
    ``projection``, the reference ResNetBasicHead's names
    (head_helper.py:133-220)."""

    def __init__(self, dim_in: int, num_classes: int, dropout_rate: float):
        super().__init__()
        self.dropout = Dropout(dropout_rate)
        self.projection = nn.Linear(dim_in, num_classes)

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.projection(self.dropout(x, keep, generator))


class SlowFast(nn.Module):
    """Two-pathway SlowFast (reference video_model_builder.py:139-402, and
    :598-885 for the representation net with its fc1/fc2 projection).

    ``forward([slow, fast])`` with (B, T, H, W, C) pathways (see
    ``multipathway_input``) -> the ``projection2_out``-d projection with
    ``projection_head``; class logits with ``classifier`` (the dropout
    mask given as ``dropout_keep`` or drawn from ``generator``); else the
    pooled concatenation of both pathways (w*32 + w*32/beta_inv)."""

    def __init__(self, depth: int = 50, alpha: int = 4, beta_inv: int = 8,
                 fusion_conv_channel_ratio: int = 2,
                 fusion_kernel_sz: int = 7, width_per_group: int = 64,
                 num_groups: int = 1, input_channels: Tuple[int, int] = (3, 3),
                 nonlocal_location=(((), ()),) * 4,
                 nonlocal_instantiation: str = "dot_product",
                 trans_func: str = "bottleneck_transform",
                 projection_head: bool = True, projection1_out: int = 2048,
                 projection2_out: int = 128, classifier: bool = False,
                 num_classes: int = 400, dropout_rate: float = 0.5):
        super().__init__()
        depths = MODEL_STAGE_DEPTH[depth]
        w, b_inv, ratio = width_per_group, beta_inv, fusion_conv_channel_ratio
        dim_inner = num_groups * w
        tk = TEMPORAL_KERNEL_BASIS["slowfast"]
        self.projection_head, self.classifier = projection_head, classifier

        self.s1 = VideoModelStem(input_channels, (w, w // b_inv),
                                 (tk[0][0][0], tk[0][1][0]))
        self.s1_fuse = FuseFastToSlow(w // b_inv, ratio, fusion_kernel_sz,
                                      alpha)
        dims = [w + w // b_inv * ratio, w // b_inv]
        for s, n_blocks in enumerate(depths, 2):
            out = w * 4 * 2 ** (s - 2)
            inner = dim_inner * 2 ** (s - 2)
            setattr(self, f"s{s}", ResStage(
                dims, (out, out // b_inv), (inner, inner // b_inv),
                tk[s - 1], 1 if s == 2 else 2, n_blocks, num_groups,
                nonlocal_inds=nonlocal_location[s - 2],
                instantiation=nonlocal_instantiation, trans_func=trans_func))
            if s < 5:
                setattr(self, f"s{s}_fuse", FuseFastToSlow(
                    out // b_inv, ratio, fusion_kernel_sz, alpha))
                dims = [out + out // b_inv * ratio, out // b_inv]
            else:
                dims = [out, out // b_inv]
        feat = sum(dims)
        if classifier:
            self.head = ClassifierHead(feat, num_classes, dropout_rate)
        elif projection_head:
            self.fc1 = nn.Linear(feat, projection1_out)
            self.fc2 = nn.Linear(projection1_out, projection2_out)

    def forward(self, x: Sequence[torch.Tensor],
                dropout_keep: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        assert isinstance(x, (list, tuple)) and len(x) == 2, \
            "SlowFast expects [slow, fast] inputs"
        paths = self.s1_fuse(self.s1([_to_torch_layout(v) for v in x]))
        for s in range(2, 6):
            paths = getattr(self, f"s{s}")(paths)
            if s < 5:
                paths = getattr(self, f"s{s}_fuse")(paths)
        feat = torch.cat([global_avg_pool(p) for p in paths], dim=1)
        if self.classifier:
            return self.head(feat, dropout_keep, generator)
        if self.projection_head:
            return self.fc2(F.relu(self.fc1(feat)))
        return feat


class SinglePathwayResNet(nn.Module):
    """Single-pathway video ResNet, arch ``slow`` / ``i3d`` / ``c2d``
    (reference video_model_builder.py:404-596): the stem, four stages
    (``s{n}.pathway0_res{i}``), the arch's temporal max-pool after s2, the
    pooled feature and, with ``classifier``, ``head.projection`` behind
    dropout. ``forward`` takes (B, T, H, W, C)."""

    def __init__(self, arch: str = "slow", depth: int = 50,
                 width_per_group: int = 64, num_groups: int = 1,
                 input_channels: int = 3,
                 trans_func: str = "bottleneck_transform",
                 num_classes: int = 400, classifier: bool = False,
                 dropout_rate: float = 0.5):
        super().__init__()
        depths = MODEL_STAGE_DEPTH[depth]
        w = width_per_group
        tk = TEMPORAL_KERNEL_BASIS[arch]
        self.pool1 = tuple(POOL1[arch][0])
        self.classifier = classifier
        self.s1 = VideoModelStem([input_channels], [w], [tk[0][0][0]])
        dim = w
        for s, n_blocks in enumerate(depths, 2):
            out = w * 4 * 2 ** (s - 2)
            setattr(self, f"s{s}", ResStage(
                [dim], [out], [num_groups * w * 2 ** (s - 2)], tk[s - 1],
                1 if s == 2 else 2, n_blocks, num_groups,
                trans_func=trans_func))
            dim = out
        if classifier:
            self.head = ClassifierHead(dim, num_classes, dropout_rate)

    def forward(self, x: torch.Tensor,
                dropout_keep: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.s1([_to_torch_layout(x)])
        for s in range(2, 6):
            h = getattr(self, f"s{s}")(h)
            if s == 2 and any(p > 1 for p in self.pool1):
                h = [F.max_pool3d(h[0], self.pool1, self.pool1)]
        feat = global_avg_pool(h[0])
        if self.classifier:
            return self.head(feat, dropout_keep, generator)
        return feat
