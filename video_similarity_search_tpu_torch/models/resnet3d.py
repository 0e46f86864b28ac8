"""3-D ResNet family ("3dresnet") in PyTorch (port of the JAX package's
``models/resnet3d.py``).

Parameters carry the kenshohara reference names (``conv1``, ``bn1``,
``layer{s}.{b}.conv{c}``, ``layer{s}.{b}.downsample.0/1``, ``fc1``,
``bn_proj``, ``fc2``, ``temporal_ds_linear``, and ``linear`` or, behind a
dropout, ``linear.1``), so a reference ``.pth.tar`` state_dict loads with
``load_state_dict`` and no key map. The attention blocks, which the
reference's checkpoints and the JAX package's importer do not name, are
named after the JAX package's flax modules:
``channel_temporal_attention{s}.{fc1,fc2,conv1d_1,conv1d_2}`` and
``spatio_temporal_attention{s}.{conv2d,conv3d_1,conv3d_2}``. ``forward``
takes the JAX layout ``(B, T, H, W, C)``.

Options, as in the JAX module:

* ``attention``: channel-temporal then spatio-temporal attention after
  every stage. The JAX module's spatial branch takes a real max-pool where
  the reference reused its avg-pool (reference models/resnet.py:413-414).
* ``classifier`` (with ``dropout``): class logits from the pooled features
  through ``linear`` (normal(0.01) weights, zero bias).
* ``predict_temporal_ds``: ``(projection, ds_logits)``.
* The 7x7 stem ``conv1`` runs the hand-written tensor-core kernel of
  ``ops/stem_conv.py`` on CUDA under bf16 autocast (``stem_conv.engages``
  decides from the convolution, the device and the autocast dtype);
  float32 compute, the CPU and ``stem_s2d`` call ``conv1``.
* In eval mode on CUDA with no autograd graph, each BatchNorm with the
  ReLU after it, and the residual add (shortcut B's BatchNorm included),
  run as one hand-written pass over the activation (``ops/bn_act.py``;
  ``bn_act.engages`` decides from the modules and the tensors' device,
  type and layout); train mode, the CPU, other layouts and the
  ``stem_s2d`` stem call the modules.
* ``stem_s2d``: space-to-depth and a stride-1 (kT, 4, 4) convolution over
  4C channels, equal to the 7x7 stride-2 stem (``conv1_kernel_to_s2d``
  maps its weights). Its spatial padding is (2, 1); torch pads
  symmetrically, so the convolution pads (2, 2) and the last output row
  and column, which only the extra padding reaches, are dropped.
* ``remat`` / ``remat_stages``: each residual block of those stages runs
  under ``torch.utils.checkpoint`` (non-reentrant) in training, so the
  backward pass recomputes its activations instead of keeping them. The
  recomputation leaves BatchNorm's running statistics alone (ROADMAP
  hazard H7, ``layers.py``).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import bn_act, stem_conv
from ..utils.profiling import span
from .heads import Dropout
from .layers import (BatchNorm, Conv3d, ProjectionHead, frozen_stats,
                     global_avg_pool, max_pool3d)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, T, H/2, W/2, 4C); channel index
    (py*2 + px)*C + c for the 2x2 block offset (py, px)."""
    b, t, h, w, c = x.shape
    x = x.reshape(b, t, h // 2, 2, w // 2, 2, c)
    return x.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, t, h // 2, w // 2, 4 * c)


def conv1_kernel_to_s2d(weight: torch.Tensor) -> torch.Tensor:
    """A (O, C, kT, 7, 7) stride-(1, 2, 2) stem weight -> the equal
    (O, 4C, kT, 4, 4) stride-1 weight over space-to-depth input (the JAX
    ``conv1_kernel_to_s2d`` in torch's layout): tap 2*kb + p - 1 of the
    7x7 kernel lands on 4x4 tap kb at block offset p; the taps outside
    [0, 6] are zero (one per axis)."""
    o, c, kt, kh, kw = weight.shape
    assert kh == 7 and kw == 7, "s2d transform is for the 7x7 spatial stem"
    out = weight.new_zeros(o, 4 * c, kt, 4, 4)
    for kby in range(4):
        for py in range(2):
            yy = 2 * kby + py - 1
            if not 0 <= yy <= 6:
                continue
            for kbx in range(4):
                for px in range(2):
                    xx = 2 * kbx + px - 1
                    if not 0 <= xx <= 6:
                        continue
                    ch = (py * 2 + px) * c
                    out[:, ch:ch + c, :, kby, kbx] = weight[:, :, :, yy, xx]
    return out


class _Shortcut(nn.Module):
    """Shortcut A: strided subsample + zero-pad channels (ref :212-221).
    Shortcut B (1x1x1 conv + BN, ref :230-233) is ``downsample.0/1``."""

    def __init__(self, out_ch: int, stride: int):
        super().__init__()
        self.out_ch, self.stride = out_ch, stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.stride
        out = x[:, :, ::s, ::s, ::s]
        pad = self.out_ch - x.shape[1]
        if pad > 0:
            out = F.pad(out, (0, 0, 0, 0, 0, 0, 0, pad))
        return out


def _make_downsample(in_ch: int, out_ch: int, stride: int,
                     shortcut_type: str) -> Optional[nn.Module]:
    if stride == 1 and in_ch == out_ch:
        return None
    if shortcut_type == "A":
        return _Shortcut(out_ch, stride)
    return nn.Sequential(Conv3d(in_ch, out_ch, 1, stride), BatchNorm(out_ch))


def _residual(block: nn.Module, x: torch.Tensor):
    """A block's residual -> (tensor, BatchNorm left to apply or None): x,
    or the downsample's output. Where the block's epilogue may take the
    fused pass (eval mode on CUDA, no autograd graph), shortcut B's
    BatchNorm is left to it (``bn_act.bn_relu``) and its convolution's
    output is returned."""
    ds = block.downsample
    if ds is None:
        return x, None
    if (isinstance(ds, nn.Sequential)
            and bn_act.may_engage(block, x.device.type)):
        return ds[0](x), ds[1]
    return ds(x), None


class BasicBlock3d(nn.Module):
    """Two 3x3x3 convs + residual (reference models/resnet.py:27-57)."""

    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 shortcut_type: str = "B"):
        super().__init__()
        self.conv1 = Conv3d(in_ch, planes, 3, stride)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv3d(planes, planes, 3, 1)
        self.bn2 = BatchNorm(planes)
        self.downsample = _make_downsample(in_ch, planes, stride,
                                           shortcut_type)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r, r_bn = _residual(self, x)
        h = bn_act.bn_relu(self.conv1(x), self.bn1)
        return bn_act.bn_relu(self.conv2(h), self.bn2, r, r_bn)


class Bottleneck3d(nn.Module):
    """1x1x1 -> 3x3x3 -> 1x1x1 bottleneck (reference models/resnet.py:60-96)."""

    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 shortcut_type: str = "B"):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = Conv3d(in_ch, planes, 1, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv3d(planes, planes, 3, stride)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv3d(planes, out_ch, 1, 1)
        self.bn3 = BatchNorm(out_ch)
        self.downsample = _make_downsample(in_ch, out_ch, stride,
                                           shortcut_type)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r, r_bn = _residual(self, x)
        h = bn_act.bn_relu(self.conv1(x), self.bn1)
        h = bn_act.bn_relu(self.conv2(h), self.bn2)
        return bn_act.bn_relu(self.conv3(h), self.bn3, r, r_bn)


class ChannelTemporalAttention(nn.Module):
    """Channel-temporal attention (the JAX module; reference
    models/resnet.py:317-376): spatially average- and max-pooled channel
    descriptors through a shared two-layer linear map, a sigmoid, two
    depthwise temporal convolutions (``Conv1d(groups=C)`` over (B, C, T)),
    a sigmoid, and a (T, C) mask on the input."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        self.fc1 = nn.Linear(channels, channels // reduction)
        self.fc2 = nn.Linear(channels // reduction, channels)
        self.conv1d_1 = nn.Conv1d(channels, channels, 3, padding=1,
                                  groups=channels)
        self.conv1d_2 = nn.Conv1d(channels, channels, 3, padding=1,
                                  groups=channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, T, H, W)
        d_avg = x.mean(dim=(3, 4)).transpose(1, 2)  # (B, T, C)
        d_max = x.amax(dim=(3, 4)).transpose(1, 2)
        m = torch.sigmoid(self.fc2(self.fc1(d_avg)) + self.fc2(self.fc1(d_max)))
        m = torch.sigmoid(self.conv1d_2(self.conv1d_1(m.transpose(1, 2))))
        return x * m[:, :, :, None, None]


class SpatioTemporalAttention(nn.Module):
    """Spatio-temporal attention (the JAX module; reference
    models/resnet.py:379-431): channel mean and max maps, a (1, 7, 7)
    convolution, a sigmoid, two 3x3x3 convolutions, a sigmoid, and a
    (T, H, W) mask on the input. The convolutions carry a bias."""

    def __init__(self):
        super().__init__()
        self.conv2d = Conv3d(2, 1, (1, 7, 7), bias=True)
        self.conv3d_1 = Conv3d(1, 1, 3, bias=True)
        self.conv3d_2 = Conv3d(1, 1, 3, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, T, H, W)
        m = torch.cat([x.mean(dim=1, keepdim=True),
                       x.amax(dim=1, keepdim=True)], dim=1)
        m = torch.sigmoid(self.conv2d(m))
        return x * torch.sigmoid(self.conv3d_2(self.conv3d_1(m)))


def _remat_contexts(block: nn.Module):
    """``checkpoint``'s (forward, recompute) contexts: the recomputation
    runs with the block's running statistics frozen."""
    return contextlib.nullcontext(), frozen_stats(block)


class ResNet3D(nn.Module):
    """The 3-D ResNet encoder (reference models/resnet.py:100-312).

    Input ``(B, T, H, W, C)``. Returns, as the JAX module: ``(projection,
    ds_logits)`` with ``predict_temporal_ds``; else class logits with
    ``classifier``; else the projection ``(B, out_dim)`` when
    ``projection_head`` is on, or the pooled backbone features. With
    ``classifier`` the projection head still runs (its BatchNorm
    statistics move in training, as in the JAX module)."""

    def __init__(self, block: str, layers: Sequence[int],
                 block_inplanes: Sequence[int] = (64, 128, 256, 512),
                 n_input_channels: int = 3, conv1_t_size: int = 7,
                 conv1_t_stride: int = 1, no_max_pool: bool = False,
                 shortcut_type: str = "B", widen_factor: float = 1.0,
                 hidden_layer: int = 2048, out_dim: int = 128,
                 projection_head: bool = True,
                 predict_temporal_ds: bool = False, attention: bool = False,
                 classifier: bool = False, num_classes: int = 101,
                 dropout: Optional[float] = None, stem_s2d: bool = False,
                 remat: bool = False,
                 remat_stages: Optional[Sequence[int]] = None):
        super().__init__()
        block_cls = BasicBlock3d if block == "basic" else Bottleneck3d
        inplanes = [int(p * widen_factor) for p in block_inplanes]
        self.no_max_pool = no_max_pool
        self.projection_head = projection_head
        self.predict_temporal_ds = predict_temporal_ds
        self.classifier = classifier
        self.stem_s2d = stem_s2d
        self.remat_stages = (set() if not remat else
                             set(range(1, len(layers) + 1))
                             if remat_stages is None else set(remat_stages))
        self.n_stages = len(layers)
        self.attention = attention

        if stem_s2d:
            self.conv1 = Conv3d(4 * n_input_channels, inplanes[0],
                                (conv1_t_size, 4, 4), (conv1_t_stride, 1, 1),
                                padding=(conv1_t_size // 2, 2, 2))
        else:
            self.conv1 = Conv3d(n_input_channels, inplanes[0],
                                (conv1_t_size, 7, 7), (conv1_t_stride, 2, 2))
        self.bn1 = BatchNorm(inplanes[0])
        in_ch = inplanes[0]
        for stage, (planes, blocks) in enumerate(zip(inplanes, layers), 1):
            stride = 1 if stage == 1 else 2
            stage_blocks = []
            for b in range(blocks):
                stage_blocks.append(block_cls(in_ch, planes,
                                              stride if b == 0 else 1,
                                              shortcut_type))
                in_ch = planes * block_cls.expansion
            setattr(self, f"layer{stage}", nn.Sequential(*stage_blocks))
            if attention:
                setattr(self, f"channel_temporal_attention{stage}",
                        ChannelTemporalAttention(in_ch))
                setattr(self, f"spatio_temporal_attention{stage}",
                        SpatioTemporalAttention())
        if projection_head:
            head = ProjectionHead(in_ch, hidden_layer, out_dim)
            # the reference keeps the head's layers at the top level
            self.fc1, self.bn_proj, self.fc2 = head.fc1, head.bn_proj, head.fc2
        if predict_temporal_ds:
            self.temporal_ds_linear = nn.Linear(in_ch, 4)
        elif classifier:
            linear = nn.Linear(in_ch, num_classes)
            nn.init.normal_(linear.weight, std=0.01)
            nn.init.zeros_(linear.bias)
            self.linear = (nn.Sequential(Dropout(dropout), linear)
                           if dropout is not None and dropout > 0.0
                           else linear)

    def _stage(self, stage: int, h: torch.Tensor) -> torch.Tensor:
        remat = (stage in self.remat_stages and self.training
                 and torch.is_grad_enabled())
        for block in getattr(self, f"layer{stage}"):
            if remat:
                h = checkpoint(block, h, use_reentrant=False,
                               context_fn=functools.partial(_remat_contexts,
                                                            block))
            else:
                h = block(h)
        if self.attention:
            h = getattr(self, f"channel_temporal_attention{stage}")(h)
            h = getattr(self, f"spatio_temporal_attention{stage}")(h)
        return h

    def forward(self, x: torch.Tensor,
                dropout_keep: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """``dropout_keep`` / ``generator``: the classifier's dropout mask,
        given or drawn (``heads.Dropout``)."""
        assert x.ndim == 5, f"expected (B,T,H,W,C), got {tuple(x.shape)}"
        with span("model.stem"):
            if self.stem_s2d:
                h = space_to_depth(x).permute(0, 4, 1, 2, 3)
                out_h, out_w = h.shape[-2:]
                h = F.relu(self.bn1(self.conv1(h)[..., :out_h, :out_w]))
            elif stem_conv.engages(self.conv1, x.device.type,
                                   stem_conv.autocast_dtype(x.device.type)):
                h = bn_act.bn_relu(stem_conv.stem_conv3d(x, self.conv1.weight),
                                   self.bn1)
            else:  # channels_last_3d
                h = bn_act.bn_relu(self.conv1(x.permute(0, 4, 1, 2, 3)),
                                   self.bn1)
            if not self.no_max_pool:
                h = max_pool3d(h)
        for stage in range(1, self.n_stages + 1):
            h = self._stage(stage, h)
        feat = global_avg_pool(h)
        proj = (ProjectionHead.forward(self, feat) if self.projection_head
                else None)
        if self.predict_temporal_ds:
            return proj, self.temporal_ds_linear(feat)
        if self.classifier:
            if isinstance(self.linear, nn.Sequential):
                feat = self.linear[0](feat, keep=dropout_keep,
                                      generator=generator)
                return self.linear[1](feat)
            return self.linear(feat)
        return proj if self.projection_head else feat


_DEPTH_TO_SPEC = {
    10: ("basic", (1, 1, 1, 1)),
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
    200: ("bottleneck", (3, 24, 36, 3)),
}


def generate_model(model_depth: int, **kwargs) -> ResNet3D:
    """Depth -> model (reference models/resnet.py:436-456)."""
    assert model_depth in _DEPTH_TO_SPEC, f"unsupported depth {model_depth}"
    block, layers = _DEPTH_TO_SPEC[model_depth]
    return ResNet3D(block=block, layers=layers, **kwargs)


def backbone_feature_dim(model_depth: int, widen_factor: float = 1.0) -> int:
    """Width of the pooled backbone feature (before the projection head)."""
    block, _ = _DEPTH_TO_SPEC[model_depth]
    expansion = 1 if block == "basic" else 4
    return int(512 * widen_factor) * expansion

