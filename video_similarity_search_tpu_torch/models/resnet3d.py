"""3-D ResNet family ("3dresnet") in PyTorch (port of the JAX package's
``models/resnet3d.py``).

Parameters carry the kenshohara reference names (``conv1``, ``bn1``,
``layer{s}.{b}.conv{c}``, ``layer{s}.{b}.downsample.0/1``, ``fc1``,
``bn_proj``, ``fc2``), so a reference ``.pth.tar`` state_dict loads with
``load_state_dict`` and no key map. ``forward`` takes the JAX layout
``(B, T, H, W, C)``.

Ported: basic and bottleneck blocks, shortcuts A and B, the conv1
temporal size/stride, max-pool removal, widen factor and the projection
head. Attention, ``stem_s2d``, ``remat``, the classifier head and the
temporal-downsample head raise ``NotImplementedError`` (ROADMAP.md, queue 1,
"ResNet3D options").
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (BatchNorm, Conv3d, ProjectionHead, global_avg_pool,
                     max_pool3d)

_TODO = "not ported yet (ROADMAP.md, queue 1, 'ResNet3D options')"


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
        r = x if self.downsample is None else self.downsample(x)
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        return F.relu(h + r)


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
        r = x if self.downsample is None else self.downsample(x)
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return F.relu(h + r)


class ResNet3D(nn.Module):
    """The 3-D ResNet encoder (reference models/resnet.py:100-312).

    Input ``(B, T, H, W, C)``; returns the projection ``(B, out_dim)`` when
    ``projection_head`` is on, else the pooled backbone features."""

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
                 remat: bool = False):
        super().__init__()
        for name, on in (("attention", attention), ("stem_s2d", stem_s2d),
                         ("remat", remat), ("classifier", classifier),
                         ("predict_temporal_ds", predict_temporal_ds)):
            if on:
                raise NotImplementedError(f"ResNet3D {name}: {_TODO}")
        block_cls = BasicBlock3d if block == "basic" else Bottleneck3d
        inplanes = [int(p * widen_factor) for p in block_inplanes]
        self.no_max_pool = no_max_pool
        self.projection_head = projection_head

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
        if projection_head:
            head = ProjectionHead(in_ch, hidden_layer, out_dim)
            # the reference keeps the head's layers at the top level
            self.fc1, self.bn_proj, self.fc2 = head.fc1, head.bn_proj, head.fc2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        assert x.ndim == 5, f"expected (B,T,H,W,C), got {tuple(x.shape)}"
        h = x.permute(0, 4, 1, 2, 3)  # (B,C,T,H,W), channels_last_3d memory
        h = F.relu(self.bn1(self.conv1(h)))
        if not self.no_max_pool:
            h = max_pool3d(h)
        h = self.layer4(self.layer3(self.layer2(self.layer1(h))))
        feat = global_avg_pool(h)
        if self.projection_head:
            return ProjectionHead.forward(self, feat)
        return feat


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

