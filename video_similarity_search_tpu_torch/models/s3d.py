"""S3D / S3D-G separable 3-D Inception backbone in PyTorch (port of the JAX
package's ``models/s3d.py``; reference models/s3d/s3dg.py:8-217).

Parameters carry the reference's torch names (``Conv_1a.conv1.weight``,
``Mixed_3b.branch1.1.conv2.weight``, ``Mixed_3b.branch3.1.conv.weight``,
``Mixed_4b.gating_b0.fc.weight``), so the JAX package's importer
``torch_s3d_backbone_to_flax`` reads the port's ``state_dict`` as it reads a
reference checkpoint. The reference registers each block twice (directly
and through ``block1`` ... ``block5`` Sequentials); the port keeps the
direct names only, and ``train/checkpoint.py::load_torch_checkpoint`` maps
the aliases of a reference file onto them.

``S3D.forward`` takes the JAX layout ``(B, T, H, W, C)`` and returns the
``(B, 1024, T/8, H/32, W/32)`` feature map in torch's layout (the heads
pool it). Every BatchNorm is the port's ``layers.BatchNorm`` (eps 1e-5,
torch momentum 0.1, flax's running variance in train mode); convolutions
carry no bias, ``SelfGating.fc`` does.

Where ``stem_wgrad.engages`` (float32 on CUDA, the stem's weight taking a
gradient and the clip none), the stem's ``Conv_1a.conv1`` runs through
``ops/stem_wgrad.py``'s Function: the same forward, and the weight
gradient of the hand-written kernel ``csrc/stem_wgrad_f32.cu``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import stem_wgrad
from ..ops.stem_conv import autocast_dtype
from ..utils.profiling import span
from .layers import BatchNorm, Conv3d, IntOr3


class BasicConv3d(nn.Module):
    """conv + BN + ReLU (reference models/s3d/s3dg.py:8-28)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: IntOr3 = 1,
                 stride: IntOr3 = 1, padding: IntOr3 = 0):
        super().__init__()
        self.conv = Conv3d(in_ch, out_ch, kernel_size, stride, padding)
        self.bn = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class STConv3d(nn.Module):
    """Separable spatio-temporal conv: (1,k,k) then (k,1,1), each + BN +
    ReLU (reference models/s3d/s3dg.py:30-65); ``stride`` strides space in
    the first and time in the second."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        k, p, s = kernel_size, padding, stride
        self.conv1 = Conv3d(in_ch, out_ch, (1, k, k), (1, s, s), (0, p, p))
        self.bn1 = BatchNorm(out_ch)
        self.conv2 = Conv3d(out_ch, out_ch, (k, 1, 1), (s, 1, 1), (p, 0, 0))
        self.bn2 = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the rule takes S3D's RGB stem alone (3 channels, (1, 7, 7), stride
        # (1, 2, 2)); every other conv1 keeps nn.Conv3d
        routed = stem_wgrad.engages(self.conv1, x,
                                    autocast_dtype(x.device.type))
        x = (stem_wgrad.StemWgradF32.apply(x, self.conv1.weight) if routed
             else self.conv1(x))
        x = F.relu(self.bn1(x))
        return F.relu(self.bn2(self.conv2(x)))


class SelfGating(nn.Module):
    """S3D-G feature gating: sigmoid(fc(mean over T, H, W)) * x
    (reference :68-78)."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = torch.sigmoid(self.fc(x.mean(dim=(2, 3, 4))))  # (B, C)
        return w[:, :, None, None, None] * x


class SepInception(nn.Module):
    """4-branch separable Inception block (reference :81-132);
    ``out_planes`` = [b0, b1a, b1b, b2a, b2b, b3b]."""

    def __init__(self, in_ch: int, out_planes: Sequence[int],
                 gating: bool = False):
        super().__init__()
        b0, b1a, b1b, b2a, b2b, b3b = out_planes
        self.branch0 = nn.Sequential(BasicConv3d(in_ch, b0))
        self.branch1 = nn.Sequential(BasicConv3d(in_ch, b1a),
                                     STConv3d(b1a, b1b, 3, 1, 1))
        self.branch2 = nn.Sequential(BasicConv3d(in_ch, b2a),
                                     STConv3d(b2a, b2b, 3, 1, 1))
        # flax's max_pool pads with -inf, as F.max_pool3d does
        self.branch3 = nn.Sequential(nn.MaxPool3d(3, 1, 1),
                                     BasicConv3d(in_ch, b3b))
        self.gating = gating
        if gating:
            for i, c in enumerate((b0, b1b, b2b, b3b)):
                setattr(self, f"gating_b{i}", SelfGating(c))
        self.out_channels = b0 + b1b + b2b + b3b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [self.branch0(x), self.branch1(x), self.branch2(x),
                self.branch3(x)]
        if self.gating:
            outs = [getattr(self, f"gating_b{i}")(o) for i, o in enumerate(outs)]
        return torch.cat(outs, dim=1)  # flax concatenates on its last axis


# name -> (out_planes) of each Inception block, in order (reference
# s3dg.py:160-197)
_MIXED = (
    ("Mixed_3b", (64, 96, 128, 16, 32, 32)),
    ("Mixed_3c", (128, 128, 192, 32, 96, 64)),
    ("Mixed_4b", (192, 96, 208, 16, 48, 64)),
    ("Mixed_4c", (160, 112, 224, 24, 64, 64)),
    ("Mixed_4d", (128, 128, 256, 24, 64, 64)),
    ("Mixed_4e", (112, 144, 288, 32, 64, 64)),
    ("Mixed_4f", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5b", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5c", (384, 192, 384, 48, 128, 128)),
)


class S3D(nn.Module):
    """Full S3D(-G) backbone (reference models/s3d/s3dg.py:135-217).
    (B, T, H, W, C) -> (B, 1024, T/8, H/32, W/32)."""

    def __init__(self, input_channel: int = 3, gating: bool = False):
        super().__init__()
        self.Conv_1a = STConv3d(input_channel, 64, 7, 2, 3)
        self.Conv_2b = BasicConv3d(64, 64)
        self.Conv_2c = STConv3d(64, 192, 3, 1, 1)
        in_ch = 192
        for name, planes in _MIXED:
            block = SepInception(in_ch, planes, gating)
            setattr(self, name, block)
            in_ch = block.out_channels
        self.out_channels = in_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        assert x.ndim == 5, f"expected (B,T,H,W,C), got {tuple(x.shape)}"
        shape = tuple(x.shape)
        h = x.permute(0, 4, 1, 2, 3)  # (B,C,T,H,W), channels_last_3d memory
        with span("model.stem"):
            h = self.Conv_1a(h)
            h = F.max_pool3d(h, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        h = self.Conv_2c(self.Conv_2b(h))
        h = F.max_pool3d(h, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        h = self.Mixed_3c(self.Mixed_3b(h))
        h = F.max_pool3d(h, 3, 2, 1)
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e",
                     "Mixed_4f"):
            h = getattr(self, name)(h)
        # the block5 pool (2, stride 2) leaves 0 of a dimension below 2
        assert all(d >= 2 for d in h.shape[2:]), (
            f"S3D input {shape} too small: a dimension collapsed to 0 "
            "after the block5 pool (need T>=8 and H,W>=32)")
        h = F.max_pool3d(h, 2, 2)
        return self.Mixed_5c(self.Mixed_5b(h))


def select_backbone(network: str, first_channel: int = 3):
    """Name -> (model, feature_dim) (reference
    models/s3d/select_backbone.py:3-12)."""
    if network == "s3d":
        return S3D(input_channel=first_channel, gating=False), 1024
    if network == "s3dg":
        return S3D(input_channel=first_channel, gating=True), 1024
    raise ValueError(f"unknown backbone {network!r}")
