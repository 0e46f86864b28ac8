"""Plain PyTorch reference encoders: R3D-18 (Hara et al., 3D-ResNets;
SLIC's shortcut-B variant with a 7x7x7 stride-(1, 2, 2) stem, no max-pool
and a 2048 -> 128 projection head) and SlowFast-50 (Feichtenhofer et al.,
ICCV 2019: ResNet-50 slow pathway, beta = 1/8 fast channels, lateral
fusion by a (7, 1, 1) stride-alpha convolution of ratio 2, an fc1 -> ReLU
-> fc2 projection head).

Built only from ``torch.nn`` layers, with the parameter names of the
published code bases (kenshohara's 3D-ResNets; pyslowfast), so one state
dict, made by the benchmark from the seed, loads into both the program
and this reference. Inputs are (B, T, H, W, C) clips; SlowFast takes the
[slow, fast] pathway list.

``quant``: a function applied to every convolution's and dense layer's
input and weight (the control's lower precision, ``precision.py``); None
computes in the input's own precision.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class _Quant:
    """Shared switch: the precision function of the layers below."""

    fn: Optional[Callable] = None


class Conv3d(nn.Conv3d):
    def __init__(self, cin, cout, k, stride=1, pad=None, quant=None):
        k = (k, k, k) if isinstance(k, int) else tuple(k)
        stride = (stride,) * 3 if isinstance(stride, int) else tuple(stride)
        pad = tuple(d // 2 for d in k) if pad is None else tuple(pad)
        super().__init__(cin, cout, k, stride, pad, bias=False)
        self.quant = quant

    def forward(self, x):
        q = self.quant.fn
        if q is None:
            return super().forward(x)
        return F.conv3d(q(x), q(self.weight), None, self.stride,
                        self.padding)


class Linear(nn.Linear):
    def __init__(self, cin, cout, quant=None):
        super().__init__(cin, cout)
        self.quant = quant

    def forward(self, x):
        q = self.quant.fn
        if q is None:
            return super().forward(x)
        return F.linear(q(x), q(self.weight), self.bias)


def _bn(c: int) -> nn.BatchNorm3d:
    return nn.BatchNorm3d(c, eps=1e-5, momentum=0.1)


class _Model(nn.Module):
    """Base: a precision switch shared by every layer."""

    def __init__(self):
        super().__init__()
        self._quant = _Quant()

    def set_quant(self, fn: Optional[Callable]) -> None:
        self._quant.fn = fn


class BasicBlock(nn.Module):
    def __init__(self, cin, planes, stride, quant):
        super().__init__()
        self.conv1 = Conv3d(cin, planes, 3, stride, quant=quant)
        self.bn1 = _bn(planes)
        self.conv2 = Conv3d(planes, planes, 3, 1, quant=quant)
        self.bn2 = _bn(planes)
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(
                Conv3d(cin, planes, 1, stride, quant=quant), _bn(planes))
        else:
            self.downsample = None

    def forward(self, x):
        r = x if self.downsample is None else self.downsample(x)
        h = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(h)) + r)


class R3D18(_Model):
    """R3D-18 as SLIC trains it (shortcut B, conv1 7/1, no max-pool)."""

    def __init__(self, in_ch: int = 3, hidden: int = 2048, out_dim: int = 128,
                 widths=(64, 128, 256, 512)):
        super().__init__()
        q = self._quant
        self.conv1 = Conv3d(in_ch, widths[0], (7, 7, 7), (1, 2, 2), quant=q)
        self.bn1 = _bn(widths[0])
        cin = widths[0]
        for s, w in enumerate(widths, 1):
            stride = 1 if s == 1 else 2
            setattr(self, f"layer{s}", nn.Sequential(
                BasicBlock(cin, w, stride, q), BasicBlock(w, w, 1, q)))
            cin = w
        self.fc1 = Linear(cin, hidden, quant=q)
        self.bn_proj = nn.BatchNorm1d(hidden, eps=1e-5, momentum=0.1)
        self.fc2 = Linear(hidden, out_dim, quant=q)

    def forward(self, x):
        h = x.permute(0, 4, 1, 2, 3).contiguous()
        h = F.relu(self.bn1(self.conv1(h)))
        for s in range(1, 5):
            h = getattr(self, f"layer{s}")(h)
        feat = h.mean(dim=(2, 3, 4))
        return self.fc2(F.relu(self.bn_proj(self.fc1(feat))))


class Bottleneck(nn.Module):
    """pyslowfast's BottleneckTransform (Tx1x1 -> 1x3x3 -> 1x1x1) inside
    a ResBlock with a projection shortcut when the shape changes."""

    def __init__(self, cin, cout, inner, tk, stride, quant):
        super().__init__()
        if cin != cout or stride != 1:
            self.branch1 = Conv3d(cin, cout, 1, (1, stride, stride),
                                  quant=quant)
            self.branch1_bn = _bn(cout)
        b2 = nn.Module()
        b2.a = Conv3d(cin, inner, (tk, 1, 1), 1, (tk // 2, 0, 0), quant=quant)
        b2.a_bn = _bn(inner)
        b2.b = Conv3d(inner, inner, (1, 3, 3), (1, stride, stride),
                      (0, 1, 1), quant=quant)
        b2.b_bn = _bn(inner)
        b2.c = Conv3d(inner, cout, 1, 1, quant=quant)
        b2.c_bn = _bn(cout)
        self.branch2 = b2

    def forward(self, x):
        b2 = self.branch2
        h = F.relu(b2.a_bn(b2.a(x)))
        h = F.relu(b2.b_bn(b2.b(h)))
        h = b2.c_bn(b2.c(h))
        sc = (self.branch1_bn(self.branch1(x)) if hasattr(self, "branch1")
              else x)
        return F.relu(sc + h)


class SlowFast50(_Model):
    """SlowFast-50 (alpha 4, beta 1/8, fusion ratio 2 and kernel 7)."""

    # temporal kernel of the stem and of each stage's bottlenecks, per
    # pathway [slow, fast] (pyslowfast's _TEMPORAL_KERNEL_BASIS)
    TK = [[1, 5], [1, 3], [1, 3], [3, 3], [3, 3]]
    DEPTHS = (3, 4, 6, 3)

    def __init__(self, alpha: int = 4, beta_inv: int = 8, ratio: int = 2,
                 fuse_k: int = 7, width: int = 64, in_ch: int = 3,
                 hidden: int = 2048, out_dim: int = 128):
        super().__init__()
        q = self._quant
        self.alpha = alpha
        w, fw = width, width // beta_inv
        s1 = nn.Module()
        for p, (c, tk) in enumerate(zip((w, fw), self.TK[0])):
            stem = nn.Module()
            stem.conv = Conv3d(in_ch, c, (tk, 7, 7), (1, 2, 2),
                               (tk // 2, 3, 3), quant=q)
            stem.bn = _bn(c)
            setattr(s1, f"pathway{p}_stem", stem)
        self.s1 = s1
        self.s1_fuse = self._fuse(fw, ratio, fuse_k, alpha, q)
        dims = [w + fw * ratio, fw]
        for s, n in enumerate(self.DEPTHS, 2):
            out, inner = w * 4 * 2 ** (s - 2), w * 2 ** (s - 2)
            outs, inners = (out, out // beta_inv), (inner, inner // beta_inv)
            stage = nn.Module()
            for p in range(2):
                for i in range(n):
                    setattr(stage, f"pathway{p}_res{i}", Bottleneck(
                        dims[p] if i == 0 else outs[p], outs[p], inners[p],
                        self.TK[s - 1][p], (1 if s == 2 else 2) if i == 0
                        else 1, q))
            setattr(self, f"s{s}", stage)
            if s < 5:
                setattr(self, f"s{s}_fuse",
                        self._fuse(outs[1], ratio, fuse_k, alpha, q))
                dims = [out + outs[1] * ratio, outs[1]]
            else:
                dims = list(outs)
        self.fc1 = Linear(sum(dims), hidden, quant=q)
        self.fc2 = Linear(hidden, out_dim, quant=q)

    @staticmethod
    def _fuse(c, ratio, k, alpha, q) -> nn.Module:
        m = nn.Module()
        m.conv_f2s = Conv3d(c, c * ratio, (k, 1, 1), (alpha, 1, 1),
                            (k // 2, 0, 0), quant=q)
        m.bn = _bn(c * ratio)
        return m

    @staticmethod
    def _apply_fuse(m, xs):
        slow, fast = xs
        f = F.relu(m.bn(m.conv_f2s(fast)))
        return [torch.cat([slow, f], dim=1), fast]

    def forward(self, x: List[torch.Tensor]):
        paths = [v.permute(0, 4, 1, 2, 3).contiguous() for v in x]
        out = []
        for p, h in enumerate(paths):
            stem = getattr(self.s1, f"pathway{p}_stem")
            h = F.relu(stem.bn(stem.conv(h)))
            out.append(F.max_pool3d(h, (1, 3, 3), (1, 2, 2), (0, 1, 1)))
        paths = self._apply_fuse(self.s1_fuse, out)
        for s, n in enumerate(self.DEPTHS, 2):
            stage = getattr(self, f"s{s}")
            new = []
            for p, h in enumerate(paths):
                for i in range(n):
                    h = getattr(stage, f"pathway{p}_res{i}")(h)
                new.append(h)
            paths = new
            if s < 5:
                paths = self._apply_fuse(getattr(self, f"s{s}_fuse"), paths)
        feat = torch.cat([h.mean(dim=(2, 3, 4)) for h in paths], dim=1)
        return self.fc2(F.relu(self.fc1(feat)))


def slow_fast_input(clips: torch.Tensor, alpha: int) -> List[torch.Tensor]:
    """[slow, fast] pathways of (B, T, H, W, C) clips: the fast pathway
    takes every frame, the slow one T / alpha frames evenly spaced from the
    first to the last (pyslowfast's PackPathway: linspace(0, T - 1,
    T // alpha), truncated to integers)."""
    t = clips.shape[1]
    n = t // alpha
    idx = torch.linspace(0, t - 1, n, dtype=torch.float64).long()
    return [clips.index_select(1, idx.to(clips.device)), clips]


def build(arch: str) -> _Model:
    """``r3d18`` or ``slowfast50`` at the published widths."""
    return {"r3d18": R3D18, "slowfast50": SlowFast50}[arch]()


def stems(model: _Model) -> list:
    """The layers whose input is the clip itself (no input gradient)."""
    if isinstance(model, R3D18):
        return [model.conv1]
    return [model.s1.pathway0_stem.conv, model.s1.pathway1_stem.conv]
