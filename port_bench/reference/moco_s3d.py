"""Plain reference of MoCo UberNCE pretraining over S3D: the query encoder
(S3D, global mean pool, 1x1x1 convolution 1024 -> 1024, ReLU, 1x1x1
convolution 1024 -> 128), its key encoder, the labelled queue, the UberNCE
logits, mask and loss at T 0.07, Adam with coupled weight decay, the
momentum update (m 0.999) and the enqueue.

Sources: S3D, Xie et al., Rethinking Spatiotemporal Feature Learning
(arXiv:1712.04851), as CoCLR's ``models/s3d/s3dg.py`` builds it (Conv_1a,
Conv_2b, Conv_2c, Mixed_3b-5c, the four max-pools between its stages);
MoCo, He et al. (arXiv:1911.05722); UberNCE, Han, Xie and Zisserman,
CoCLR (arXiv:2010.09709). Parameter names are those of CoCLR's
``InfoNCE`` module (``encoder_q.0.*`` the backbone, ``encoder_q.2`` and
``encoder_q.4`` the head), so one seeded state dict loads here and into the
program. Inputs are (B, T, H, W, C) clips.

Departures from the published description:

* the order within a step is the repository's: the keys come from the key
  encoder as it stands before the step, and the momentum update follows
  the optimizer step, from the updated query parameters; published MoCo
  and CoCLR update the key encoder first and then compute the keys;
* every BatchNorm has eps 1e-5 (the repository's); CoCLR's ``s3dg.py``
  builds them with eps 1e-3;
* the key encoder normalizes by its batch's statistics, with no shuffled
  BatchNorm (one device);
* padding is symmetric (``k // 2``), as CoCLR's PyTorch code pads, not
  TensorFlow's ``SAME`` of the original S3D.

``quant``: applied to every convolution's input and weight (the control's
lower precision: ``bf16`` below, or ``precision.py``'s fp8); None computes
in float32 (TF32 off).
``fault`` computes a known-wrong step (the calibration's upper readings):
``no_momentum`` skips the momentum update, ``no_enqueue`` the enqueue,
``query_keys`` takes the keys from the query encoder, and ``no_labels``
ignores the queue's labels (InfoNCE).
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .models import Conv3d, _Model
from .triplet import augment, draw_params

T_MOCO, M_MOCO = 0.07, 0.999
BETAS, ADAM_EPS = (0.9, 0.999), 1e-8
FAULTS = ("no_momentum", "no_enqueue", "query_keys", "no_labels")

# (name, [b0, b1a, b1b, b2a, b2b, b3b]) of each Inception block
MIXED = (
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


class _BF16(torch.autograd.Function):
    """Rounds to bfloat16 in the forward and the incoming gradient to
    bfloat16 in the backward; the products then run in float32 on the
    rounded values."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """The precision below float32 that the program can run in (its
    ``TPU.COMPUTE_DTYPE`` bfloat16), put on every convolution's input and
    weight: the control of a float32 configuration."""
    return _BF16.apply(x)


def _bn(c: int) -> nn.BatchNorm3d:
    return nn.BatchNorm3d(c, eps=1e-5, momentum=0.1)


class BasicConv3d(nn.Module):
    """conv -> BN -> ReLU."""

    def __init__(self, cin, cout, k, stride, pad, quant):
        super().__init__()
        self.conv = Conv3d(cin, cout, k, stride, (pad,) * 3, quant=quant)
        self.bn = _bn(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class STConv3d(nn.Module):
    """(1, k, k) conv -> BN -> ReLU -> (k, 1, 1) conv -> BN -> ReLU; the
    stride strides space in the first and time in the second."""

    def __init__(self, cin, cout, k, stride, pad, quant):
        super().__init__()
        self.conv1 = Conv3d(cin, cout, (1, k, k), (1, stride, stride),
                            (0, pad, pad), quant=quant)
        self.bn1 = _bn(cout)
        self.conv2 = Conv3d(cout, cout, (k, 1, 1), (stride, 1, 1),
                            (pad, 0, 0), quant=quant)
        self.bn2 = _bn(cout)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


class SepInception(nn.Module):
    """Four branches, concatenated on channels: 1x1x1; 1x1x1 -> separable
    3x3x3; 1x1x1 -> separable 3x3x3; 3x3x3 max-pool -> 1x1x1."""

    def __init__(self, cin, planes, quant):
        super().__init__()
        b0, b1a, b1b, b2a, b2b, b3b = planes
        self.branch0 = nn.Sequential(BasicConv3d(cin, b0, 1, 1, 0, quant))
        self.branch1 = nn.Sequential(BasicConv3d(cin, b1a, 1, 1, 0, quant),
                                     STConv3d(b1a, b1b, 3, 1, 1, quant))
        self.branch2 = nn.Sequential(BasicConv3d(cin, b2a, 1, 1, 0, quant),
                                     STConv3d(b2a, b2b, 3, 1, 1, quant))
        self.branch3 = nn.Sequential(nn.MaxPool3d(3, 1, 1),
                                     BasicConv3d(cin, b3b, 1, 1, 0, quant))
        self.out_channels = b0 + b1b + b2b + b3b

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                          self.branch3(x)], dim=1)


class S3D(nn.Module):
    """(B, C, T, H, W) -> (B, 1024, T/8, H/32, W/32)."""

    def __init__(self, quant):
        super().__init__()
        self.Conv_1a = STConv3d(3, 64, 7, 2, 3, quant)
        self.Conv_2b = BasicConv3d(64, 64, 1, 1, 0, quant)
        self.Conv_2c = STConv3d(64, 192, 3, 1, 1, quant)
        cin = 192
        for name, planes in MIXED:
            setattr(self, name, SepInception(cin, planes, quant))
            cin = getattr(self, name).out_channels

    def forward(self, x):
        x = F.max_pool3d(self.Conv_1a(x), (1, 3, 3), (1, 2, 2), (0, 1, 1))
        x = self.Conv_2c(self.Conv_2b(x))
        x = F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        x = self.Mixed_3c(self.Mixed_3b(x))
        x = F.max_pool3d(x, 3, 2, 1)
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e",
                     "Mixed_4f"):
            x = getattr(self, name)(x)
        x = F.max_pool3d(x, 2, 2)
        return self.Mixed_5c(self.Mixed_5b(x))


class HeadConv(nn.Conv3d):
    """1x1x1 convolution with a bias (the MoCo head)."""

    def __init__(self, cin, cout, quant):
        super().__init__(cin, cout, 1)
        self.quant = quant

    def forward(self, x):
        q = self.quant.fn
        if q is None:
            return super().forward(x)
        return F.conv3d(q(x), q(self.weight), self.bias)


class MoCoS3D(_Model):
    """The query encoder: ``encoder_q`` = [S3D, pool, conv, ReLU, conv,
    flatten]; ``forward`` takes (B, T, H, W, C) clips and gives the
    unnormalized (B, 128) embeddings."""

    def __init__(self, dim: int = 128):
        super().__init__()
        q = self._quant
        self.encoder_q = nn.Sequential(
            S3D(q), nn.AdaptiveAvgPool3d(1), HeadConv(1024, 1024, q),
            nn.ReLU(), HeadConv(1024, dim, q), nn.Flatten(1))

    def forward(self, x):
        return self.encoder_q(x.permute(0, 4, 1, 2, 3).contiguous())


def stems(model: MoCoS3D) -> list:
    """The layer whose input is the clip itself (no input gradient)."""
    return [model.encoder_q[0].Conv_1a.conv1]


def l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)


def ubernce(q: torch.Tensor, k: torch.Tensor, queue: torch.Tensor,
            queue_labels: torch.Tensor, labels: torch.Tensor,
            use_labels: bool = True):
    """-> (logits (B, 1 + K), loss): [q.k, q.queue^T] / T over unit rows;
    the positives are column 0 and every queue entry of the query's label;
    the loss is the mean over rows of the mean negative log-softmax over
    the row's positives."""
    logits = torch.cat([(q * k).sum(1, keepdim=True), q @ queue.T],
                       dim=1) / T_MOCO
    same = queue_labels[None, :] == labels[:, None]
    if not use_labels:
        same = torch.zeros_like(same)
    mask = torch.cat([torch.ones_like(same[:, :1]), same], dim=1).float()
    logp = F.log_softmax(logits, dim=1)
    loss = (-(logp * mask).sum(1) / mask.sum(1)).mean()
    return logits, loss


def run_steps(state: Dict[str, torch.Tensor], queue: torch.Tensor,
              queue_labels: torch.Tensor,
              batches: List[Dict[str, torch.Tensor]], seeds: List[int],
              spec: dict, device: torch.device,
              quant: Optional[Callable] = None,
              fault: Optional[str] = None) -> dict:
    """Steps of the reference from the query encoder's ``state`` (the key
    encoder starts as its copy) and the queue over ``batches`` (uint8
    ``anchor`` and ``positive`` views on ``device`` and ``labels``), each
    step's generator seeded from ``seeds`` for the two views' augmentation
    draws; a batch that holds ``x1`` and ``x2`` gives the views as they
    are. ``spec``: size, dataset, lr, wd, and ``dtype`` (float32 when
    absent) of the encoders; the embeddings, logits and queue are float32
    in every case. -> the first step's logits,
    each step's loss, the enqueued keys of every step, each parameter's
    gradient norm in every step and in the first (the gradient that Adam
    takes: with the decay added), the norm of each key-encoder
    parameter's change, both encoders' parameters at the end, and the
    queue's labels and pointer at the end."""
    assert fault is None or fault in FAULTS, fault
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = spec.get("dtype", torch.float32)
    model = MoCoS3D().to(device, dtype)
    model.load_state_dict(state)
    model.train()
    key = copy.deepcopy(model)
    key.requires_grad_(False)
    model.set_quant(quant)
    key.set_quant(quant)
    params = dict(model.named_parameters())
    kparams = dict(key.named_parameters())
    kstart = {n: p.detach().clone() for n, p in kparams.items()}
    queue = queue.to(device).float().clone()
    queue_labels = queue_labels.to(device).long().clone()
    ptr, big_k = 0, queue.shape[0]
    m1 = {n: torch.zeros_like(p) for n, p in params.items()}
    m2 = {n: torch.zeros_like(p) for n, p in params.items()}
    lr, wd = spec["lr"], spec["wd"]
    losses, grads, keys = [], [], []
    g = torch.Generator(device=device)
    for t, (batch, seed) in enumerate(zip(batches, seeds), 1):
        if "x1" in batch:
            x1, x2 = batch["x1"], batch["x2"]
        else:
            g.manual_seed(seed)
            x1, x2 = (augment(batch[v], draw_params(g, batch[v].shape[0]),
                              spec["size"], spec["dataset"])
                      for v in ("anchor", "positive"))
        x1, x2 = x1.to(device, dtype), x2.to(device, dtype)
        labels = batch["labels"].to(device).long()
        q = l2norm(model(x1).float())
        with torch.no_grad():
            k = l2norm((model if fault == "query_keys" else key)(x2).float())
        logits, loss = ubernce(q, k, queue, queue_labels, labels,
                               use_labels=fault != "no_labels")
        if t == 1:
            logits1 = logits.detach().cpu()
        model.zero_grad(set_to_none=True)
        loss.backward()
        losses.append(float(loss.detach()))
        with torch.no_grad():
            step = {}
            for n, p in params.items():
                grad = p.grad + wd * p  # coupled weight decay
                step[n] = float(grad.norm())
                m1[n].mul_(BETAS[0]).add_((1 - BETAS[0]) * grad)
                m2[n].mul_(BETAS[1]).add_((1 - BETAS[1]) * grad * grad)
                mhat = m1[n] / (1 - BETAS[0] ** t)
                vhat = m2[n] / (1 - BETAS[1] ** t)
                p.sub_(lr * mhat / (vhat.sqrt() + ADAM_EPS))
            grads.append(step)
            if fault != "no_momentum":
                for n, pk in kparams.items():
                    pk.copy_(M_MOCO * pk + (1 - M_MOCO) * params[n])
            if fault != "no_enqueue":
                b = k.shape[0]
                queue[ptr:ptr + b] = k
                queue_labels[ptr:ptr + b] = labels
                ptr = (ptr + b) % big_k
        keys.append(k.detach().cpu())
    change = {n: float((p - kstart[n]).norm()) for n, p in kparams.items()}
    return {"loss": losses, "logits1": logits1, "keys": torch.cat(keys),
            "grads": grads, "grad1": grads[0], "key_change": change,
            "query": {n: p.detach().cpu() for n, p in params.items()},
            "key": {n: p.detach().cpu() for n, p in kparams.items()},
            "queue_labels": queue_labels.cpu(), "queue_ptr": ptr}
