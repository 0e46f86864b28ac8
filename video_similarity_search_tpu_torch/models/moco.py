"""MoCo-style InfoNCE / UberNCE for video (port of the JAX package's
``models/moco.py``; reference models/infoNCE.py:38-288).

``MoCoEncoder`` is the query encoder, the model the optimizer trains;
``MoCoBank`` holds what the reference keeps as buffers of its InfoNCE
module and the JAX package as ``MoCoState``: the key ("momentum") encoder,
the queue of L2-normalized keys, its pointer and, for UberNCE, the queue's
labels. Both carry the reference's names: the query encoder's
``encoder_q.0.*`` (S3D) and the 1x1x1 convolutions ``encoder_q.2`` /
``encoder_q.4``, and the bank's ``encoder_k.*`` and ``queue`` buffers,
which the JAX package's ``torch_moco_encoder_to_flax`` reads.

The key encoder runs in train mode, normalized by its batch's own
statistics as the JAX step's key forward is, and keeps no running
statistics: its BatchNorms run under ``layers.frozen_stats`` and
``momentum_update`` moves its parameters only, never its buffers, as the
JAX update runs over flax ``params`` and never ``batch_stats`` (ROADMAP
hazard H9).
"""

from __future__ import annotations

import copy
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import gather_rows
from ..utils.profiling import span
from .heads import S3DEmbedder
from .layers import frozen_stats


class MoCoEncoder(nn.Module):
    """S3D(-G) -> global mean pool -> 1x1x1 conv (1024 -> 1024) -> ReLU ->
    1x1x1 conv (1024 -> ``dim``) (reference models/infoNCE.py:59-72), as
    ``encoder_q``. ``forward`` takes (B, T, H, W, C) clips."""

    def __init__(self, network: str = "s3d", dim: int = 128):
        super().__init__()
        assert network in ("s3d", "s3dg"), network
        self.encoder_q = S3DEmbedder(dim, gating=network == "s3dg")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder_q(x)


def query_network(model: nn.Module) -> nn.Module:
    """The network the key encoder copies and follows: a ``MoCoEncoder``'s
    ``encoder_q``, any other encoder as it is."""
    return getattr(model, "encoder_q", model)


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


class MoCoBank(nn.Module):
    """The key encoder ``encoder_k`` (a deep copy of ``query`` at init,
    without gradients), the ``queue`` (K, dim) of L2-normalized rows drawn
    from a seeded normal, ``queue_ptr`` and, ``with_labels``,
    ``queue_labels`` (K,) at -1 (reference models/infoNCE.py:78-83; the
    JAX ``init_moco_state``)."""

    def __init__(self, query: nn.Module, K: int, dim: int,
                 with_labels: bool = False, seed: int = 7):
        super().__init__()
        self.encoder_k = copy.deepcopy(query)
        self.encoder_k.requires_grad_(False)
        gen = torch.Generator().manual_seed(seed)
        queue = torch.randn(K, dim, generator=gen)
        self.register_buffer("queue", queue / queue.norm(dim=1, keepdim=True))
        self.register_buffer("queue_ptr", torch.zeros((), dtype=torch.int64))
        if with_labels:
            self.register_buffer("queue_labels",
                                 torch.full((K,), -1, dtype=torch.int64))
        else:
            self.queue_labels = None

    def keys(self, x: torch.Tensor) -> torch.Tensor:
        """The key encoder's L2-normalized float32 embeddings of ``x``, in
        train mode without touching its running statistics, without
        gradients (span ``moco.keys``)."""
        with span("moco.keys"), torch.no_grad(), \
                frozen_stats(self.encoder_k):
            self.encoder_k.train()
            k = self.encoder_k(x)
            k = k[0] if isinstance(k, tuple) else k
            return _l2norm(k.float())

    @torch.no_grad()
    def momentum_update(self, query: nn.Module, m: float = 0.999) -> None:
        """k <- m k + (1 - m) q over the parameters (reference
        models/infoNCE.py:86-90); the buffers stay (span
        ``moco.momentum``)."""
        with span("moco.momentum"):
            for pk, pq in zip(self.encoder_k.parameters(),
                              query.parameters()):
                pk.copy_(m * pk + (1.0 - m) * pq)

    @torch.no_grad()
    def dequeue_and_enqueue(self, keys: torch.Tensor,
                            labels: Optional[torch.Tensor] = None) -> None:
        """Write ``keys`` (and ``labels``) at the pointer of the ring buffer
        and advance it (reference models/infoNCE.py:92-106); K must be a
        multiple of the batch, as the reference asserts (span
        ``moco.enqueue``)."""
        bsz, k_total = keys.shape[0], self.queue.shape[0]
        assert k_total % bsz == 0, f"queue size {k_total} % batch {bsz} != 0"
        with span("moco.enqueue"):
            slots = self.queue_ptr + torch.arange(bsz, device=keys.device)
            self.queue.index_copy_(0, slots, keys.to(self.queue.dtype))
            if labels is not None and self.queue_labels is not None:
                self.queue_labels.index_copy_(
                    0, slots, labels.to(self.queue_labels.dtype))
            self.queue_ptr.copy_((self.queue_ptr + bsz) % k_total)


def infonce_forward(encoder: nn.Module, bank: MoCoBank, x1: torch.Tensor,
                    x2: torch.Tensor, T: float = 0.07
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MoCo forward (reference models/infoNCE.py:155-200; the JAX
    ``infonce_forward`` with ``train=True``): queries of ``x1`` from
    ``encoder`` in its current mode, keys of ``x2`` from the bank's key
    encoder (``MoCoBank.keys``), both L2-normalized in float32, and the
    logits [q.k, q.queue^T] / T in float32 -> ``(logits (B, 1 + K),
    labels (B,) of zeros, keys)``. The caller does the momentum update
    and the enqueue. With a process group up ``x1`` and ``x2`` hold this
    rank's rows; the queries (with their gradient) and keys are gathered
    into the global batch, so the logits, labels and keys are the global
    batch's (the JAX step's ``axis_name`` all-gather,
    ``models/moco.py:92-101`` there)."""
    q = encoder(x1)
    q = gather_rows(_l2norm((q[0] if isinstance(q, tuple) else q).float()))
    k = gather_rows(bank.keys(x2))
    with torch.autocast(q.device.type, enabled=False):
        l_pos = (q * k).sum(dim=1, keepdim=True)
        logits = torch.cat([l_pos, q @ bank.queue.T], dim=1) / T
    labels = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    return logits, labels, k


def ubernce_forward(encoder: nn.Module, bank: MoCoBank, x1: torch.Tensor,
                    x2: torch.Tensor, batch_labels: torch.Tensor,
                    T: float = 0.07
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """UberNCE forward (reference models/infoNCE.py:203-288): the InfoNCE
    logits and a mask of the positives, column 0 (the instance's own key)
    and every queue entry whose label is the query's -> ``(logits, mask,
    keys)``. ``batch_labels`` are the global batch's (the step gathers
    them)."""
    assert bank.queue_labels is not None, "UberNCE needs a labelled queue"
    logits, _, k = infonce_forward(encoder, bank, x1, x2, T)
    mask_queue = bank.queue_labels[None, :] == batch_labels[:, None]
    mask = torch.cat([torch.ones_like(mask_queue[:, :1]), mask_queue], dim=1)
    return logits, mask, k


def moco_losses(logits: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (loss, top1, top5) as the JAX ``make_moco_train_step`` takes
    them. InfoNCE (``mask`` None): logsumexp minus the positive logit,
    top-k of column 0. UberNCE: the mean over positives of the negative
    log-softmax; top-1 whether the largest logit is a positive, top-5
    whether any of the five largest is."""
    if mask is None:
        loss = (torch.logsumexp(logits, dim=1) - logits[:, 0]).mean()
        top = logits.topk(min(5, logits.shape[1]), dim=1).indices
        hit = top == 0
        return loss, hit[:, :1].any(1).float().mean(), hit.any(1).float().mean()
    mask_f = mask.float()
    logp = F.log_softmax(logits, dim=1)
    loss = (-(logp * mask_f).sum(1) / mask_f.sum(1)).mean()
    top1 = mask_f.gather(1, logits.argmax(1, keepdim=True))[:, 0].mean()
    top = logits.topk(min(5, logits.shape[1]), dim=1).indices
    top5 = (mask_f.gather(1, top) > 0).any(1).float().mean()
    return loss, top1, top5
