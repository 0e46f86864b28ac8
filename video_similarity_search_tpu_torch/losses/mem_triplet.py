"""Triplet loss against a labelled FIFO memory bank (port of the JAX
package's ``losses/mem_triplet.py``; reference ``MemTripletLoss``,
loss/triplet_loss.py:9-81).

The bank is ``queue`` (K, D), ``label_q`` (K,) and ``queue_ptr``, held as
registered buffers of ``MemTripletLoss`` as the reference's module held
them, so they travel with ``state_dict()`` into checkpoints. Each call
enqueues the batch (detached) BEFORE the distances are taken, so the batch
takes part as queue entries; a positive is addressed at its just-enqueued
slot and the negatives are the queue slots whose label differs, picked by
the in-batch miner's ``select_negative_indices`` over the K slots. The
random draws of the random strategies are injected as ``noise`` (A, P, K)
Gumbel, or drawn from ``generator`` (ROADMAP hazard H2).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.pdist import pairwise_distance
from .triplet import select_negative_indices


class MemTripletLoss(nn.Module):
    """The K-slot labelled bank and its loss. ``seed`` draws the initial
    queue (unit-norm Gaussian rows, as the JAX ``init_mem_triplet_state``)
    from a CPU generator; labels start at -1."""

    def __init__(self, K: int = 40, dim: int = 128, seed: int = 9):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        q = torch.randn(K, dim, generator=gen)
        self.register_buffer("queue", q / q.norm(dim=1, keepdim=True))
        self.register_buffer("label_q", torch.full((K,), -1, dtype=torch.int64))
        self.register_buffer("queue_ptr", torch.zeros((), dtype=torch.int64))

    def forward(self, embeddings: torch.Tensor, labels: torch.Tensor,
                margin: float = 0.2, dist_metric: str = "cosine",
                sampling_strategy: str = "adapted_hard",
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """-> (loss, num_triplets, negatives (n, n) queue slots); advances
        the bank by the batch. ``embeddings`` (n, D) with ``labels`` (n,);
        K must be a multiple of n, so a batch never wraps the queue."""
        emb = embeddings.float()
        n = emb.shape[0]
        k_total = self.queue.shape[0]
        if k_total % n != 0:
            raise ValueError(f"queue size {k_total} must be a multiple of "
                             f"the batch {n} (LOSS.MEM_TRIPLET_K)")
        slots = self.queue_ptr + torch.arange(n, device=emb.device)
        # new tensors, not writes into the old ones: autograd may still hold
        # the previous queue for an earlier microbatch's backward
        self.queue = self.queue.index_copy(0, slots, emb.detach())
        self.label_q = self.label_q.index_copy(0, slots, labels.long())
        self.queue_ptr = (self.queue_ptr + n) % k_total

        dist = pairwise_distance(emb, self.queue, metric=dist_metric)  # (n, K)
        same = labels[:, None] == labels[None, :]
        upper = torch.ones_like(same).triu(1)
        neg_mask = self.label_q[None, :] != labels[:, None]  # (n, K)
        pair_valid = same & upper & neg_mask.any(dim=1)[:, None]
        d_ap = dist[:, slots]  # d(anchor i, queue slot of positive j)
        pair_loss = d_ap[:, :, None] + margin - dist[:, None, :]  # (n, n, K)
        neg3 = neg_mask[:, None, :].expand_as(pair_loss)
        easy_dist = torch.where(neg_mask, dist, float("inf"))
        neg_idx = select_negative_indices(pair_loss, neg3, easy_dist,
                                          sampling_strategy, noise, generator)
        d_an = dist.gather(1, neg_idx)
        per_pair = F.relu(d_ap + margin - d_an)
        count = pair_valid.sum()
        loss = torch.where(pair_valid, per_pair, 0.0).sum() / count.clamp_min(1)
        return loss, count.to(torch.int32), neg_idx
