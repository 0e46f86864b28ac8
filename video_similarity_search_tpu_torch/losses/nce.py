"""CMC-style NCE losses with memory banks on the device (port of the JAX
package's ``losses/nce.py``; reference loss/NCE_loss.py:10-352).

``NCEAverage`` (with its intra-negative variant) and ``MemoryMoCo`` hold
their banks and normalization constants as registered buffers, so they go
into checkpoints with ``state_dict()``; the buffer names are the fields of
the JAX package's ``NCEAverageState`` / ``MemoryMoCoState``. A forward
scores against the banks as they were before the call and then updates
them: the per-sample banks by a momentum step renormalized to unit length
(ref :73-86), the MoCo queue by writing the keys at its pointer.

The negatives of ``NCEAverage`` are ``K`` uniform draws over the dataset
(the uniform unigrams the reference uses, ref :15, make its multinomial a
randint); they are injected as ``idx`` or drawn from ``generator``
(ROADMAP hazard H2). ``AliasMethod`` keeps the reference's sampler for
arbitrary unigram distributions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

_EPS = 1e-7  # ref :8


def _uniform_bank(gen: torch.Generator, rows: int, dim: int) -> torch.Tensor:
    stdv = 1.0 / np.sqrt(dim / 3.0)
    return torch.rand(rows, dim, generator=gen) * (2 * stdv) - stdv


def draw_indices(y: torch.Tensor, n_data: int, K: int,
                 generator: torch.Generator) -> torch.Tensor:
    """(B, K+1) sample indices, column 0 the positive ``y`` (the JAX
    ``_draw_indices``)."""
    idx = torch.randint(0, n_data, (y.shape[0], K + 1), generator=generator,
                        device=generator.device)
    idx[:, 0] = y.to(idx.device)
    return idx


def _momentum_bank_update(memory: torch.Tensor, feats: torch.Tensor,
                          y: torch.Tensor, momentum: float) -> None:
    """bank[y] <- renorm(momentum * bank[y] + (1 - momentum) * feat)."""
    new = momentum * memory[y] + (1.0 - momentum) * feats.detach().float()
    new = new / torch.linalg.vector_norm(new, dim=1,
                                         keepdim=True).clamp_min(1e-12)
    memory.index_copy_(0, y, new)


class NCEAverage(nn.Module):
    """Two-view NCE scoring against per-sample banks (reference NCEAverage,
    :26-88; with ``intra_neg`` the variant of :91-184, whose third bank of
    shuffled-clip embeddings is appended to both views' negatives). Buffers
    ``memory_l``, ``memory_ab`` (n_data, D), ``memory_neg`` when
    ``intra_neg``, and the NCE constants ``z_l``, ``z_ab`` (-1 until the
    first batch estimates them)."""

    def __init__(self, n_data: int, feat_dim: int, K: int = 1024,
                 T: float = 0.07, momentum: float = 0.5,
                 use_softmax: bool = True, intra_neg: bool = False,
                 seed: int = 7):
        super().__init__()
        self.n_data, self.K, self.T = n_data, K, T
        self.momentum, self.use_softmax = momentum, use_softmax
        self.intra_neg = intra_neg
        gen = torch.Generator().manual_seed(seed)
        self.register_buffer("memory_l", _uniform_bank(gen, n_data, feat_dim))
        self.register_buffer("memory_ab", _uniform_bank(gen, n_data, feat_dim))
        if intra_neg:
            self.register_buffer("memory_neg",
                                 _uniform_bank(gen, n_data, feat_dim))
        self.register_buffer("z_l", torch.tensor(-1.0))
        self.register_buffer("z_ab", torch.tensor(-1.0))

    def forward(self, l: torch.Tensor, ab: torch.Tensor, y: torch.Tensor,
                neg: Optional[torch.Tensor] = None,
                idx: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (out_l, out_ab), (B, K+1) scores with the positive in column
        0 ((B, 2(K+1)) with ``intra_neg``); then updates the banks."""
        if idx is None:
            idx = draw_indices(y, self.n_data, self.K, generator)
        idx = idx.to(self.memory_l.device)
        w_l, w_ab = self.memory_l[idx], self.memory_ab[idx]  # (B, K+1, D)
        if self.intra_neg:
            w_neg = self.memory_neg[idx]
            w_l = torch.cat([w_l, w_neg], dim=1)
            w_ab = torch.cat([w_ab, w_neg], dim=1)
        out_ab = torch.einsum("bkd,bd->bk", w_l, ab.float())
        out_l = torch.einsum("bkd,bd->bk", w_ab, l.float())
        if self.use_softmax:
            out_l, out_ab = out_l / self.T, out_ab / self.T
        else:  # NCE: exp / Z, Z estimated on the first batch (ref :55-71)
            e_l, e_ab = torch.exp(out_l / self.T), torch.exp(out_ab / self.T)
            with torch.no_grad():
                self.z_l.copy_(torch.where(self.z_l < 0,
                                           e_l.mean() * self.n_data, self.z_l))
                self.z_ab.copy_(torch.where(self.z_ab < 0,
                                            e_ab.mean() * self.n_data,
                                            self.z_ab))
            out_l, out_ab = e_l / self.z_l.clone(), e_ab / self.z_ab.clone()
        with torch.no_grad():
            y = y.to(self.memory_l.device)
            _momentum_bank_update(self.memory_l, l, y, self.momentum)
            _momentum_bank_update(self.memory_ab, ab, y, self.momentum)
            if self.intra_neg:
                _momentum_bank_update(self.memory_neg, neg, y, self.momentum)
        return out_l, out_ab


class MemoryMoCo(nn.Module):
    """Queue-style memory (reference MemoryMoCo, :188-241). Buffers
    ``memory`` (K, D), ``index`` (the write pointer) and ``z``."""

    def __init__(self, K: int, feat_dim: int, T: float = 0.07,
                 use_softmax: bool = False, n_data: Optional[int] = None,
                 seed: int = 7):
        super().__init__()
        if not use_softmax and not n_data:
            raise ValueError("MemoryMoCo(use_softmax=False) needs n_data > 0 "
                             "(the NCE Z estimate is mean(out) * n_data)")
        self.T, self.use_softmax, self.n_data = T, use_softmax, n_data
        gen = torch.Generator().manual_seed(seed)
        self.register_buffer("memory", _uniform_bank(gen, K, feat_dim))
        self.register_buffer("index", torch.zeros((), dtype=torch.int64))
        self.register_buffer("z", torch.tensor(-1.0))

    def forward(self, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """-> (B, 1+K) scores, the positive in column 0; then writes the
        keys ``k`` into the queue."""
        q = q.float()
        k = k.detach().float()
        l_pos = (q * k).sum(1, keepdim=True)
        out = torch.cat([l_pos, q @ self.memory.T], dim=1)
        if self.use_softmax:
            out = out / self.T
        else:
            out = torch.exp(out / self.T)
            with torch.no_grad():
                self.z.copy_(torch.where(self.z < 0,
                                         out.mean() * self.n_data, self.z))
            out = out / self.z.clone()
        n_slots = self.memory.shape[0]
        slots = (self.index + torch.arange(q.shape[0], device=q.device)
                 ) % n_slots
        # a new tensor: autograd keeps the old queue for q's gradient
        self.memory = self.memory.index_copy(0, slots, k)
        self.index = (self.index + q.shape[0]) % n_slots
        return out


def memory_moco_logits(memory: torch.Tensor, q: torch.Tensor,
                       k: torch.Tensor, T: float = 0.07) -> torch.Tensor:
    """Softmax-path MoCo logits (B, 1+K) against a fixed ``memory``: the
    scoring half of ``MemoryMoCo`` without the queue update, for the
    second view of the symmetric two-view step (the queue advances once a
    step)."""
    q = q.float()
    k = k.detach().float()
    l_pos = (q * k).sum(1, keepdim=True)
    return torch.cat([l_pos, q @ memory.T], dim=1) / T


def nce_criterion(x: torch.Tensor, n_data: int) -> torch.Tensor:
    """Eq.-12 NCE loss (reference NCECriterion, :312-337); x (B, K+1)
    probabilities."""
    x = x.float()
    m = x.shape[1] - 1
    pn = 1.0 / float(n_data)
    p_pos = x[:, 0]
    log_d1 = torch.log(p_pos / (p_pos + m * pn + _EPS))
    p_neg = x[:, 1:]
    log_d0 = torch.log((m * pn) / (p_neg + m * pn + _EPS))
    return -(log_d1.sum() + log_d0.sum()) / x.shape[0]


def nce_softmax_loss(x: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy with target column 0 (reference
    NCESoftmaxLoss, :341-352)."""
    x = x.float()
    return (torch.logsumexp(x, dim=1) - x[:, 0]).mean()


class AliasMethod:
    """O(1) multinomial sampling through alias tables (reference
    :246-307), drawing from a ``torch.Generator``."""

    def __init__(self, probs):
        probs = np.asarray(probs, np.float64)
        if probs.sum() > 1:
            probs = probs / probs.sum()
        k = len(probs)
        self.prob = np.zeros(k)
        self.alias = np.zeros(k, np.int64)
        smaller, larger = [], []
        for i, p in enumerate(probs):
            self.prob[i] = k * p
            (smaller if self.prob[i] < 1.0 else larger).append(i)
        while smaller and larger:
            small, large = smaller.pop(), larger.pop()
            self.alias[small] = large
            self.prob[large] = (self.prob[large] - 1.0) + self.prob[small]
            (smaller if self.prob[large] < 1.0 else larger).append(large)
        for leftover in smaller + larger:
            self.prob[leftover] = 1.0

    def draw(self, n: int, generator: torch.Generator) -> torch.Tensor:
        dev = generator.device
        kk = torch.randint(0, len(self.prob), (n,), generator=generator,
                           device=dev)
        prob = torch.as_tensor(self.prob, dtype=torch.float32, device=dev)[kk]
        b = torch.rand(n, generator=generator, device=dev) < prob
        alias = torch.as_tensor(self.alias, device=dev)[kk]
        return torch.where(b, kk, alias)
