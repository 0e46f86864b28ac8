"""Online triplet mining as fixed-shape masked tensor ops (port of the JAX
package's ``losses/triplet.py``; reference loss/triplet_loss.py:86-426).

Every ordered anchor/positive pair (i < j, same label) is a row of an
(N, N) validity mask; a pair's negative is a masked argmax over
Gumbel-perturbed logits (a uniform choice among the valid set), and the
hardest-easy fallback is a masked argmin. Strategy names and loss formulas
are the JAX package's (its module docstring says where they depart from
the reference).

The random draws are injected: ``noise`` is the Gumbel (N, N, N) tensor
(uniform for ``all_semi_hard``), as ``jax.random.gumbel(mine_key, ...)``
would give it, or else it is drawn from ``generator`` on the embeddings'
device. So a test can feed both packages the same draws (ROADMAP hazard
H2). ``torch.argmax``/``argmin`` and a stable descending sort break ties
toward the lower index, as ``jnp.argmax`` and ``lax.top_k`` do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.pdist import pairwise_distance

NEG_INF = -1e30
NUM_NEGATIVES_ALL_SEMI_HARD = 5  # reference loss/triplet_loss.py:120
_F32_TINY = 1.1754943508222875e-38  # np.finfo(np.float32).tiny


def pairwise_dist(a: torch.Tensor, b: torch.Tensor,
                  metric: str = "cosine") -> torch.Tensor:
    """Row-wise distance of aligned embeddings (B,D)x(B,D) -> (B,) (the JAX
    package's ``models/triplet_net.py::pairwise_dist``): euclidean as torch
    ``F.pairwise_distance(p=2)``, cosine as ``1 - cos_sim``."""
    a = a.float()
    b = b.float()
    if metric == "euclidean":
        return torch.sqrt(((a - b) ** 2).sum(1) + 1e-12)
    assert metric == "cosine"
    an = a / torch.linalg.vector_norm(a, dim=1, keepdim=True).clamp_min(1e-12)
    bn = b / torch.linalg.vector_norm(b, dim=1, keepdim=True).clamp_min(1e-12)
    return 1.0 - (an * bn).sum(1)


def gumbel(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel draws, as ``jax.random.gumbel`` makes them from a
    uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(u.clamp_min(_F32_TINY)))


def pair_masks(labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pair_valid (N,N), neg_mask (N,N)): pair_valid[i, j] is i < j, the
    same label, and some other label in the batch (ref :288-299);
    neg_mask[i, n] is that the labels differ."""
    same = labels[:, None] == labels[None, :]
    neg_mask = ~same
    iu = torch.ones_like(same).triu(1)
    has_neg = neg_mask.any(dim=1)
    return same & iu & has_neg[:, None], neg_mask


def select_negative_indices(pair_loss: torch.Tensor, neg3: torch.Tensor,
                            easy_dist: torch.Tensor, strategy: str,
                            noise: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None
                            ) -> torch.Tensor:
    """Negative candidate index per (anchor, positive) pair.

    ``pair_loss`` (A, P, C) = d_ap + margin - d(anchor, candidate);
    ``neg3`` (A, P, C) the candidates' validity; ``easy_dist`` (A, C)
    anchor -> candidate distances with invalid entries +inf (the
    hardest-easy fallback, ref :424-426). ``noise``: the (A, P, C) Gumbel
    draws of the random strategies, else drawn from ``generator``.
    -> (A, P) int64."""
    n_candidates = pair_loss.shape[-1]
    neg_inf = torch.full_like(pair_loss, NEG_INF)

    def perturbed(logits):
        g = gumbel(generator, logits.shape) if noise is None else noise
        return logits + g

    if strategy == "random_negative":
        logits = perturbed(torch.where(neg3, 0.0, neg_inf))
    elif strategy == "random_semi_hard":
        logits = perturbed(torch.where(neg3 & (pair_loss > 0), 0.0, neg_inf))
    elif strategy == "fixed_semi_hard":
        logits = torch.where(neg3 & (pair_loss > 0), pair_loss, neg_inf)
    elif strategy == "adapted_hard":
        if n_candidates < 1000:
            # degenerate case == the hardest-easy fallback (the JAX
            # package's module docstring)
            logits = neg_inf
        else:
            k = max(int(0.05 * n_candidates), 1)
            skip = int(0.001 * n_candidates)
            masked = torch.where(neg3, pair_loss, neg_inf)
            sorted_loss = torch.sort(masked, dim=-1).values
            lo = sorted_loss[..., -k][..., None]
            hi = sorted_loss[..., -(skip + 1)][..., None]
            band = neg3 & (masked >= lo) & (masked <= hi)
            logits = perturbed(torch.where(band, 0.0, neg_inf))
    else:
        raise ValueError(f"unknown sampling strategy {strategy!r}")

    neg_idx = torch.argmax(logits, dim=-1)
    chosen_valid = logits.gather(-1, neg_idx[..., None])[..., 0] > NEG_INF / 2
    easy_idx = torch.argmin(easy_dist, dim=-1)[:, None].expand_as(neg_idx)
    return torch.where(chosen_valid, neg_idx, easy_idx)


def online_triplet_loss(embeddings: torch.Tensor, labels: torch.Tensor, *,
                        margin: float = 0.2, dist_metric: str = "cosine",
                        sampling_strategy: str = "random_negative",
                        noise: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None):
    """-> (loss, num_triplets, negatives) — reference
    OnlineTripletLoss.forward (:95-227).

    ``embeddings`` (2B, D): anchors then positives; ``labels`` (2B,).
    ``negatives`` is what the miner chose: (N, N) indices for the margin
    strategies, (N, N, 5) for ``all_semi_hard`` with -1 where a pair had
    fewer valid negatives, None for ``noise_contrastive`` (whose count is
    0, as in the reference)."""
    emb = embeddings.float()
    n = emb.shape[0]

    if sampling_strategy == "noise_contrastive":
        temperature = 0.5  # ref :99
        sim = 1.0 - pairwise_distance(emb, metric=dist_metric)
        eye = torch.eye(n, dtype=torch.bool, device=emb.device)
        sim = torch.where(eye, 0.0, sim) / temperature
        targets = (torch.arange(n, device=emb.device) + n // 2) % n
        logz = torch.logsumexp(sim, dim=1)
        loss = (logz - sim.gather(1, targets[:, None])[:, 0]).mean()
        return loss, torch.zeros((), dtype=torch.int32,
                                 device=emb.device), None

    dist = pairwise_distance(emb, metric=dist_metric)
    pair_valid, neg_mask = pair_masks(labels)
    if sampling_strategy == "all_semi_hard":
        return _all_semi_hard_loss(dist, pair_valid, neg_mask, margin, noise,
                                   generator)

    pair_loss = dist[:, :, None] + margin - dist[:, None, :]
    neg3 = neg_mask[:, None, :].expand_as(pair_loss)
    easy_dist = torch.where(neg_mask, dist, float("inf"))
    neg_idx = select_negative_indices(pair_loss, neg3, easy_dist,
                                      sampling_strategy, noise, generator)
    d_an = dist.gather(1, neg_idx)
    per_pair = F.relu(dist + margin - d_an)
    count = pair_valid.sum()
    loss = torch.where(pair_valid, per_pair, 0.0).sum() / count.clamp_min(1)
    return loss, count.to(torch.int32), neg_idx


def _all_semi_hard_loss(dist, pair_valid, neg_mask, margin, noise,
                        generator):
    """InfoNCE over 5 negatives a pair (ref :118-203, intended semantics):
    the semi-hard set in random order, padded (when fewer than 5) by the
    hardest easy negatives in hardness order."""
    k = NUM_NEGATIVES_ALL_SEMI_HARD
    n = dist.shape[0]
    pair_loss = dist[:, :, None] + margin - dist[:, None, :]
    neg3 = neg_mask[:, None, :].expand_as(pair_loss)
    semi = neg3 & (pair_loss > 0)
    u = noise if noise is not None else torch.rand(
        pair_loss.shape, generator=generator, device=generator.device)
    easy = torch.where(neg_mask, dist, float("inf"))
    easy_rank = torch.argsort(torch.argsort(easy, dim=-1, stable=True),
                              dim=-1, stable=True)
    easy_score = 1.0 - easy_rank.float() / n  # (0, 1]
    scores = torch.where(semi, 2.0 + u,
                         torch.where(neg3, easy_score[:, None, :], NEG_INF))
    # lax.top_k: ties toward the lower index, i.e. a stable descending sort
    sel_scores, top_idx = torch.sort(scores, dim=-1, descending=True,
                                     stable=True)
    sel_scores, top_idx = sel_scores[..., :k], top_idx[..., :k]
    sel_valid = sel_scores > NEG_INF / 2
    an_sel = dist[:, None, :].expand_as(pair_loss).gather(-1, top_idx)

    temperature = 0.5  # ref :186
    ap_sim = torch.exp((1.0 - dist) / temperature)
    an_sim = torch.where(sel_valid, torch.exp((1.0 - an_sel) / temperature),
                         0.0)
    per_pair = -torch.log(ap_sim / (an_sim.sum(-1) + ap_sim))
    count = pair_valid.sum()
    loss = torch.where(pair_valid, per_pair, 0.0).sum() / count.clamp_min(1)
    negatives = torch.where(sel_valid, top_idx, -1)
    return loss, count.to(torch.int32), negatives
