"""Auxiliary margin-ranking losses combined with the triplet loss (port of
the JAX package's ``losses/combos.py``; reference online_train.py:286-360).
torch ``MarginRankingLoss(x1, x2, target=-1)`` == mean(relu(x1 - x2 +
margin)).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .triplet import pairwise_dist

RSP_MARGIN = 0.1      # ref online_train.py:297
RSP_LAMBDA = 1.0      # ref :303
INTRA_NEG_MARGIN = 0.04  # ref :351
INTRA_NEG_LAMBDA = 0.4   # ref :358


def margin_ranking_loss(x1: torch.Tensor, x2: torch.Tensor,
                        margin: float) -> torch.Tensor:
    """MarginRankingLoss with target=-1: mean(relu(x1 - x2 + margin))."""
    return F.relu(x1 - x2 + margin).mean()


def rsp_loss(out_anc, out_pos, out_fast_pos,
             dist_metric: str = "cosine") -> torch.Tensor:
    """Relative speed: d(anchor, positive) should beat d(anchor, 2x-speed
    positive) by the margin (ref online_train.py:286-304)."""
    d_ap = pairwise_dist(out_anc, out_pos, dist_metric)
    d_an = pairwise_dist(out_anc, out_fast_pos, dist_metric)
    return margin_ranking_loss(d_ap, d_an, RSP_MARGIN)


def llc_loss(out_anc, out_pos, out_anc2, margin: float = 0.04,
             dist_metric: str = "cosine") -> torch.Tensor:
    """Local-local contrast: a second clip of the anchor video should be
    closer than the positive (ref online_train.py:306-332)."""
    d_ap = pairwise_dist(out_anc, out_anc2, dist_metric)
    d_an = pairwise_dist(out_anc, out_pos, dist_metric)
    return margin_ranking_loss(d_ap, d_an, margin)


def intra_neg_loss(out_anc, out_pos, out_intra_neg,
                   dist_metric: str = "cosine",
                   reference_compat: bool = False) -> torch.Tensor:
    """Intra-negative: the temporally shuffled anchor must sit farther than
    the positive, relu(d(anc, pos) - d(anc, shuffled) + margin).
    ``reference_compat`` (LOSS.INTRA_NEG_REFERENCE_COMPAT) swaps the two
    distances, replicating the reference's inverted objective (its block
    at online_train.py:334-360 copies the local-local one; the JAX
    package's docstring has the details)."""
    d_ap = pairwise_dist(out_anc, out_pos, dist_metric)
    d_an = pairwise_dist(out_anc, out_intra_neg, dist_metric)
    if reference_compat:
        d_ap, d_an = d_an, d_ap
    return margin_ranking_loss(d_ap, d_an, INTRA_NEG_MARGIN)
