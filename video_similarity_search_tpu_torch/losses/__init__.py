from .combos import (INTRA_NEG_LAMBDA, RSP_LAMBDA, intra_neg_loss, llc_loss,
                     margin_ranking_loss, rsp_loss)
from .triplet import (online_triplet_loss, pairwise_dist,
                      select_negative_indices)

__all__ = [
    "INTRA_NEG_LAMBDA", "RSP_LAMBDA", "intra_neg_loss", "llc_loss",
    "margin_ranking_loss", "online_triplet_loss", "pairwise_dist",
    "rsp_loss", "select_negative_indices",
]
