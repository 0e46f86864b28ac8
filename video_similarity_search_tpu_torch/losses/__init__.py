from .combos import (INTRA_NEG_LAMBDA, RSP_LAMBDA, intra_neg_loss, llc_loss,
                     margin_ranking_loss, rsp_loss)
from .mem_triplet import MemTripletLoss
from .nce import (AliasMethod, MemoryMoCo, NCEAverage, memory_moco_logits,
                  nce_criterion, nce_softmax_loss)
from .triplet import (online_triplet_loss, pairwise_dist,
                      select_negative_indices)

__all__ = [
    "AliasMethod", "INTRA_NEG_LAMBDA", "MemTripletLoss", "MemoryMoCo",
    "NCEAverage", "RSP_LAMBDA", "intra_neg_loss", "llc_loss",
    "margin_ranking_loss", "memory_moco_logits", "nce_criterion",
    "nce_softmax_loss", "online_triplet_loss", "pairwise_dist", "rsp_loss",
    "select_negative_indices",
]
