from .embed import (cache_embeddings, get_embeddings_and_labels,
                    load_cached_embeddings)
from .knn import k_nearest_embeddings
from .retrieval import (TOPK_DEFAULT, TOPK_EXTENDED, coclr_retrieval_acc,
                        get_distance_matrix, iic_retrieval_acc,
                        local_batch_retrieval_acc, topk_retrieval_acc)
from .validate import make_validate_step, validate

__all__ = [
    "cache_embeddings",
    "get_embeddings_and_labels",
    "load_cached_embeddings",
    "k_nearest_embeddings",
    "TOPK_DEFAULT",
    "TOPK_EXTENDED",
    "coclr_retrieval_acc",
    "get_distance_matrix",
    "iic_retrieval_acc",
    "local_batch_retrieval_acc",
    "topk_retrieval_acc",
    "make_validate_step",
    "validate",
]
