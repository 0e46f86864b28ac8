from .classify import five_crops, ten_crop_views, test_10crop, test_retrieval
from .embed import (cache_embeddings, get_embeddings_and_labels,
                    load_cached_embeddings)
from .heatmap import temporal_heat_map
from .knn import k_nearest_embeddings, plot_exemplar_retrievals
from .retrieval import (TOPK_DEFAULT, TOPK_EXTENDED, coclr_retrieval_acc,
                        get_distance_matrix, iic_retrieval_acc,
                        local_batch_retrieval_acc, topk_retrieval_acc)
from .report import plot_training_progress
from .tsne import tsne_plot
from .validate import make_validate_step, validate

__all__ = [
    "five_crops",
    "ten_crop_views",
    "test_10crop",
    "test_retrieval",
    "cache_embeddings",
    "get_embeddings_and_labels",
    "load_cached_embeddings",
    "k_nearest_embeddings",
    "plot_exemplar_retrievals",
    "plot_training_progress",
    "temporal_heat_map",
    "tsne_plot",
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
