from .cc import compact_labels, connected_components
from .fused_knn import nearest_neighbor_fused
from .pdist import (l2_normalize, nearest_neighbor, pairwise_distance,
                    topk_neighbors)
from .segment import segment_count, segment_mean

__all__ = [
    "compact_labels",
    "connected_components",
    "nearest_neighbor_fused",
    "l2_normalize",
    "nearest_neighbor",
    "pairwise_distance",
    "topk_neighbors",
    "segment_count",
    "segment_mean",
]
