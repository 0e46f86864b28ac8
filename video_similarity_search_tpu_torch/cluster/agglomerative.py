"""Average-linkage agglomerative clustering with the cosine metric and a
distance threshold, on the host, without scikit-learn (the JAX package's
``fit_cluster`` calls ``sklearn.cluster.AgglomerativeClustering(
n_clusters=None, linkage="average", distance_threshold=0.24,
metric="cosine")``).

Without a connectivity matrix scikit-learn's ``linkage_tree`` builds the
tree with ``scipy.cluster.hierarchy.linkage(X, method="average",
metric="cosine")`` on the rows as given, takes ``count_nonzero(distances
>= threshold) + 1`` clusters and numbers them with ``_hc_cut``. This calls
the same scipy function and keeps a copy of ``_hc_cut``'s numbering. The
condensed distance matrix is O(N^2) in memory, as in the JAX package.
"""

from __future__ import annotations

from heapq import heappush, heappushpop

import numpy as np
from scipy.cluster import hierarchy


def _hc_cut(n_clusters: int, children: np.ndarray,
            n_leaves: int) -> np.ndarray:
    """scikit-learn's ``sklearn/cluster/_agglomerative.py::_hc_cut``: walk
    the tree from the root, always splitting the highest node of a heap of
    negated node ids, and number the ``n_clusters`` subtrees in heap order
    (``_hierarchical_fast._hc_get_descendent`` gives each one's leaves)."""
    nodes = [-(max(children[-1]) + 1)]
    for _ in range(n_clusters - 1):
        these_children = children[-nodes[0] - n_leaves]
        heappush(nodes, -these_children[0])
        heappushpop(nodes, -these_children[1])
    label = np.zeros(n_leaves, dtype=np.intp)
    for i, node in enumerate(nodes):
        stack = [-node]
        while stack:
            k = stack.pop()
            if k < n_leaves:
                label[k] = i
            else:
                stack.extend(children[k - n_leaves])
    return label


def agglomerative_cosine(x, distance_threshold: float = 0.24) -> np.ndarray:
    """Labels (N,) int64, equal to scikit-learn's ``labels_``."""
    x = np.asarray(x, np.float32)
    if x.shape[0] < 2:
        raise ValueError("agglomerative clustering needs at least 2 rows")
    if np.any(~np.any(x, axis=1)):
        raise ValueError("Cosine affinity cannot be used when X contains "
                         "zero vectors")
    tree = hierarchy.linkage(x, method="average", metric="cosine")
    children = tree[:, :2].astype(np.intp)
    n_clusters = int(np.count_nonzero(tree[:, 2] >= distance_threshold)) + 1
    return _hc_cut(n_clusters, children, x.shape[0]).astype(np.int64)
