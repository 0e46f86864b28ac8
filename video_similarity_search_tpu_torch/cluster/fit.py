"""Clustering dispatch — same surface as the reference ``fit_cluster``
(clustering/cluster_masks.py:38-98); port of the JAX package's
``cluster/fit.py``.

Methods: finch (FINCH on the card), and the rarely-used sklearn estimators
(Agglomerative / DBSCAN / OPTICS) kept host-side with the reference's
hyperparameters, sklearn imported only when one is asked for. kmeans and
spherical_kmeans are not ported yet (ROADMAP.md, queue 1, 'k-means').
"""

from __future__ import annotations

import numpy as np

from ..utils.device import resolve_device
from .finch import FINCH

METHODS = ("DBSCAN", "Agglomerative", "OPTICS", "kmeans", "spherical_kmeans",
           "finch")


def fit_cluster(embeddings, method: str = "Agglomerative", k: int = 1000,
                l2normalize: bool = True, finch_partition: int = 0,
                seed: int = 1, verbose: bool = True,
                device="cuda") -> np.ndarray:
    """Returns integer labels (N,). -1 marks noise (DBSCAN/OPTICS)."""
    assert method in METHODS, f"unknown clustering method {method!r}"
    dev = resolve_device(device)
    emb = np.asarray(embeddings, np.float32)
    if verbose:
        print(f"Clustering with {method}...")

    if method in ("kmeans", "spherical_kmeans"):
        raise NotImplementedError(
            f"{method}: not ported yet (ROADMAP.md, queue 1, 'k-means')")
    if method == "finch":
        c, num_clust, _ = FINCH(emb, distance="cosine", verbose=verbose,
                                device=dev)
        part = min(finch_partition, c.shape[1] - 1)
        labels = c[:, part]
        if verbose:
            print(f"Taking partition {part} from finch")
    elif method == "Agglomerative":
        from sklearn.cluster import AgglomerativeClustering
        labels = AgglomerativeClustering(
            n_clusters=None, linkage="average", distance_threshold=0.24,
            metric="cosine").fit(emb).labels_
    elif method == "DBSCAN":
        from sklearn.cluster import DBSCAN
        labels = DBSCAN(eps=0.14, min_samples=2, metric="cosine",
                        n_jobs=-1).fit(emb).labels_
    elif method == "OPTICS":
        from sklearn.cluster import OPTICS
        labels = OPTICS(min_samples=3, max_eps=0.20, cluster_method="dbscan",
                        metric="cosine", n_jobs=-1).fit(emb).labels_

    labels = np.asarray(labels).astype(np.int64)
    if verbose:
        n_clusters = len(set(labels.tolist())) - (1 if -1 in labels else 0)
        print(f"Fitted {n_clusters} clusters with {method}")
    return labels
