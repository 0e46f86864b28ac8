"""Clustering dispatch — same surface as the reference ``fit_cluster``
(clustering/cluster_masks.py:38-98); port of the JAX package's
``cluster/fit.py``.

Methods, with the reference's hyperparameters: kmeans (Lloyd on the
device, L2-normalize preprocessing), spherical_kmeans, finch (FINCH on the
device), DBSCAN and OPTICS (``density.py``, on the device) and
Agglomerative (``agglomerative.py``, scipy's average linkage on the host,
as in the JAX package). scikit-learn is not imported: each method gives
the labels its scikit-learn estimator gives.
"""

from __future__ import annotations

import numpy as np

from ..utils.device import resolve_device
from .agglomerative import agglomerative_cosine
from .density import dbscan, optics_dbscan
from .finch import FINCH
from .kmeans import kmeans

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
        labels, _ = kmeans(emb, k=k, n_init=10,
                           spherical=method == "spherical_kmeans",
                           l2normalize=l2normalize, seed=seed, device=dev)
        labels = labels.cpu().numpy()
    elif method == "finch":
        c, num_clust, _ = FINCH(emb, distance="cosine", verbose=verbose,
                                device=dev)
        part = min(finch_partition, c.shape[1] - 1)
        labels = c[:, part]
        if verbose:
            print(f"Taking partition {part} from finch")
    elif method == "Agglomerative":
        labels = agglomerative_cosine(emb, distance_threshold=0.24)
    elif method == "DBSCAN":
        labels = dbscan(emb, eps=0.14, min_samples=2, device=dev).cpu().numpy()
    elif method == "OPTICS":
        labels = optics_dbscan(emb, min_samples=3, max_eps=0.20,
                               device=dev).cpu().numpy()

    labels = np.asarray(labels).astype(np.int64)
    if verbose:
        n_clusters = len(set(labels.tolist())) - (1 if -1 in labels else 0)
        print(f"Fitted {n_clusters} clusters with {method}")
    return labels
