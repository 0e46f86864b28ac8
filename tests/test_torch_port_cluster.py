"""Parity of the PyTorch port's FINCH with the JAX package's, on the CPU.

The same planted mixture (numpy, fixed seed) goes through both; the
partitions must be equal up to relabelling and ``num_clust`` equal, on
the dense level-0 path, on the sparse level-0 path (``DENSE_THRESHOLD``
patched low in both modules, as tests/test_cluster.py does) and with
``req_clust``.
"""

import numpy as np
import pytest

from video_similarity_search_tpu.cluster import finch as jfinch
from video_similarity_search_tpu.cluster.fit import fit_cluster as j_fit
from video_similarity_search_tpu_torch.cluster import finch as tfinch
from video_similarity_search_tpu_torch.cluster.fit import fit_cluster as t_fit


def _mixture(n, classes=8, d=16, noise=0.8, seed=0):
    """Overlapping Gaussian mixture, as perf_experiments/cluster_240k_r4.py
    builds at 240k x 128."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, d)).astype(np.float32)
    lbl = rng.integers(0, classes, n)
    x = centers[lbl] + noise * rng.normal(size=(n, d)).astype(np.float32)
    return x.astype(np.float32), lbl


def _canon(labels):
    """Relabel by order of first appearance (partition identity)."""
    _, first, inv = np.unique(labels, return_index=True, return_inverse=True)
    rank = np.argsort(np.argsort(first))
    return rank[inv]


def _assert_same_partitions(cj, ct):
    assert cj.shape == ct.shape
    for p in range(cj.shape[1]):
        np.testing.assert_array_equal(_canon(ct[:, p]), _canon(cj[:, p]))


@pytest.mark.parametrize("path", ["dense", "sparse"])
def test_finch_matches_jax(path, monkeypatch):
    x, _ = _mixture(720)
    if path == "sparse":
        monkeypatch.setattr(jfinch, "DENSE_THRESHOLD", 100)
        monkeypatch.setattr(tfinch, "DENSE_THRESHOLD", 100)
    cj, nj, _ = jfinch.FINCH(x, verbose=False)
    ct, nt, _ = tfinch.FINCH(x, verbose=False, device="cpu")
    assert nt == nj
    assert len(nj) >= 2
    _assert_same_partitions(cj, ct)


def test_sparse_level0_matches_dense_level0():
    x, _ = _mixture(500, seed=1)
    import torch
    xt = torch.from_numpy(x)
    dense = tfinch._dense_level(xt, 0.0)[0].numpy()
    sparse = tfinch._sparse_level0(xt, "cosine")[0].numpy()
    np.testing.assert_array_equal(_canon(sparse), _canon(dense))


@pytest.mark.parametrize("req", [3, 5])
def test_finch_req_clust_matches_jax(req):
    x, _ = _mixture(300, classes=6, seed=2)
    cj, nj, rj = jfinch.FINCH(x, req_clust=req, verbose=False)
    ct, nt, rt = tfinch.FINCH(x, req_clust=req, verbose=False, device="cpu")
    assert nt == nj
    assert len(np.unique(rt)) == req
    np.testing.assert_array_equal(_canon(rt), _canon(rj))


def test_fit_cluster_finch_matches_jax():
    x, _ = _mixture(400, seed=3)
    lj = j_fit(x, method="finch", finch_partition=1, verbose=False)
    lt = t_fit(x, method="finch", finch_partition=1, verbose=False,
               device="cpu")
    np.testing.assert_array_equal(_canon(lt), _canon(lj))


@pytest.mark.parametrize("method", ["kmeans", "spherical_kmeans"])
def test_kmeans_not_ported(method):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_fit(np.zeros((4, 2), np.float32), method=method, device="cpu")
