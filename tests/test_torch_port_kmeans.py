"""The port's k-means and spherical k-means against the JAX package's, on
the CPU.

* ``kmeans`` / ``spherical_kmeans`` from the initial points the JAX
  function draws (its ``jax.random.choice`` indices, split per restart as
  it splits them, injected as ``init_idx``): labels equal and inertia
  within rtol 1e-5, with and without the L2 preprocessing, for one
  restart and for several (the best restart wins in both);
* an empty cluster keeps its centre: a repeated initial point gets no
  member (the first index wins the tie) in both packages;
* the restarts draw from a seeded generator when nothing is injected, and
  the port's fit_cluster("kmeans" | "spherical_kmeans") runs on the CPU.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_similarity_search_tpu.ops.pdist import l2_normalize as j_l2n

# the modules (each package's cluster/__init__ exports the function)
jkm = importlib.import_module("video_similarity_search_tpu.cluster.kmeans")
tkm = importlib.import_module(
    "video_similarity_search_tpu_torch.cluster.kmeans")


def _mixture(n, classes=6, d=8, noise=0.6, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, d)).astype(np.float32)
    lbl = rng.integers(0, classes, n)
    x = centers[lbl] + noise * rng.normal(size=(n, d)).astype(np.float32)
    return x.astype(np.float32), lbl


def _jax_init_idx(key, n, k, n_init):
    """The JAX kmeans' initial points: one choice per restart key."""
    return np.stack([np.asarray(jax.random.choice(k_i, n, (k,),
                                                  replace=n < k))
                     for k_i in jax.random.split(key, n_init)])


@pytest.mark.parametrize("spherical,l2normalize,n_init", [
    (False, False, 1), (False, True, 3), (True, False, 3)])
def test_kmeans_matches_jax_from_its_init(spherical, l2normalize, n_init):
    x, _ = _mixture(300, seed=1)
    k, iters = 7, 12
    key = jax.random.key(5)
    jl, ji = jkm.kmeans(jnp.asarray(x), k=k, key=key, n_init=n_init,
                        max_iter=iters, spherical=spherical,
                        l2normalize=l2normalize)
    idx = _jax_init_idx(key, x.shape[0], k, n_init)
    if spherical:
        tl, ti = tkm.spherical_kmeans(x, k, n_init=n_init, max_iter=iters,
                                      init_idx=idx, device="cpu")
    else:
        tl, ti = tkm.kmeans(x, k, n_init=n_init, max_iter=iters,
                            l2normalize=l2normalize, init_idx=idx,
                            device="cpu")
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(float(ti), float(ji), rtol=1e-5)


@pytest.mark.parametrize("spherical", [False, True])
def test_empty_cluster_keeps_its_centre(spherical):
    x, _ = _mixture(120, seed=2)
    idx = np.array([3, 3, 40, 77, 90])  # centres 0 and 1 coincide
    data = j_l2n(jnp.asarray(x)) if spherical else jnp.asarray(x)
    for iters in (0, 1, 6):
        jl, ji = jkm._lloyd(data, data[idx], iters, spherical)
        tl, ti = tkm.kmeans(x, 5, n_init=1, max_iter=iters,
                            spherical=spherical, init_idx=idx[None],
                            device="cpu")
        if iters == 0:  # every tie between the twin centres went to 0
            assert not bool((tl == 1).any())
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_allclose(float(ti), float(ji), rtol=1e-5)


def test_seeded_draws_and_best_restart():
    x, _ = _mixture(200, seed=3)
    a = tkm.kmeans(x, 5, n_init=4, max_iter=8, seed=11, device="cpu")
    b = tkm.kmeans(torch.from_numpy(x), 5, n_init=4, max_iter=8, seed=11,
                   device="cpu")
    assert torch.equal(a[0], b[0]) and float(a[1]) == float(b[1])
    # the winner is the restart of least inertia
    gen = torch.Generator().manual_seed(11)
    idx = np.stack([torch.randperm(200, generator=gen)[:5].numpy()
                    for _ in range(4)])
    single = [tkm.kmeans(x, 5, n_init=1, max_iter=8, init_idx=i[None],
                         device="cpu") for i in idx]
    best = min(range(4), key=lambda r: float(single[r][1]))
    assert torch.equal(a[0], single[best][0])
    with pytest.raises(ValueError, match="n_init"):
        tkm.kmeans(x, 5, n_init=2, init_idx=idx[:1], device="cpu")
