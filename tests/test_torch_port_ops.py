"""Parity of the PyTorch port's ops with the JAX package's, on the CPU.

Inputs come from numpy with a fixed seed and go through both. Tolerances:
indices equal, distances within 1e-5 (float32 sums in another order).
The port's ``nearest_neighbor_fused`` on a CPU tensor takes its plain
version; it is held against the JAX Pallas kernel run by the Pallas
interpreter, as tests/test_ops.py runs it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_similarity_search_tpu.ops import cc as jcc
from video_similarity_search_tpu.ops import pdist as jpd
from video_similarity_search_tpu.ops import segment as jseg
from video_similarity_search_tpu.ops.pallas_knn import \
    nearest_neighbor_fused as j_fused
from video_similarity_search_tpu_torch.ops import cc as tcc
from video_similarity_search_tpu_torch.ops import pdist as tpd
from video_similarity_search_tpu_torch.ops import segment as tseg
from video_similarity_search_tpu_torch.ops.fused_knn import \
    nearest_neighbor_fused as t_fused

ATOL = 1e-5


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("self_mask", [False, True])
def test_pairwise_distance_matches_jax(metric, self_mask):
    x, y = _rand(0, 13, 8), _rand(1, 21, 8)
    ref = np.asarray(jpd.pairwise_distance(jnp.asarray(x), jnp.asarray(y),
                                           metric=metric,
                                           self_mask=self_mask))
    got = tpd.pairwise_distance(_t(x), _t(y), metric=metric,
                                self_mask=self_mask).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("cross", [False, True])
def test_nearest_neighbor_matches_jax(metric, cross):
    # ragged sizes against the tile, so the last tile is partial
    x = _rand(2, 37, 16)
    y = _rand(3, 53, 16) if cross else None
    jy = None if y is None else jnp.asarray(y)
    ji, jd = jpd.nearest_neighbor(jnp.asarray(x), jy, metric=metric,
                                  exclude_self=True, tile=8)
    ti, td = tpd.nearest_neighbor(_t(x), None if y is None else _t(y),
                                  metric=metric, exclude_self=True, tile=8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL)


@pytest.mark.parametrize("k,exclude_self", [(5, False), (7, True),
                                            (40, False)])
def test_topk_neighbors_matches_jax(k, exclude_self):
    q, bank = _rand(4, 19, 8), _rand(5, 29, 8)
    if exclude_self:
        bank = q
    # k=40 > bank of 29: the padding rule repeats the farthest neighbor
    ji, jv = jpd.topk_neighbors(jnp.asarray(q), jnp.asarray(bank), k,
                                exclude_self=exclude_self, tile=8)
    ti, tv = tpd.topk_neighbors(_t(q), _t(bank), k,
                                exclude_self=exclude_self, tile=8)
    assert ti.shape == (19, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


def test_topk_ties_go_to_lower_index_like_lax_top_k():
    """Duplicated bank rows tie exactly; ``lax.top_k`` orders ties by
    index, and the port breaks them the same way, also at the k-th
    place where only some of the tied rows fit."""
    base = _rand(6, 6, 8)
    bank = np.concatenate([base, base, base[:3]])  # rows i, i+6, i+12 tie
    q = base[[0, 2, 4]] + 0.01 * _rand(7, 3, 8)
    for k in (1, 2, 4, 5):
        ji, _ = jpd.topk_neighbors(jnp.asarray(q), jnp.asarray(bank), k)
        ti, _ = tpd.topk_neighbors(_t(q), _t(bank), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_topk_approx_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpd.topk_neighbors(_t(_rand(0, 3, 4)), _t(_rand(1, 5, 4)), 2,
                           approx=True)


@pytest.mark.parametrize("case", ["self", "cross", "tie"])
def test_nearest_neighbor_fused_matches_pallas_interpret(case):
    x = _rand(8, 37, 16)
    y = None
    if case == "cross":
        y = _rand(9, 53, 16)
    elif case == "tie":
        # bank rows 5 and 30 are the same vector; queries sit next to it
        y = _rand(10, 53, 16)
        y[30] = y[5]
        x[:4] = y[5] + 0.001 * _rand(11, 4, 16)
    ji, jd = j_fused(x, y, exclude_self=True, tile_m=8, tile_n=16,
                     interpret=True)
    ti, td = t_fused(_t(x), None if y is None else _t(y), exclude_self=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL)
    if case == "tie":
        assert (ti[:4] == 5).all()  # the first index wins the tie


def test_nearest_neighbor_fused_euclidean_takes_plain_path():
    x = _rand(12, 21, 8)
    ji, jd = j_fused(x, metric="euclidean")
    ti, td = t_fused(_t(x), metric="euclidean")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL)


@pytest.mark.parametrize("n,seed", [(50, 0), (400, 1)])
def test_connected_components_matches_jax(n, seed):
    nn_idx = np.random.default_rng(seed).integers(0, n, n)
    ref = np.asarray(jcc.connected_components(jnp.asarray(nn_idx, jnp.int32)))
    got = tcc.connected_components(_t(nn_idx)).numpy()
    np.testing.assert_array_equal(got, ref)
    jd, jn = jcc.compact_labels(jnp.asarray(ref))
    td, tn = tcc.compact_labels(_t(got))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert tn == int(jn)


def test_segment_mean_and_count_match_jax():
    data = _rand(13, 40, 6)
    ids = np.random.default_rng(14).integers(0, 9, 40)  # some empty ids
    ref = np.asarray(jseg.segment_mean(jnp.asarray(data), jnp.asarray(ids),
                                       11))
    got = tseg.segment_mean(_t(data), _t(ids), 11).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)
    np.testing.assert_array_equal(
        tseg.segment_count(_t(ids), 11).numpy(),
        np.asarray(jseg.segment_count(jnp.asarray(ids), 11)))
