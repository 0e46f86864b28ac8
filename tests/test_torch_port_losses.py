"""The port's triplet mining and auxiliary losses against the JAX
package's, on the CPU.

Every strategy of ``online_triplet_loss`` gets the Gumbel (or, for
``all_semi_hard``, uniform) draws JAX makes from the same ``mine_key``,
injected: the chosen negatives and ``n_triplets`` are equal and the loss
agrees within 1e-6 relative. Cases: random embeddings, a row with no valid
semi-hard negative (the hardest-easy fallback), one label only, and the
``adapted_hard`` band at 1,000+ candidates. The combo losses agree within
1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_similarity_search_tpu.losses import combos as jc
from video_similarity_search_tpu.losses import triplet as jt
from video_similarity_search_tpu.models.triplet_net import \
    pairwise_dist as j_pairwise_dist
from video_similarity_search_tpu_torch.losses import combos as tc
from video_similarity_search_tpu_torch.losses import triplet as tt

STRATEGIES = ["random_negative", "random_semi_hard", "fixed_semi_hard",
              "adapted_hard", "noise_contrastive", "all_semi_hard"]


def _batch(n=12, d=8, classes=3, seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    labels = rng.integers(0, classes, n).astype(np.int32)
    return emb, labels


def _jax_noise(key, n, strategy):
    if strategy == "all_semi_hard":
        return np.array(jax.random.uniform(key, (n, n, n)))
    return np.array(jax.random.gumbel(key, (n, n, n), dtype=jnp.float32))


def _jax_negatives(emb, labels, key, margin, metric, strategy):
    """The negatives JAX's miner picks, from its own internals."""
    dist = jt.pairwise_distance(jnp.asarray(emb), metric=metric)
    pair_valid, neg_mask = jt._pair_masks(jnp.asarray(labels))
    if strategy == "all_semi_hard":
        n = dist.shape[0]
        pair_loss = dist[:, :, None] + margin - dist[:, None, :]
        neg3 = jnp.broadcast_to(neg_mask[:, None, :], pair_loss.shape)
        semi = neg3 & (pair_loss > 0)
        u = jax.random.uniform(key, pair_loss.shape)
        easy = jnp.where(neg_mask, dist, jnp.inf)
        rank = jnp.argsort(jnp.argsort(easy, axis=-1), axis=-1)
        score = 1.0 - rank.astype(jnp.float32) / n
        scores = jnp.where(semi, 2.0 + u,
                           jnp.where(neg3, score[:, None, :], jt._NEG_INF))
        sel, idx = jax.lax.top_k(scores, 5)
        return np.where(np.asarray(sel) > jt._NEG_INF / 2, np.asarray(idx),
                        -1)
    return np.asarray(jt._select_negatives(dist, pair_valid, neg_mask, margin,
                                           strategy, key))


def _compare(emb, labels, strategy, metric="cosine", margin=0.2, seed=0):
    key = jax.random.key(seed)
    j_loss, j_count = jt.online_triplet_loss(
        jnp.asarray(emb), jnp.asarray(labels), key, margin=margin,
        dist_metric=metric, sampling_strategy=strategy)
    noise = torch.from_numpy(_jax_noise(key, len(emb), strategy))
    t_loss, t_count, t_neg = tt.online_triplet_loss(
        torch.from_numpy(emb), torch.from_numpy(labels).long(),
        margin=margin, dist_metric=metric, sampling_strategy=strategy,
        noise=noise)
    assert int(t_count) == int(j_count)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-6,
                               atol=1e-7)
    if strategy != "noise_contrastive":
        want = _jax_negatives(emb, labels, key, margin, metric, strategy)
        np.testing.assert_array_equal(t_neg.numpy(), want)
    return t_neg


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_online_triplet_loss_matches_jax(strategy, metric):
    emb, labels = _batch(seed=len(strategy))
    _compare(emb, labels, strategy, metric=metric, margin=0.2)


@pytest.mark.parametrize("strategy", ["random_semi_hard", "fixed_semi_hard"])
def test_no_semi_hard_negative_falls_back_to_hardest_easy(strategy):
    """Class 0 sits tight and far from every other point: its pairs have
    no negative within the margin, so the miner takes the closest easy
    negative (an all -1e30 row's argmax is index 0, then the fallback)."""
    rng = np.random.default_rng(4)
    emb = rng.normal(size=(10, 6)).astype(np.float32)
    emb[:4] = np.array([5, 0, 0, 0, 0, 0]) + 0.01 * rng.normal(size=(4, 6))
    emb[4:, 0] = -np.abs(emb[4:, 0]) - 1.0
    labels = np.array([0, 0, 0, 0, 1, 1, 1, 2, 2, 2], np.int32)
    neg = _compare(emb, labels, strategy, margin=0.05)
    dist = tt.pairwise_distance(torch.from_numpy(emb))
    easy = torch.where(torch.from_numpy(labels[:, None] != labels[None, :]),
                       dist, float("inf")).argmin(1)
    assert (neg[:4, :4] == easy[:4, None]).all()


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_single_label_batch(strategy):
    emb, _ = _batch(n=8, seed=9)
    labels = np.zeros(8, np.int32)
    _compare(emb, labels, strategy)


def test_adapted_hard_band_at_1000_candidates():
    """The top-5% band engages from 1,000 candidates; the miner itself on
    (A, P, C) = (3, 4, 1200) inputs with the same Gumbel draws."""
    rng = np.random.default_rng(2)
    pair_loss = rng.normal(size=(3, 4, 1200)).astype(np.float32)
    neg3 = rng.random((3, 4, 1200)) < 0.8
    easy = np.where(neg3[:, 0], rng.random((3, 1200)), np.inf).astype(
        np.float32)
    key = jax.random.key(5)
    want = jt.select_negative_indices(jnp.asarray(pair_loss),
                                      jnp.asarray(neg3), jnp.asarray(easy),
                                      "adapted_hard", key)
    noise = jax.random.gumbel(key, pair_loss.shape, dtype=jnp.float32)
    got = tt.select_negative_indices(
        torch.from_numpy(pair_loss), torch.from_numpy(neg3),
        torch.from_numpy(easy), "adapted_hard",
        noise=torch.from_numpy(np.array(noise)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generator_draws_are_used_and_seeded():
    emb, labels = _batch(n=10, seed=3)
    args = (torch.from_numpy(emb), torch.from_numpy(labels).long())
    kw = dict(sampling_strategy="random_negative")
    a = tt.online_triplet_loss(*args, generator=torch.Generator().manual_seed(1),
                               **kw)[2]
    b = tt.online_triplet_loss(*args, generator=torch.Generator().manual_seed(1),
                               **kw)[2]
    c = tt.online_triplet_loss(*args, generator=torch.Generator().manual_seed(2),
                               **kw)[2]
    assert torch.equal(a, b) and not torch.equal(a, c)
    g = tt.gumbel(torch.Generator().manual_seed(0), (200000,))
    assert abs(float(g.mean()) - 0.5772) < 0.01  # Euler-Mascheroni


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("compat", [False, True])
def test_combo_losses_match_jax(metric, compat):
    rng = np.random.default_rng(7)
    a, p, x = (rng.normal(size=(6, 8)).astype(np.float32) for _ in range(3))
    ja_, jp, jx = (jnp.asarray(v) for v in (a, p, x))
    ta_, tp, tx = (torch.from_numpy(v) for v in (a, p, x))
    pairs = [
        (tt.pairwise_dist(ta_, tp, metric), j_pairwise_dist(ja_, jp, metric)),
        (tc.rsp_loss(ta_, tp, tx, metric), jc.rsp_loss(ja_, jp, jx, metric)),
        (tc.llc_loss(ta_, tp, tx, 0.04, metric),
         jc.llc_loss(ja_, jp, jx, 0.04, metric)),
        (tc.intra_neg_loss(ta_, tp, tx, metric, reference_compat=compat),
         jc.intra_neg_loss(ja_, jp, jx, metric, reference_compat=compat)),
        (tc.margin_ranking_loss(ta_[:, 0], tp[:, 0], 0.3),
         jc.margin_ranking_loss(ja_[:, 0], jp[:, 0], 0.3)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
