"""The port's LOSS.MEM_TRIPLET (triplets against a labelled FIFO bank)
against the JAX package's, on the CPU in float32.

* ``MemTripletLoss`` against ``mem_triplet_loss`` over three calls from
  the same JAX-initialised bank, for every margin strategy, with JAX's
  Gumbel draws injected: the bank (queue, labels, pointer) equal, the
  negatives picked equal to the JAX strategy dispatch's on the same
  distances, the loss and ``n_triplets`` equal and the gradient with
  respect to the embeddings within 1e-6;
* the triplet step with ``LOSS.MEM_TRIPLET`` (R3D-10 at an eighth of its
  width, 4 frames of 16 px, 4 anchors, a 16-slot bank) against the JAX step: two steps, and one
  step of ``TRAIN.ACCUM_STEPS 2`` (the bank advances once a microbatch),
  each with the bank, every parameter and BatchNorm statistic within
  1e-4 and the loss within 5e-5 (after one SGD step at lr 0.1 the two
  packages' float32 losses of ~0.7 drift apart by ~2e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_train_step as base
from video_similarity_search_tpu.losses.mem_triplet import (
    init_mem_triplet_state, mem_triplet_loss)
from video_similarity_search_tpu.losses.triplet import \
    select_negative_indices as j_select
from video_similarity_search_tpu.ops.pdist import \
    pairwise_distance as j_pdist
from video_similarity_search_tpu.train import create_train_state
from video_similarity_search_tpu.train.steps import \
    make_triplet_train_step as j_make_step
from video_similarity_search_tpu_torch.losses.mem_triplet import \
    MemTripletLoss
from video_similarity_search_tpu_torch.train.checkpoint import \
    load_bank_state
from video_similarity_search_tpu_torch.train.state import \
    make_optimizer as t_make_optimizer
from video_similarity_search_tpu_torch.train.steps import \
    make_triplet_train_step as t_make_step

K, D, N = 16, 8, 8  # bank slots, embedding width, 2B embeddings a call
MARGIN = 0.2


def _fields(state):
    return {f: np.asarray(getattr(state, f))
            for f in ("queue", "label_q", "queue_ptr")}


def _assert_bank(bank, state, atol=0.0):
    want = _fields(state)
    np.testing.assert_allclose(bank.queue.detach().numpy(), want["queue"],
                               atol=atol)
    np.testing.assert_array_equal(bank.label_q.numpy(), want["label_q"])
    assert int(bank.queue_ptr) == int(want["queue_ptr"])


def _jax_picks(state, emb, labels, key, strategy):
    """The negatives the JAX loss picks: its strategy dispatch on the
    distances after the enqueue, as ``mem_triplet_loss`` forms them."""
    ptr = int(state.queue_ptr)
    queue = state.queue.at[ptr:ptr + N].set(emb)
    label_q = state.label_q.at[ptr:ptr + N].set(labels)
    dist = j_pdist(emb, queue, metric="cosine")
    neg_mask = label_q[None, :] != labels[:, None]
    d_ap = dist[:, ptr + jnp.arange(N)]
    pair_loss = d_ap[:, :, None] + MARGIN - dist[:, None, :]
    neg3 = jnp.broadcast_to(neg_mask[:, None, :], pair_loss.shape)
    easy = jnp.where(neg_mask, dist, jnp.inf)
    return np.asarray(j_select(pair_loss, neg3, easy, strategy, key))


@pytest.mark.parametrize("strategy", ["random_semi_hard", "random_negative",
                                      "fixed_semi_hard", "adapted_hard"])
def test_mem_triplet_loss_matches_jax_over_three_calls(strategy):
    state = init_mem_triplet_state(jax.random.key(9), K=K, dim=D)
    bank = MemTripletLoss(K=K, dim=D)
    load_bank_state(bank, _fields(state))
    rng = np.random.default_rng(0)
    for call in range(3):
        emb = rng.normal(size=(N, D)).astype(np.float32)
        labels = rng.integers(0, 3, N).astype(np.int32)
        key = jax.random.key(20 + call)
        picks = _jax_picks(state, jnp.asarray(emb), jnp.asarray(labels), key,
                           strategy)

        def jloss(e, st):
            loss, n, new = mem_triplet_loss(st, e, jnp.asarray(labels), key,
                                            margin=MARGIN,
                                            sampling_strategy=strategy)
            return loss, (n, new)

        (jl, (jn, state)), jg = jax.value_and_grad(jloss, has_aux=True)(
            jnp.asarray(emb), state)
        noise = torch.from_numpy(np.array(jax.random.gumbel(
            key, (N, N, K), dtype=jnp.float32)))
        temb = torch.from_numpy(emb).requires_grad_(True)
        tl, tn, tpicks = bank(temb, torch.from_numpy(labels).long(),
                              margin=MARGIN, sampling_strategy=strategy,
                              noise=noise)
        tl.backward()
        _assert_bank(bank, state)
        assert int(tn) == int(jn)
        np.testing.assert_array_equal(tpicks.numpy(), picks)
        np.testing.assert_allclose(float(tl.detach()), float(jl), atol=1e-6)
        np.testing.assert_allclose(temb.grad.numpy(), np.asarray(jg),
                                   atol=1e-6)


@pytest.mark.parametrize("accum,n_steps", [(1, 2), (2, 1)])
def test_mem_triplet_step_matches_jax(accum, n_steps):
    """``random_negative`` mining: its picks depend on the labels and the
    draws alone. A semi-hard pick at the edge d_ap + margin = d_an adds
    ~0 to the loss but a whole pair to the gradient, so float32 rounding
    there would move the update without moving the loss."""
    extra = ["TRAIN.ACCUM_STEPS", accum, "LOSS.MEM_TRIPLET", True,
             "LOSS.MEM_TRIPLET_K", K,
             "DATASET.SAMPLING_STRATEGY", "random_negative",
             "RESNET.WIDEN_FACTOR", 0.125]
    jcfg, tcfg = base._cfgs(extra)
    jmodel, params, stats, tmodel = base._models(jcfg, tcfg, seed=3)
    dim = jcfg.RESNET.OUT_DIM
    state = create_train_state(jax.random.key(0), jmodel, jcfg,
                               jnp.zeros((2, base.T, base.S, base.S, 3)))
    state = state.replace(
        params=jax.tree.map(jnp.asarray, params),
        batch_stats=jax.tree.map(jnp.asarray, stats),
        mem_triplet=init_mem_triplet_state(jax.random.key(9), K=K, dim=dim))
    bank = MemTripletLoss(K=K, dim=dim)
    load_bank_state(bank, _fields(state.mem_triplet))
    jstep = j_make_step(jcfg)
    optimizer, schedule = t_make_optimizer(tcfg, tmodel.parameters())
    tstep = t_make_step(tcfg, tmodel, optimizer, schedule, device="cpu",
                        bank=bank)
    rng = np.random.default_rng(4)
    n = 2 * base.B // accum * accum  # 2B embeddings a microbatch
    lead = (accum,) if accum > 1 else ()
    for i in range(n_steps):
        batch = base._batch(rng, lead)
        for v in ("anchor", "positive", "extra"):  # BN variances near 1
            batch[v] *= 0.05
        key = jax.random.key(10 + i)
        keys = jax.random.split(key, accum) if accum > 1 else [key]
        noise = [torch.from_numpy(np.array(jax.random.gumbel(
            jax.random.split(k)[0], (n, n, K), dtype=jnp.float32)))
            for k in keys]
        state, jm = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()},
                          key)
        tm = tstep({k: torch.from_numpy(v).long() if k == "targets"
                    else torch.from_numpy(v) for k, v in batch.items()},
                   noise=noise if accum > 1 else noise[0])
        assert int(tm["n_triplets"]) == int(jm["n_triplets"])
        for k in ("loss", "triplet_loss", "aux_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=5e-5,
                                       err_msg=f"step {i} {k}")
        _assert_bank(bank, state.mem_triplet, atol=1e-4)
    t_params, t_stats = base._flax_trees(tmodel)
    base._assert_trees_close(t_params, state.params, atol=1e-4)
    base._assert_trees_close(t_stats, state.batch_stats, atol=1e-4)
