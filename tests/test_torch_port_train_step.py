"""The port's train-mode BatchNorm, optimizer and triplet step against the
JAX package's, on the CPU in float32.

* BatchNorm in train mode: after two forwards the running statistics of
  every layer, ``bn_proj`` at batch 4 included, equal flax's (the biased
  variance, hazard H1) within 1e-5, and the outputs within 1e-4;
* ``make_optimizer`` against optax over 5 updates: SGD with momentum
  and an SGD schedule crossing a milestone within 1e-6, Adam with weight
  decay within 1e-5 (optax takes Adam's bias corrections, 1 - 0.999^t, in
  float32, where they lose ~1e-5 relative; torch in float64);
* two triplet steps (R3D-10, 4 frames of 16 px, 4 anchors, the
  local-local loss on, lr 0.1) from the same weights, batch and Gumbel
  draws (keys split as the JAX step splits them): the loss within 1e-5,
  ``n_triplets`` equal, every parameter and BatchNorm statistic within
  1e-4;
* ``TRAIN.ACCUM_STEPS 2`` against the JAX accumulating step, likewise;
* ``_microbatch_leaf`` against JAX's.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from video_similarity_search_tpu.config import get_cfg as j_get_cfg
from video_similarity_search_tpu.models import model_selector as j_selector
from video_similarity_search_tpu.train import create_train_state
from video_similarity_search_tpu.train import driver as j_driver
from video_similarity_search_tpu.train.checkpoint import \
    torch_resnet3d_to_flax
from video_similarity_search_tpu.train.state import \
    make_optimizer as j_make_optimizer
from video_similarity_search_tpu.train.steps import \
    make_triplet_train_step as j_make_step
from video_similarity_search_tpu_torch.config import get_cfg as t_get_cfg
from video_similarity_search_tpu_torch.models import model_selector as t_selector
from video_similarity_search_tpu_torch.train import driver as t_driver
from video_similarity_search_tpu_torch.train.checkpoint import \
    flax_resnet3d_to_torch
from video_similarity_search_tpu_torch.train.state import \
    make_optimizer as t_make_optimizer
from video_similarity_search_tpu_torch.train.steps import \
    make_triplet_train_step as t_make_step

T, S, B = 4, 16, 4
OPTS = ["MODEL.ARCH", "3dresnet", "RESNET.MODEL_DEPTH", 10,
        "RESNET.NO_MAX_POOl", True, "RESNET.HIDDEN_LAYER", 32,
        "RESNET.OUT_DIM", 8, "DATA.SAMPLE_DURATION", T,
        "DATA.SAMPLE_SIZE", S, "TPU.COMPUTE_DTYPE", "float32",
        "LOSS.LOCAL_LOCAL_CONTRAST", True,
        "DATASET.SAMPLING_STRATEGY", "random_semi_hard",
        "OPTIM.LR", 0.1, "OPTIM.MOMENTUM", 0.5]


def _cfgs(extra=()):
    out = []
    for get in (j_get_cfg, t_get_cfg):
        cfg = get()
        cfg.merge_from_list(list(OPTS) + list(extra))
        out.append(cfg)
    return out


def _models(jcfg, tcfg, seed=0):
    """The same random weights in both packages (BatchNorm affine terms and
    statistics randomized so they matter)."""
    jmodel = j_selector(jcfg)
    variables = jmodel.init(jax.random.key(seed),
                            jnp.zeros((2, T, S, S, 3)), train=False)
    rng = np.random.default_rng(seed)

    def rand(path, v):
        name = jax.tree_util.keystr(path)
        if "BatchNorm" in name and "scale" in name:
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if "BatchNorm" in name and "bias" in name:
            return rng.normal(0, 0.1, v.shape).astype(np.float32)
        return np.asarray(v)

    params = jax.tree_util.tree_map_with_path(rand, variables["params"])
    stats = jax.tree.map(
        lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32),
        variables["batch_stats"])
    tmodel = t_selector(tcfg)
    tmodel.load_state_dict(flax_resnet3d_to_torch(params, stats))
    return jmodel, params, stats, tmodel


def _flax_trees(tmodel):
    sd = {k: v.detach().numpy() for k, v in tmodel.state_dict().items()}
    return torch_resnet3d_to_flax(sd)


def _assert_trees_close(got, want, atol):
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(want_leaves) == len(got_leaves)
    for path, leaf in want_leaves:
        np.testing.assert_allclose(np.asarray(got_leaves[path]),
                                   np.asarray(leaf), atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def test_train_mode_batchnorm_running_stats_match_flax():
    jcfg, tcfg = _cfgs()
    jmodel, params, stats, tmodel = _models(jcfg, tcfg)
    rng = np.random.default_rng(1)
    tmodel.train()
    for i in range(2):  # batch 4: bn_proj's n/(n-1) is 4/3
        x = rng.normal(0.3, 1.2, size=(4, T, S, S, 3)).astype(np.float32)
        want, mut = jmodel.apply({"params": params, "batch_stats": stats},
                                 jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
        stats = mut["batch_stats"]
        with torch.no_grad():
            got = tmodel(torch.from_numpy(x))
        # train-mode outputs: batch-4 statistics amplify conv rounding
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    _, t_stats = _flax_trees(tmodel)
    # the projection head's variance is the biased one: torch's own update
    # would be off by up to the factor 4/3 here
    _assert_trees_close(t_stats, stats, atol=1e-5)


@pytest.mark.parametrize("opt,extra", [
    ("sgd", []),
    ("adam", ["OPTIM.WD", 0.01]),
    ("sgd", ["OPTIM.SCHEDULE", [1, 2]]),  # boundaries at updates 2 and 4
])
def test_make_optimizer_matches_optax(opt, extra):
    jcfg, tcfg = _cfgs(["OPTIM.OPTIMIZER", opt, "OPTIM.WD", 0.05] + extra)
    rng = np.random.default_rng(2)
    init = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,))]
    tx = j_make_optimizer(jcfg, steps_per_epoch=2)
    jp = [jnp.asarray(v) for v in init]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in init]
    topt, sched = t_make_optimizer(tcfg, tp, steps_per_epoch=2)
    for step in range(5):
        grads = [rng.normal(size=v.shape).astype(np.float32) for v in init]
        updates, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g)
        topt.step()
        sched.step()
        for p, q in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(q),
                                       atol=1e-5 if opt == "adam" else 1e-6,
                                       err_msg=f"update {step}")
    if extra and extra[0] == "OPTIM.SCHEDULE":
        assert sched.lr() == pytest.approx(0.1 * 0.01)


def _batch(rng, lead=()):
    clips = {k: rng.normal(size=lead + (B, T, S, S, 3)).astype(np.float32)
             for k in ("anchor", "positive", "extra")}
    # anchors of two classes; each positive shares its anchor's label
    a_t = rng.integers(0, 2, lead + (B,)).astype(np.int32)
    clips["targets"] = np.concatenate([a_t, a_t], axis=-1)
    return clips


def _run_both(accum, n_steps):
    jcfg, tcfg = _cfgs(["TRAIN.ACCUM_STEPS", accum])
    jmodel, params, stats, tmodel = _models(jcfg, tcfg, seed=3)
    state = create_train_state(jax.random.key(0), jmodel, jcfg,
                               jnp.zeros((2, T, S, S, 3)))
    state = state.replace(params=jax.tree.map(jnp.asarray, params),
                          batch_stats=jax.tree.map(jnp.asarray, stats))
    jstep = j_make_step(jcfg)
    optimizer, schedule = t_make_optimizer(tcfg, tmodel.parameters())
    tstep = t_make_step(tcfg, tmodel, optimizer, schedule, device="cpu")
    rng = np.random.default_rng(4)
    lead = (accum,) if accum > 1 else ()
    n = 2 * B
    for i in range(n_steps):
        batch = _batch(rng, lead)
        key = jax.random.key(10 + i)
        # the miner's draws, split as the JAX step splits its key
        if accum > 1:
            noise = [torch.from_numpy(np.array(jax.random.gumbel(
                jax.random.split(k)[0], (n, n, n), dtype=jnp.float32)))
                for k in jax.random.split(key, accum)]
        else:
            noise = torch.from_numpy(np.array(jax.random.gumbel(
                jax.random.split(key)[0], (n, n, n), dtype=jnp.float32)))
        state, jm = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()},
                          key)
        tm = tstep({k: torch.from_numpy(v).long() if k == "targets"
                    else torch.from_numpy(v) for k, v in batch.items()},
                   noise=noise)
        assert int(tm["n_triplets"]) == int(jm["n_triplets"]) > 0
        for k in ("loss", "triplet_loss", "aux_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5,
                                       err_msg=f"step {i} {k}")
    t_params, t_stats = _flax_trees(tmodel)
    _assert_trees_close(t_params, state.params, atol=1e-4)
    _assert_trees_close(t_stats, state.batch_stats, atol=1e-4)
    return tm


def test_two_triplet_steps_match_jax():
    tm = _run_both(accum=1, n_steps=2)
    assert tm["negatives"].shape == (2 * B, 2 * B)


def test_accumulation_step_matches_jax():
    tm = _run_both(accum=2, n_steps=1)
    assert tm["negatives"].shape == (2, 2 * B, 2 * B)


def test_mem_triplet_raises():
    _, tcfg = _cfgs(["LOSS.MEM_TRIPLET", True])
    model = t_selector(tcfg)
    opt, sched = t_make_optimizer(tcfg, model.parameters())
    with pytest.raises(NotImplementedError, match="item 15"):
        t_make_step(tcfg, model, opt, sched, device="cpu")


@pytest.mark.parametrize("name,shape,accum", [
    ("targets", (12,), 2), ("targets", (12,), 3), ("anchor", (6, 3), 2),
    ("index", (6,), 3), ("targets", (10,), 5)])
def test_microbatch_leaf_matches_jax(name, shape, accum):
    x = np.arange(int(np.prod(shape))).reshape(shape)
    np.testing.assert_array_equal(t_driver._microbatch_leaf(name, x, accum),
                                  j_driver._microbatch_leaf(name, x, accum))
    dev = torch.zeros(2, 3)  # an uploaded leaf passes through
    assert t_driver._microbatch_leaf(name, dev, accum) is dev
