"""The port's contrastive step (LOSS.TYPE contrastive: NCEAverage, its
intra-negative variant and the MemoryMoCo queue) against the JAX
package's, on the CPU.

* the views: ``diff_view`` and ``shuffle_view`` (JAX's per-clip block
  permutations injected, an odd trailing frame included) equal JAX's;
* the bank modules against ``nce_average``, ``nce_average_intra_neg`` and
  ``memory_moco`` from JAX-initialised banks (the NCE path with its
  first-batch Z estimate too), ``nce_criterion`` and ``nce_softmax_loss``;
  ``AliasMethod``'s tables equal JAX's and its draws follow the
  distribution;
* the step (R3D-10 at an eighth of its width, 4 frames of 16 px, 4
  clips, K 6 negatives over 20 videos, temperature 0.5, lr 0.01) for ``rgb``, ``res``,
  intra-negative, ``LOSS.MOCO`` and ``TRAIN.ACCUM_STEPS 2``, two steps
  from the same weights and banks with JAX's draws injected, the networks
  in float64 on both sides: the metrics within 1e-5 relative, every
  parameter and BatchNorm statistic within 1e-4 and the banks within 1e-6
  after each step. The banks and losses stay float32, as in the JAX step,
  and at init their rounding moves the float64 update by ~3e-7, enough to
  move the next step's float32 bank rows by ~3e-6; so the second step
  starts both packages from the port's weights. (At temperature 0.07 the
  random features' logits reach ~800 by the second step, where float32
  softmax gradients are mostly rounding: 1 - p at p = 1 - 3e-6.) Each view is normalized
  by its own batch statistics (ROADMAP hazard H8);
* the banks' checkpoint round trip, and the training CLI with
  ``LOSS.TYPE contrastive`` and k-means clustering for an epoch, then
  resumed: the resumed run starts from the saved banks.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_train_step as base
from synthetic_data import make_synthetic_ucf
from video_similarity_search_tpu.losses import nce as jnce
from video_similarity_search_tpu.models import model_selector as j_selector
from video_similarity_search_tpu.train import create_train_state
from video_similarity_search_tpu.train import steps as jsteps
from video_similarity_search_tpu_torch.cli import online_train as t_cli
from video_similarity_search_tpu_torch.losses import nce as tnce
from video_similarity_search_tpu_torch.train import checkpoint as t_ckpt
from video_similarity_search_tpu_torch.train import driver as t_driver
from video_similarity_search_tpu_torch.train import steps as tsteps
from video_similarity_search_tpu_torch.train.checkpoint import \
    load_bank_state
from video_similarity_search_tpu_torch.train.state import \
    make_optimizer as t_make_optimizer

N_DATA, NEG_K, FEAT = 20, 6, 8


def _fields(state):
    return {k: (None if v is None else np.asarray(v))
            for k, v in vars(state).items()}


def _assert_bank(bank, state, atol):
    for k, v in _fields(state).items():
        if v is not None:
            # the NCE constants Z are ~1e6: relative there
            np.testing.assert_allclose(getattr(bank, k).numpy(), v,
                                       atol=atol, rtol=1e-6, err_msg=k)


def test_views_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 4, 4, 2)).astype(np.float32)  # T=5: a tail
    np.testing.assert_allclose(tsteps.diff_view(torch.from_numpy(x)).numpy(),
                               np.asarray(jsteps.diff_view(jnp.asarray(x))),
                               atol=1e-7)
    key = jax.random.key(3)
    perms = np.array(jax.vmap(lambda k: jax.random.permutation(k, 2))(
        jax.random.split(key, 3)))
    want = np.asarray(jsteps.shuffle_view(jnp.asarray(x), key))
    got = tsteps.shuffle_view(torch.from_numpy(x), torch.from_numpy(perms))
    np.testing.assert_array_equal(got.numpy(), want)
    drawn = tsteps.shuffle_view(torch.from_numpy(x),
                                generator=torch.Generator().manual_seed(0))
    assert torch.equal(drawn[:, 4], torch.from_numpy(x)[:, 4])


def _nce_idx(key, y, n_data=N_DATA, k=NEG_K):
    return np.array(jnce._draw_indices(key, jnp.asarray(y), n_data, k))


@pytest.mark.parametrize("intra_neg,softmax", [(False, True), (False, False),
                                               (True, True)])
def test_nce_average_matches_jax(intra_neg, softmax):
    state = jnce.init_nce_state(jax.random.key(7), N_DATA, FEAT,
                                intra_neg=intra_neg)
    bank = tnce.NCEAverage(N_DATA, FEAT, K=NEG_K, T=0.07, momentum=0.5,
                           use_softmax=softmax, intra_neg=intra_neg)
    load_bank_state(bank, _fields(state))
    rng = np.random.default_rng(1)
    for call in range(2):
        l, ab, neg = (rng.normal(size=(4, FEAT)).astype(np.float32)
                      for _ in range(3))
        y = rng.choice(N_DATA, 4, replace=False)
        key = jax.random.key(call)
        kw = dict(K=NEG_K, T=0.07, momentum=0.5, use_softmax=softmax)
        if intra_neg:
            jl, jab, state = jnce.nce_average_intra_neg(
                state, jnp.asarray(l), jnp.asarray(ab), jnp.asarray(neg),
                jnp.asarray(y), key, **kw)
        else:
            jl, jab, state = jnce.nce_average(
                state, jnp.asarray(l), jnp.asarray(ab), jnp.asarray(y), key,
                **kw)
        tl, tab = bank(torch.from_numpy(l), torch.from_numpy(ab),
                       torch.from_numpy(y), neg=torch.from_numpy(neg),
                       idx=torch.from_numpy(_nce_idx(key, y)))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
        np.testing.assert_allclose(tab.numpy(), np.asarray(jab), rtol=1e-5)
        _assert_bank(bank, state, atol=1e-6)
        if not softmax:
            np.testing.assert_allclose(
                float(tnce.nce_criterion(tl, N_DATA)),
                float(jnce.nce_criterion(jl, N_DATA)), rtol=1e-5)
        np.testing.assert_allclose(float(tnce.nce_softmax_loss(tab)),
                                   float(jnce.nce_softmax_loss(jab)),
                                   rtol=1e-5)


@pytest.mark.parametrize("softmax", [True, False])
def test_memory_moco_matches_jax(softmax):
    state = jnce.init_memory_moco(jax.random.key(7), K=8, feat_dim=FEAT)
    bank = tnce.MemoryMoCo(8, FEAT, T=0.07, use_softmax=softmax,
                           n_data=N_DATA)
    load_bank_state(bank, _fields(state))
    rng = np.random.default_rng(2)
    for _ in range(3):  # 3 x 3 keys wrap the 8-slot queue
        q, k = (rng.normal(size=(3, FEAT)).astype(np.float32)
                for _ in range(2))
        logits = jnce.memory_moco_logits(state.memory, jnp.asarray(k),
                                         jnp.asarray(q))
        np.testing.assert_allclose(
            tnce.memory_moco_logits(bank.memory, torch.from_numpy(k),
                                    torch.from_numpy(q)).numpy(),
            np.asarray(logits), rtol=1e-5)
        jout, state = jnce.memory_moco(state, jnp.asarray(q), jnp.asarray(k),
                                       use_softmax=softmax, n_data=N_DATA)
        tout = bank(torch.from_numpy(q), torch.from_numpy(k))
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5)
        _assert_bank(bank, state, atol=1e-7)


def test_alias_method_tables_and_draws():
    probs = np.array([0.1, 0.4, 0.2, 0.3])
    j, t = jnce.AliasMethod(probs), tnce.AliasMethod(probs)
    np.testing.assert_array_equal(t.prob, j.prob)
    np.testing.assert_array_equal(t.alias, j.alias)
    draws = t.draw(40000, torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_allclose(np.bincount(draws, minlength=4) / 40000,
                               probs, atol=0.01)


@pytest.fixture
def jax_float64(monkeypatch):
    """JAX in float64: x64 on and the JAX BatchNorm's compute dtype at
    float64."""
    import video_similarity_search_tpu.models.layers as j_layers
    monkeypatch.setattr(j_layers, "_bn_compute_dtype", lambda: jnp.float64)
    with jax.enable_x64(True):
        yield


CASES = {"rgb": ("rgb", False, False, 1), "res": (False, False, False, 1),
         "intra_neg": ("rgb", True, False, 1), "moco": (False, False, True, 1),
         "rgb_accum2": ("rgb", False, False, 2)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_contrastive_step_matches_jax(case, jax_float64):
    modality, intra, moco, accum = CASES[case]
    extra = ["LOSS.TYPE", "contrastive", "DATASET.MODALITY", modality,
             "LOSS.INTRA_NEGATIVE", intra, "LOSS.MOCO", moco,
             "LOSS.K", NEG_K, "LOSS.FEAT_DIM", FEAT, "LOSS.T", 0.5,
             "OPTIM.LR", 0.01,
             "TRAIN.ACCUM_STEPS", accum, "RESNET.WIDEN_FACTOR", 0.125]
    jcfg, tcfg = base._cfgs(extra)
    jmodel = j_selector(jcfg, dtype=jnp.float64)
    _, params, stats, tmodel = base._models(jcfg, tcfg, seed=3)
    params, stats = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64),
                                 (params, stats))
    tmodel.double()
    state = create_train_state(jax.random.key(0), jmodel, jcfg,
                               jnp.zeros((2, base.T, base.S, base.S, 3)))
    state = state.replace(params=params, batch_stats=stats,
                          opt_state=state.tx.init(params))
    use_moco = moco and not intra
    if use_moco:
        state = state.replace(memory_moco=jnce.init_memory_moco(
            jax.random.key(7), K=NEG_K, feat_dim=FEAT))
        jbank = lambda st: st.memory_moco  # noqa: E731
    else:
        state = state.replace(nce=jnce.init_nce_state(
            jax.random.key(7), N_DATA, FEAT, intra_neg=intra))
        jbank = lambda st: st.nce  # noqa: E731
    mod = t_driver.contrastive_modality(tcfg)
    jstep = jsteps.make_contrastive_train_step(
        jcfg, N_DATA, modality=mod, intra_neg=intra, use_moco=use_moco)
    banks = tsteps.make_banks(tcfg, N_DATA)
    bank = banks["memory_moco" if use_moco else "nce"]
    load_bank_state(bank, _fields(jbank(state)))
    optimizer, schedule = t_make_optimizer(tcfg, tmodel.parameters())
    tstep = tsteps.make_contrastive_train_step(
        tcfg, tmodel, optimizer, schedule, bank, modality=mod,
        intra_neg=intra, use_moco=use_moco, device="cpu")
    rng = np.random.default_rng(4)
    lead = (accum, base.B // accum) if accum > 1 else (base.B,)
    for i in range(2):
        # clips at a twentieth of unit scale: the narrow stem's outputs
        # then have BatchNorm variances near 1, not near 1e3
        batch = {v: 0.05 * rng.normal(size=lead + (base.T, base.S, base.S, 3))
                 for v in ("view1", "view2")}
        batch["index"] = rng.choice(N_DATA, base.B, replace=False).reshape(
            lead)
        key = jax.random.key(10 + i)
        idx, perms = [], []
        for k in (jax.random.split(key, accum) if accum > 1 else [key]):
            nce_key, view_key, _ = jax.random.split(k, 3)
            y = batch["index"][len(idx)] if accum > 1 else batch["index"]
            idx.append(torch.from_numpy(_nce_idx(nce_key, y)))
            perms.append(torch.from_numpy(np.array(jax.vmap(
                lambda kk: jax.random.permutation(kk, base.T // 2))(
                jax.random.split(view_key, len(y))))))
        state, jm = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()},
                          key)
        pick = (lambda v: v) if accum > 1 else (lambda v: v[0])
        tm = tstep({k: torch.from_numpy(v) for k, v in batch.items()},
                   nce_idx=pick(idx), shuffle_perm=pick(perms))
        for k in ("loss", "view1_loss", "view2_loss", "view1_prob",
                  "view2_prob"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"step {i} {k}")
        _assert_bank(bank, jbank(state), atol=1e-6)
        t_params, t_stats = base._flax_trees(tmodel)
        base._assert_trees_close(t_params, state.params, atol=1e-4)
        base._assert_trees_close(t_stats, state.batch_stats, atol=1e-4)
        # the next step starts from the port's weights in both packages
        state = state.replace(params=t_params, batch_stats=t_stats)


def test_bank_checkpoint_round_trip(tmp_path, capsys):
    banks = {"nce": tnce.NCEAverage(N_DATA, FEAT, K=NEG_K, intra_neg=True),
             "memory_moco": tnce.MemoryMoCo(8, FEAT, use_softmax=True)}
    banks["nce"](torch.randn(3, FEAT), torch.randn(3, FEAT),
                 torch.tensor([1, 5, 7]), neg=torch.randn(3, FEAT),
                 generator=torch.Generator().manual_seed(0))
    banks["memory_moco"](torch.randn(3, FEAT), torch.randn(3, FEAT))
    model = torch.nn.Linear(2, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    sched = type("S", (), {"state_dict": lambda self: {"count": 0},
                           "load_state_dict": lambda self, d: None,
                           "count": 0})()
    path = t_ckpt.save_checkpoint(str(tmp_path), "3dresnet", model, opt,
                                  sched, 0, 0.0, banks=banks)
    payload = t_ckpt.load_checkpoint(path)
    fresh = {"nce": tnce.NCEAverage(N_DATA, FEAT, K=NEG_K, intra_neg=True,
                                    seed=1)}
    t_ckpt.restore_train_state(model, opt, sched, payload, banks=fresh)
    for k, v in banks["nce"].state_dict().items():
        assert torch.equal(fresh["nce"].state_dict()[k], v), k
    assert "discarding it" in capsys.readouterr().out  # memory_moco


YAML = ("MODEL:\n  ARCH: 3dresnet\nRESNET:\n  MODEL_DEPTH: 10\n"
        "  NO_MAX_POOl: true\n  HIDDEN_LAYER: 32\n  OUT_DIM: 8\n"
        f"DATA:\n  SAMPLE_SIZE: {base.S}\n  SAMPLE_DURATION: {base.T}\n"
        "TRAIN:\n  DATASET: ucf101\n  BATCH_SIZE: 4\n  EPOCHS: 1\n"
        "  NUM_DATA_WORKERS: 2\n  LOG_INTERVAL: 100\n"
        "  RETRIEVAL_INTERVAL: 1\n"
        "VAL:\n  BATCH_SIZE: 4\n"
        "LOSS:\n  TYPE: contrastive\n  K: 6\n  FEAT_DIM: 8\n"
        "  INTRA_NEGATIVE: true\n"
        "OPTIM:\n  LR: 0.01\n"
        "ITERCLUSTER:\n  METHOD: kmeans\n  K: 3\n  INTERVAL: 1\n"
        "TPU:\n  COMPUTE_DTYPE: float32\n")


def test_contrastive_cli_resumes_its_banks(tmp_path, monkeypatch):
    vid, ann = make_synthetic_ucf(str(tmp_path / "data"))
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(YAML)
    out = str(tmp_path / "out")
    argv = ["--cfg", str(cfg), "--iterative_cluster", "--output", out,
            "--device", "cpu", "DATASET.VID_PATH", vid,
            "DATASET.ANNOTATION_PATH", ann]
    t_cli.main(argv)
    logs = os.path.join(out, "tnet_checkpoints")
    with open(os.path.join(logs, "train_loss_and_acc.txt")) as f:
        assert len(f.read().splitlines()) == 1
    saved = torch.load(os.path.join(logs, "3dresnet", "checkpoint.pth.tar"),
                       weights_only=False)["banks"]["nce"]
    assert set(saved) == {"memory_l", "memory_ab", "memory_neg", "z_l",
                          "z_ab"}
    seen = {}
    make_step = tsteps.make_contrastive_train_step

    def spy(cfg, model, optimizer, schedule, bank, **kw):
        seen.update({k: v.clone() for k, v in bank.state_dict().items()})
        return make_step(cfg, model, optimizer, schedule, bank, **kw)

    monkeypatch.setattr(tsteps, "make_contrastive_train_step", spy)
    t_cli.main(argv[:5] + ["--checkpoint_path", out] + argv[5:]
               + ["TRAIN.EPOCHS", "2"])
    assert seen.keys() == saved.keys()
    assert all(torch.equal(seen[k], v) for k, v in saved.items())
    with open(os.path.join(logs, "NMIs.txt")) as f:
        assert len(f.read().splitlines()) == 2  # k-means ran each epoch
