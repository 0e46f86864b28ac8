"""The port's MoCo InfoNCE / UberNCE (``models/moco.py``, the step, the
epoch and the CLI with LOSS.TYPE UberNCE) against the JAX package's, on
the CPU, S3D on 8x32x32 clips.

* ``MoCoEncoder`` with JAX's weights (``flax_moco_encoder_to_torch``) in
  eval mode within 1e-5, its names read back by the JAX importer, and a
  reference InfoNCE ``.pth.tar`` loaded into it;
* ``infonce_forward`` / ``ubernce_forward`` from a JAX ``MoCoState``
  carried across by ``load_bank_state`` (key parameters, queue, pointer,
  labels): logits within 1e-5 relative, the mask equal;
* two steps of ``make_moco_train_step`` per arch (4 anchors, K 8, so the
  queue wraps; lr 0.01) on the same queue, the networks in float64 on both
  sides: the loss, the parameters, the key parameters, the queue, the
  pointer and the labels within 1e-4. The queue and the logits stay
  float32, as in the JAX step, and their rounding moves the first update
  by ~6e-7, and S3D at random init amplifies that ~1e5-fold in the
  second (the two packages' stem updates then differ by 0.1); so the
  second step starts both packages from the port's weights, key weights
  and queue, as the contrastive step test does;
* the ring buffer past K against JAX's ``dequeue_and_enqueue``, the
  ``K % batch`` assertion, and hazard H9: the key forward leaves every
  running statistic of the key encoder as it was;
* the training CLI with ``LOSS.TYPE UberNCE`` for an epoch, then resumed:
  the resumed run starts from the saved ``moco`` bank.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_data import make_synthetic_ucf
from test_torch_port_s3d import assert_close, japply, random_variables
from video_similarity_search_tpu.config import get_cfg as j_get_cfg
from video_similarity_search_tpu.models import layers as j_layers
from video_similarity_search_tpu.models import model_selector as j_selector
from video_similarity_search_tpu.models import moco as jmoco
from video_similarity_search_tpu.train import checkpoint as j_ckpt
from video_similarity_search_tpu.train.state import TrainState
from video_similarity_search_tpu.train.state import \
    make_optimizer as j_make_optimizer
from video_similarity_search_tpu.train import steps as jsteps
from video_similarity_search_tpu_torch.cli import online_train as t_cli
from video_similarity_search_tpu_torch.config import get_cfg as t_get_cfg
from video_similarity_search_tpu_torch.models import model_selector as t_selector
from video_similarity_search_tpu_torch.models import moco as tmoco
from video_similarity_search_tpu_torch.train import checkpoint as t_ckpt
from video_similarity_search_tpu_torch.train import steps as tsteps
from video_similarity_search_tpu_torch.train.state import \
    make_optimizer as t_make_optimizer

CLIP = (8, 32, 32, 3)
B, K, DIM = 4, 8, 128


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    opts = ["MODEL.ARCH", arch, "LOSS.TYPE", "UberNCE", "LOSS.K", K,
            "DATA.SAMPLE_DURATION", CLIP[0], "DATA.SAMPLE_SIZE", CLIP[1],
            "TPU.COMPUTE_DTYPE", "float32", "OPTIM.LR", 0.01,
            "OPTIM.MOMENTUM", 0.5]
    out = []
    for get in (j_get_cfg, t_get_cfg):
        cfg = get()
        cfg.merge_from_list(opts)
        out.append(cfg)
    return out


def _clips(b, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=(b,) + CLIP)
            ).astype(np.float32)


def _fields(state):
    return {k: (None if v is None else jax.tree.map(np.asarray, v))
            for k, v in vars(state).items()}


@pytest.fixture(scope="module")
def encoders():
    """The JAX MoCoEncoder with seeded weights and the port's with them."""
    jcfg, tcfg = _cfgs("uber_nce")
    jm = j_selector(jcfg)
    params, stats = random_variables(jm, jnp.zeros((1,) + CLIP), seed=21)
    return jm, params, stats, tcfg


def _port_encoder(tcfg, params, stats):
    tm = t_selector(tcfg)
    tm.load_state_dict(t_ckpt.flax_moco_encoder_to_torch(params, stats))
    return tm


def _moco_state(params, stats, uber, seed=7):
    return jmoco.init_moco_state(params, stats, jax.random.key(seed),
                                 dim=DIM, K=K, with_labels=uber)


def _port_bank(tcfg, tm, state):
    bank = tsteps.make_banks(tcfg, 0, tm)["moco"]
    t_ckpt.load_bank_state(bank, _fields(state))
    return bank


def test_moco_encoder_matches_jax(encoders, tmp_path):
    jm, params, stats, tcfg = encoders
    x = _clips(2, seed=1)
    want = japply(jm, {"params": params, "batch_stats": stats}, x,
                  train=False)
    tm = _port_encoder(tcfg, params, stats).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (2, 128)
    assert_close(got.numpy(), np.asarray(want), 1e-5)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    assert {"encoder_q.0.Conv_1a.conv1.weight", "encoder_q.2.weight",
            "encoder_q.4.bias"} <= set(sd)
    p2, s2 = j_ckpt.torch_moco_encoder_to_flax(sd)
    for tree, want_tree in ((p2, params), (s2, stats)):
        for path, leaf in jax.tree_util.tree_leaves_with_path(want_tree):
            got_leaf = dict(jax.tree_util.tree_leaves_with_path(tree))[path]
            np.testing.assert_allclose(np.asarray(got_leaf), leaf,
                                       atol=1e-7)
    # a reference InfoNCE file (DDP prefix, the key encoder and queue
    # beside the query encoder) loads every query tensor: its encoder_q.0.
    # comes back from load_torch_checkpoint's backbone. remap
    ref = {"module." + k: v for k, v in tm.state_dict().items()}
    ref.update({"module.encoder_k.2.weight": torch.zeros(1),
                "module.queue": torch.zeros(K, DIM)})
    path = str(tmp_path / "infonce.pth.tar")
    torch.save({"state_dict": ref}, path)
    fresh = t_selector(tcfg)
    got = t_ckpt.load_encoder_state(
        fresh, t_ckpt.load_torch_checkpoint(path)["torch_state_dict"])
    assert got["missing"] == [] and sorted(got["skipped"]) == [
        "encoder_k.2.weight", "queue"]
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, tm.state_dict()[k]), k


@pytest.mark.parametrize("uber", [False, True], ids=["info_nce", "uber_nce"])
def test_moco_forward_matches_jax(encoders, uber, monkeypatch):
    """The query in train mode, the key encoder carried across with the
    queue: logits within 1e-5 relative, UberNCE's mask equal. float64 on
    both sides, so train-mode BatchNorm at batch 4 does not amplify
    float32 rounding (the logits are float32 in both)."""
    _, params, stats, _ = encoders
    jcfg, tcfg = _cfgs("uber_nce" if uber else "info_nce")
    monkeypatch.setattr(j_layers, "_bn_compute_dtype", lambda: jnp.float64)
    with jax.enable_x64(True):
        jm64 = j_selector(jcfg, dtype=jnp.float64)
        p64, s64 = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64),
                                (params, stats))
        state = _moco_state(p64, s64, uber)
        labels = np.array([0, 1, 0, 2])
        state = state.replace(queue_labels=jnp.asarray(
            [0, 1, 2, 3, 1, 1, 5, 0], jnp.int32)) if uber else state
        x1, x2 = _clips(B, seed=2, scale=0.5), _clips(B, seed=3, scale=0.5)
        qv = {"params": p64, "batch_stats": s64}
        xs = (jnp.asarray(x1, jnp.float64), jnp.asarray(x2, jnp.float64))
        if uber:
            logits, mask, keys, _ = jax.jit(
                lambda *a: jmoco.ubernce_forward(jm64, *a))(
                qv, state, *xs, jnp.asarray(labels))
        else:
            logits, _, keys, _ = jax.jit(
                lambda *a: jmoco.infonce_forward(jm64, *a))(qv, state, *xs)
    tm = _port_encoder(tcfg, params, stats)
    bank = _port_bank(tcfg, tm, jax.tree.map(
        lambda v: np.asarray(v, np.float32) if v.dtype == np.float64 else v,
        state))
    tm.double().train()
    bank.encoder_k.double()
    with torch.no_grad():
        args = (tm, bank, torch.from_numpy(x1).double(),
                torch.from_numpy(x2).double())
        if uber:
            t_logits, t_mask, t_keys = tmoco.ubernce_forward(
                *args, torch.from_numpy(labels))
            np.testing.assert_array_equal(t_mask.numpy(), np.asarray(mask))
        else:
            t_logits, t_target, t_keys = tmoco.infonce_forward(*args)
            assert not t_target.any()
    assert t_logits.dtype == torch.float32
    assert_close(t_logits.numpy(), np.asarray(logits), 1e-5, "logits")
    assert_close(t_keys.numpy(), np.asarray(keys), 1e-5, "keys")


def _x64_enqueue(state, keys, labels=None, axis_name=None):
    """JAX's ``dequeue_and_enqueue`` under x64, where its literal 0 index
    is int64 beside the int32 pointer and ``dynamic_update_slice``
    refuses the mix: the pointer goes in as int64 and comes back int32."""
    out = jmoco.dequeue_and_enqueue(
        state.replace(queue_ptr=state.queue_ptr.astype(jnp.int64)), keys,
        labels, axis_name)
    return out.replace(queue_ptr=out.queue_ptr.astype(jnp.int32))


@pytest.fixture
def jax_float64(monkeypatch):
    """JAX in float64: x64 on, the BatchNorm compute-dtype hook at float64
    and the step's enqueue given an int64 pointer (``_x64_enqueue``)."""
    monkeypatch.setattr(j_layers, "_bn_compute_dtype", lambda: jnp.float64)
    monkeypatch.setattr(jsteps, "dequeue_and_enqueue", _x64_enqueue)
    with jax.enable_x64(True):
        yield


@pytest.mark.parametrize("arch", ["info_nce", "uber_nce"])
def test_two_moco_steps_match_jax(arch, encoders, jax_float64):
    """Two steps from the same weights and queue: the step order (SGD,
    then the momentum update from the updated query, then the enqueue of
    the keys computed before it) and both losses as the JAX step takes
    them."""
    _, params32, stats32, _ = encoders
    jcfg, tcfg = _cfgs(arch)
    uber = arch == "uber_nce"
    jm = j_selector(jcfg, dtype=jnp.float64)
    params, stats = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64),
                                 (params32, stats32))
    tx = j_make_optimizer(jcfg)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=jax.jit(tx.init)(params),
                       tx=tx,
                       apply_fn=jm.apply,
                       moco=_moco_state(params32, stats32, uber))
    state = state.replace(moco=state.moco.replace(key_params=jax.tree.map(
        lambda v: jnp.asarray(np.array(v)), params)))  # donated: not aliased
    jstep = jsteps.make_moco_train_step(jcfg, jm, uber=uber)
    tm = _port_encoder(tcfg, params32, stats32)
    bank = _port_bank(tcfg, tm, _moco_state(params32, stats32, uber))
    tm.double()
    bank.encoder_k.double()
    opt, sched = t_make_optimizer(tcfg, tm.parameters())
    tstep = tsteps.make_moco_train_step(tcfg, tm, opt, sched, bank,
                                        uber=uber, device="cpu")
    for i in range(2):
        batch = {"x1": _clips(B, 10 + i, 0.5).astype(np.float64),
                 "x2": _clips(B, 20 + i, 0.5).astype(np.float64),
                 "label": np.array([0, 1, 0, 2]) + i}
        state, jmet = jstep(state, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                            jax.random.key(i))
        tmet = tstep({k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("loss", "top1", "top5"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       atol=1e-4, err_msg=f"step {i} {k}")
        want = t_ckpt.flax_moco_encoder_to_torch(
            *jax.tree.map(np.asarray, (state.params, state.batch_stats)))
        own = tm.state_dict()
        for k, v in want.items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_allclose(own[k].numpy(), v.numpy(),
                                           atol=1e-4, err_msg=f"step {i} {k}")
        want_k = t_ckpt.flax_moco_encoder_to_torch(
            jax.tree.map(np.asarray, state.moco.key_params), {},
            prefix="encoder_k")
        own_k = bank.state_dict()
        for k, v in want_k.items():
            np.testing.assert_allclose(own_k[k].numpy(), v.numpy(),
                                       atol=1e-4, err_msg=f"step {i} {k}")
        np.testing.assert_allclose(bank.queue.numpy(),
                                   np.asarray(state.moco.queue), atol=1e-4)
        assert int(bank.queue_ptr) == int(state.moco.queue_ptr) == \
            (i + 1) * B % K
        if uber:
            np.testing.assert_array_equal(bank.queue_labels.numpy(),
                                          np.asarray(state.moco.queue_labels))
        else:
            assert bank.queue_labels is None and \
                state.moco.queue_labels is None
        # the next step starts both packages from the port's state
        sd = {k: v.numpy() for k, v in tm.state_dict().items()}
        p, st = j_ckpt.torch_moco_encoder_to_flax(sd)
        kp, _ = j_ckpt.torch_moco_encoder_to_flax(
            {k: v.numpy() for k, v in bank.state_dict().items()},
            encoder="k")
        like = (state.params, state.batch_stats, state.moco.key_params,
                state.moco.queue)  # the same trees: no second compile
        p, st, kp, q = jax.tree.map(lambda ref, v: jnp.asarray(v, ref.dtype),
                                    like, (p, st, kp, bank.queue.numpy()))
        state = state.replace(params=p, batch_stats=st, moco=state.moco
                              .replace(key_params=kp, queue=q))


def test_ring_buffer_wraps_and_asserts(encoders):
    jm, params, stats, tcfg = encoders
    state = _moco_state(params, stats, True)
    bank = _port_bank(tcfg, _port_encoder(tcfg, params, stats), state)
    rng = np.random.default_rng(4)
    for call in range(3):  # 3 x 4 keys past the 8 slots
        keys = rng.normal(size=(B, DIM)).astype(np.float32)
        labels = rng.integers(0, 9, B)
        state = jmoco.dequeue_and_enqueue(state, jnp.asarray(keys),
                                          jnp.asarray(labels))
        bank.dequeue_and_enqueue(torch.from_numpy(keys),
                                 torch.from_numpy(labels))
        np.testing.assert_array_equal(bank.queue.numpy(),
                                      np.asarray(state.queue))
        np.testing.assert_array_equal(bank.queue_labels.numpy(),
                                      np.asarray(state.queue_labels))
        assert int(bank.queue_ptr) == int(state.queue_ptr)
    with pytest.raises(AssertionError, match="queue size 8 % batch 3"):
        bank.dequeue_and_enqueue(torch.zeros(3, DIM))


def test_key_forward_keeps_the_running_statistics(encoders):
    """Hazard H9: the key encoder runs in train mode (batch statistics) and
    writes none of its running statistics; the momentum update moves its
    parameters only."""
    jm, params, stats, tcfg = encoders
    tm = _port_encoder(tcfg, params, stats)
    bank = tsteps.make_banks(tcfg, 0, tm)["moco"]
    before = {k: v.clone() for k, v in bank.encoder_k.state_dict().items()}
    x = torch.from_numpy(_clips(B, seed=5))
    k = bank.keys(x)
    after = bank.encoder_k.state_dict()
    buffers = [n for n, _ in bank.encoder_k.named_buffers()]
    assert any(n.endswith("running_var") for n in buffers)
    for n in buffers:
        assert torch.equal(after[n], before[n]), n
    # the key forward normalized by the batch: the same as the query
    # network's train-mode forward (which does move its statistics)
    tm.train()
    with torch.no_grad():
        q = tm(x)
    assert_close(k.numpy(), (q / q.norm(dim=1, keepdim=True)).numpy(), 1e-6)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(1.0)
    bank.momentum_update(tmoco.query_network(tm), 0.5)
    after = bank.encoder_k.state_dict()
    for n in buffers:
        assert torch.equal(after[n], before[n]), n
    for n, p in bank.encoder_k.named_parameters():
        assert torch.allclose(p, before[n] + 0.5), n


YAML = ("MODEL:\n  ARCH: uber_nce\n"
        f"DATA:\n  SAMPLE_SIZE: {CLIP[1]}\n  SAMPLE_DURATION: {CLIP[0]}\n"
        "TRAIN:\n  DATASET: ucf101\n  BATCH_SIZE: 4\n  EPOCHS: 1\n"
        "  NUM_DATA_WORKERS: 2\n  LOG_INTERVAL: 1\n"
        "  RETRIEVAL_INTERVAL: 1\n  ACCUM_STEPS: 2\n"
        "VAL:\n  BATCH_SIZE: 4\n"
        f"LOSS:\n  TYPE: UberNCE\n  K: {K}\n"
        "OPTIM:\n  LR: 0.01\n"
        "TPU:\n  COMPUTE_DTYPE: float32\n")


def test_ubernce_cli_resumes_its_bank(tmp_path, monkeypatch, capsys):
    vid, ann = make_synthetic_ucf(str(tmp_path / "data"))
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(YAML)
    out = str(tmp_path / "out")
    argv = ["--cfg", str(cfg), "--output", out, "--device", "cpu",
            "DATASET.VID_PATH", vid, "DATASET.ANNOTATION_PATH", ann]
    t_cli.main(argv)
    printed = capsys.readouterr().out
    assert "TRAIN.ACCUM_STEPS ignored for LOSS.TYPE=UberNCE" in printed
    assert "Top1:" in printed
    logs = os.path.join(out, "tnet_checkpoints")
    saved = torch.load(os.path.join(logs, "uber_nce", "checkpoint.pth.tar"),
                       weights_only=False)["banks"]["moco"]
    assert {"queue", "queue_ptr", "queue_labels",
            "encoder_k.0.Conv_1a.conv1.weight", "encoder_k.4.bias"} <= \
        set(saved)
    assert (saved["queue_labels"] >= 0).any()
    seen = {}
    make_step = tsteps.make_moco_train_step

    def spy(cfg, model, optimizer, schedule, bank, **kw):
        seen.update({k: v.clone() for k, v in bank.state_dict().items()})
        return make_step(cfg, model, optimizer, schedule, bank, **kw)

    monkeypatch.setattr(tsteps, "make_moco_train_step", spy)
    t_cli.main(argv[:4] + ["--checkpoint_path", out] + argv[4:]
               + ["TRAIN.EPOCHS", "2"])
    assert seen.keys() == saved.keys()
    assert all(torch.equal(seen[k], v) for k, v in saved.items())
    with open(os.path.join(logs, "train_loss_and_acc.txt")) as f:
        assert len(f.read().splitlines()) == 2
