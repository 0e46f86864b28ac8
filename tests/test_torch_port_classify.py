"""The port's classification path against the JAX package's, on the CPU in
float32: ``LinearClassifier``, ``make_classify_train_step``, the
classifier's optimizer groups and schedule, the ten-crop test and feature
retrieval, and a CPU smoke of ``python -m
video_similarity_search_tpu_torch.cli.coclr_classify``.

* ``LinearClassifier`` heads, for each (use_l2_norm, use_final_bn,
  dropout): the same backbone output given to both (flax
  ``intercept_methods`` on the JAX side, a forward hook on the port's),
  logits and pooled features within 1e-5, in eval mode and in train mode
  with JAX's dropout mask injected (read off ``Dropout_0``'s output, zero
  exactly where the mask drops), ``final_bn``'s statistics within 1e-5;
  and whole classifiers in eval mode within 1e-5, their weights read back
  by the JAX importers ``torch_linear_classifier_to_flax`` and
  ``torch_s3d_to_flax`` (``final_fc.0`` and ``final_fc.1``);
* one ``make_classify_train_step`` for ``--train_what last`` and ``all``
  (batch 8, lr 0.1, JAX's dropout mask injected): loss within 1e-5, equal
  top-1/top-5, every parameter and BatchNorm statistic within 1e-4.
  ``last`` runs in float32 with each backbone block fed JAX's input as in
  ``test_torch_port_s3d.py`` (whose exact-variance flax BatchNorm this
  module shares); ``all`` runs in float64 on both sides (see the test);
* the ``last`` / ``ft`` / ``all`` groups over 3 updates against the JAX
  CLI's ``optax.multi_transform`` within 1e-6, and ``make_lr_schedule``
  equal to optax's at every step of a 10-epoch run within 1e-6 relative;
* ``ten_crop_views`` equal to JAX's, and ``test_10crop`` /
  ``test_retrieval`` on the same weights and batches (a padded ragged
  batch, multi-window test videos): equal top-1/top-5 and retrieval dict.
"""

import functools
import importlib.util
import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from synthetic_data import make_synthetic_ucf
from test_torch_port_s3d import (CLIP, S3D_BLOCKS, assert_close,  # noqa: F401
                                 assert_trees_close, clips, exact_variance,
                                 few_torch_threads, japply, numpy_sd,
                                 random_variables, teacher_force)
from video_similarity_search_tpu.config import get_cfg as j_get_cfg
from video_similarity_search_tpu.evaluation import classify as j_classify
from video_similarity_search_tpu.models.heads import \
    LinearClassifier as JLinearClassifier
from video_similarity_search_tpu.models.s3d import S3D as JS3D
from video_similarity_search_tpu.train import TrainState
from video_similarity_search_tpu.train.checkpoint import (
    torch_linear_classifier_to_flax, torch_s3d_to_flax)
from video_similarity_search_tpu.train.steps import \
    make_classify_train_step as j_make_step
from video_similarity_search_tpu_torch.cli import coclr_classify as t_cli
from video_similarity_search_tpu_torch.config import get_cfg as t_get_cfg
from video_similarity_search_tpu_torch.evaluation import classify as t_classify
from video_similarity_search_tpu_torch.models.heads import LinearClassifier
from video_similarity_search_tpu_torch.train.checkpoint import (
    flax_linear_classifier_to_torch, flax_s3d_to_torch)
from video_similarity_search_tpu_torch.train.state import (
    freeze_mask, make_classify_optimizer, make_lr_schedule)
from video_similarity_search_tpu_torch.train.steps import \
    make_classify_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CLASS, B = 8, 8
WD = 1e-3


def _load_jax_cli():
    path = os.path.join(REPO, "cli", "coclr_classify.py")
    spec = importlib.util.spec_from_file_location("j_coclr_classify", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J_CLI = _load_jax_cli()


def heads(l2, bn, dropout):
    kw = dict(num_class=N_CLASS, dropout=0.9, use_dropout=dropout,
              use_l2_norm=l2, use_final_bn=bn)
    return JLinearClassifier(**kw), LinearClassifier(**kw)


@functools.lru_cache(maxsize=None)
def head_variables(bn):
    """Seeded weights of a classifier with or without ``final_bn`` (the
    l2 norm and the dropout add none)."""
    return random_variables(heads(False, bn, False)[0],
                            jnp.zeros((1,) + CLIP), seed=11)


def port_classifier(tm, params, stats, dropout):
    tm.load_state_dict(flax_linear_classifier_to_torch(params, stats,
                                                       use_dropout=dropout))
    return tm


def jax_dropout_keep(intermediates):
    """JAX's dropout mask, read off Dropout_0's output (zero exactly where
    the mask drops; the input, after l2 / final_bn, has no zeros)."""
    out = np.asarray(intermediates["Dropout_0"]["__call__"][0])
    return torch.from_numpy(out != 0)


def apply_head(jm, variables, feature_map, train, key):
    """``jm.apply`` with its S3D backbone intercepted to return
    ``feature_map`` (B, T', H', W', 1024): only the head runs. flax draws
    the dropout mask from the key and Dropout_0's path, so it is the
    whole classifier's. -> ((logits, feat), mutated collections)."""
    fixed = jnp.asarray(feature_map)

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, JS3D):
            return fixed
        return next_fun(*args, **kwargs)

    x = jnp.zeros((fixed.shape[0],) + CLIP)  # the backbone's input is unused
    with flax.linen.intercept_methods(interceptor):
        return jm.apply(variables, x, train=train, rngs={"dropout": key},
                        mutable=["batch_stats", "intermediates"],
                        capture_intermediates=True)


@pytest.fixture(scope="module")
def feature_map():
    """A fixed post-ReLU backbone output (B, 1, 2, 2, 1024)."""
    rng = np.random.default_rng(7)
    return np.abs(rng.normal(size=(B, 1, 2, 2, 1024))).astype(np.float32)


@pytest.mark.parametrize("l2", [False, True], ids=["", "l2"])
@pytest.mark.parametrize("bn", [False, True], ids=["", "bn"])
@pytest.mark.parametrize("dropout", [False, True], ids=["", "dropout"])
def test_linear_classifier_head_matches_jax(l2, bn, dropout, feature_map):
    jm, tm = heads(l2, bn, dropout)
    params, stats = head_variables(bn)
    port_classifier(tm, params, stats, dropout)
    tm.backbone.register_forward_hook(
        lambda mod, inp, out: torch.from_numpy(feature_map).permute(
            0, 4, 1, 2, 3))
    x = np.zeros((B,) + CLIP, np.float32)  # the backbone's input is unused
    key = jax.random.key(3)
    for train in (False, True):
        (logits, feat), mut = apply_head(
            jm, {"params": params, "batch_stats": stats}, feature_map, train,
            key)
        keep = (jax_dropout_keep(mut["intermediates"])
                if train and dropout else None)
        tm.train(train)
        with torch.no_grad():
            t_logits, t_feat = tm(torch.from_numpy(x), dropout_keep=keep)
        assert t_logits.dtype == t_feat.dtype == torch.float32
        assert_close(t_feat.numpy(), feat, 1e-5, "feat")
        assert_close(t_logits.numpy(), logits, 1e-5, f"logits train={train}")
    if bn:
        _, t_stats = torch_linear_classifier_to_flax(numpy_sd(tm))
        assert_trees_close(t_stats["final_bn"], mut["batch_stats"]["final_bn"],
                           atol=1e-5)


def test_whole_classifier_and_jax_importers():
    """In eval mode the dropout is the identity, so one JAX classifier
    gives the logits of the port's with (``final_fc.1``) and without
    (``final_fc.0``) a dropout."""
    kw = dict(num_class=N_CLASS, network="s3dg", dropout=0.9,
              use_l2_norm=True, use_final_bn=True)
    jm = JLinearClassifier(**kw)
    params, stats = random_variables(jm, jnp.zeros((1,) + CLIP), seed=12)
    x = clips(2, seed=5)
    logits, feat = japply(jm, {"params": params, "batch_stats": stats}, x,
                          train=False)
    for dropout in (False, True):
        tm = port_classifier(LinearClassifier(**kw, use_dropout=dropout),
                             params, stats, dropout).eval()
        with torch.no_grad():
            t_logits, t_feat = tm(torch.from_numpy(x))
        assert_close(t_feat.numpy(), feat, 1e-5, "feat")
        assert_close(t_logits.numpy(), logits, 1e-5, "logits")
        # the JAX importers read the port's state_dict back to the same
        # trees
        assert f"final_fc.{int(dropout)}.weight" in tm.state_dict()
        p2, s2 = torch_linear_classifier_to_flax(numpy_sd(tm))
        assert_trees_close(p2, params, atol=0)
        assert_trees_close(s2, stats, atol=0)
        bb_params, _ = torch_s3d_to_flax(numpy_sd(tm))
        assert_trees_close(bb_params["backbone"], params["backbone"], atol=0)
    assert set(flax_s3d_to_torch(params["backbone"], stats["backbone"])) == {
        k[len("backbone."):] for k in tm.state_dict()
        if k.startswith("backbone.")}


def _jax_optimizer(params, train_what, schedule):
    """The JAX CLI's ``build_state`` optimizer (cli/coclr_classify.py)."""
    backbone_lr = lambda step: schedule(step) * 0.1  # noqa: E731
    return optax.multi_transform(
        {"train": optax.chain(optax.add_decayed_weights(WD),
                              optax.sgd(schedule, momentum=0.9)),
         "backbone": optax.chain(optax.add_decayed_weights(WD),
                                 optax.sgd(backbone_lr, momentum=0.9)),
         "freeze": optax.set_to_zero()},
        J_CLI.freeze_mask(params, train_what))


@pytest.fixture
def jax_float64(monkeypatch):
    """JAX in float64: x64 on and the JAX BatchNorm's compute-dtype hook
    (float32 otherwise) at float64. The classifier head stays float32."""
    import video_similarity_search_tpu.models.layers as j_layers
    monkeypatch.setattr(j_layers, "_bn_compute_dtype", lambda: jnp.float64)
    with jax.enable_x64(True):
        yield


@pytest.mark.parametrize("train_what,dtype", [("last", np.float32),
                                              ("all", np.float64)])
def test_classify_train_step_matches_jax(train_what, dtype, request):
    """``last`` in float32, each backbone block fed JAX's input. ``all`` in
    float64 on both sides: at init S3D's backbone gradient grows ~1e5-fold
    through its train-mode BatchNorms (norms in the thousands for a loss
    of ~3), and a float32 run of either package is 1-4% from a float64 one,
    so no two float32 backbone updates can agree within 1e-4."""
    wide = dtype == np.float64
    if wide:
        request.getfixturevalue("jax_float64")
    l2 = bn = train_what == "last"
    kw = dict(num_class=N_CLASS, dropout=0.9, use_dropout=True,
              use_l2_norm=l2, use_final_bn=bn)
    jm = JLinearClassifier(**kw, dtype=jnp.float64 if wide else jnp.float32)
    tm = LinearClassifier(**kw)
    params, stats = random_variables(jm, jnp.zeros((1,) + CLIP), seed=13)
    port_classifier(tm, params, stats, True).to(torch.float64 if wide
                                                else torch.float32)
    params, stats = jax.tree.map(lambda v: jnp.asarray(v, dtype),
                                 (params, stats))
    x = clips(B, seed=6).astype(dtype)
    labels = np.arange(B) % N_CLASS
    key = jax.random.key(4)
    schedule = J_CLI.make_lr_schedule(0.1, 10, [60, 100], False, 5)
    tx = _jax_optimizer(params, train_what, schedule)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=tx.init(params), tx=tx,
                       apply_fn=jm.apply)
    variables = {"params": params, "batch_stats": stats}
    _, mut = apply_head(jm, variables, np.ones((B, 1, 1, 1, 1024), dtype),
                        True, key)
    keep = jax_dropout_keep(mut["intermediates"])
    if not wide:  # the step's own forward, for the block outputs
        _, mut = japply(jm, variables, x, train=True, rngs={"dropout": key},
                        mutable=["batch_stats", "intermediates"],
                        capture_intermediates=True)
        blocks = {n: np.asarray(mut["intermediates"]["backbone"][n]
                                ["__call__"][0]) for n in S3D_BLOCKS}
    init_fc = np.asarray(params["final_fc"]["kernel"])
    state, jmet = j_make_step(j_get_cfg())(
        state, {"clips": jnp.asarray(x), "label": jnp.asarray(labels)}, key)

    cfg = t_get_cfg()
    cfg.MODEL.ARCH = "s3d"
    optimizer, sched = make_classify_optimizer(
        tm, train_what, make_lr_schedule(0.1, 10, [60, 100], False, 5), WD)
    step = make_classify_train_step(cfg, tm, optimizer, sched, device="cpu")
    if not wide:
        teacher_force(tm.backbone, S3D_BLOCKS, blocks)
    tmet = step({"clips": torch.from_numpy(x),
                 "label": torch.from_numpy(labels)}, dropout_keep=keep)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               atol=1e-5)
    for k in ("top1", "top5"):
        assert float(tmet[k]) == float(jmet[k]), k
    t_params, t_stats = torch_linear_classifier_to_flax(numpy_sd(tm))
    assert_trees_close(t_params, state.params, atol=1e-4)
    assert_trees_close(t_stats, state.batch_stats, atol=1e-4)
    moved = np.abs(np.asarray(state.params["final_fc"]["kernel"])
                   - init_fc).max()
    assert moved > 1e-3  # the step did move the head


@pytest.mark.parametrize("train_what", ["last", "ft", "all"])
@pytest.mark.parametrize("cosine", [False, True], ids=["steps", "cosine"])
def test_classify_optimizer_groups_match_optax(train_what, cosine):
    """3 updates of a backbone tensor, a final_fc and a final_bn tensor
    (momentum, weight decay, the ft group's tenth, the frozen group)."""
    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.backbone = torch.nn.Linear(4, 3, bias=False)
            self.final_bn = torch.nn.BatchNorm1d(3)
            self.final_fc = torch.nn.Sequential(torch.nn.Linear(3, 2))

    rng = np.random.default_rng(8)
    model = Tiny()
    init = {k: rng.normal(size=tuple(v.shape)).astype(np.float32)
            for k, v in model.named_parameters()}
    model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()},
                          strict=False)
    jparams = {"backbone": {"kernel": init["backbone.weight"]},
               "final_bn": {"scale": init["final_bn.weight"],
                            "bias": init["final_bn.bias"]},
               "final_fc": {"kernel": init["final_fc.0.weight"],
                            "bias": init["final_fc.0.bias"]}}
    names = {"backbone.weight": ("backbone", "kernel"),
             "final_bn.weight": ("final_bn", "scale"),
             "final_bn.bias": ("final_bn", "bias"),
             "final_fc.0.weight": ("final_fc", "kernel"),
             "final_fc.0.bias": ("final_fc", "bias")}
    args = (0.1, 2, [1], cosine, 2)  # boundary / decay inside 3 updates
    tx = _jax_optimizer(jparams, train_what, J_CLI.make_lr_schedule(*args))
    opt_state = tx.init(jparams)
    opt, sched = make_classify_optimizer(model, train_what,
                                         make_lr_schedule(*args), WD)
    for _ in range(3):
        grads = {k: rng.normal(size=v.shape).astype(np.float32)
                 for k, v in init.items()}
        jg = jax.tree.map(lambda v: v, jparams)
        for k, (a, b) in names.items():
            jg[a][b] = grads[k]
        updates, opt_state = tx.update(jg, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[k]) if p.requires_grad else None
        opt.step()
        sched.step()
        for k, p in model.named_parameters():
            a, b = names[k]
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[a][b]), atol=1e-6,
                                       err_msg=k)
    frozen = [k for k, p in model.named_parameters() if not p.requires_grad]
    assert frozen == (["backbone.weight"] if train_what == "last" else [])


@pytest.mark.parametrize("cosine", [False, True], ids=["steps", "cosine"])
@pytest.mark.parametrize("steps_per_epoch", [3, 7])
def test_make_lr_schedule_matches_optax(cosine, steps_per_epoch):
    args = (1e-3, 10, [3, 6], cosine, steps_per_epoch)
    want, got = J_CLI.make_lr_schedule(*args), make_lr_schedule(*args)
    for count in range(10 * steps_per_epoch + 3):
        w = float(want(count))
        assert got(count) == pytest.approx(w, rel=1e-6, abs=0), count


def test_freeze_mask_labels_match_jax():
    tm = heads(True, True, True)[1]
    params, _ = head_variables(True)
    for train_what in ("last", "ft", "all"):
        jlabels = {}
        for path, label in jax.tree_util.tree_leaves_with_path(
                J_CLI.freeze_mask(params, train_what)):
            jlabels.setdefault(path[0].key, set()).add(label)
        tlabels = {}
        for name, label in freeze_mask(tm, train_what).items():
            tlabels.setdefault(name.split(".")[0], set()).add(label)
        assert tlabels == jlabels, train_what


# --------------------------------------------------------------------------
# ten-crop test and retrieval

def _video_batch(rng, n_items, windows, size, first_index, size_real=None):
    counts = np.full(n_items, windows, np.int32)
    n = n_items * windows
    return {"clip": rng.integers(0, 256, (n,) + CLIP[:1] + (size, size, 3),
                                 np.uint8),
            "target": np.repeat(np.arange(first_index, first_index + n_items)
                                % N_CLASS, windows).astype(np.int32),
            "index": np.repeat(np.arange(first_index, first_index + n_items),
                               windows).astype(np.int32),
            "window_counts": counts,
            "__size__": n_items if size_real is None else size_real}


def _padded(batch, real):
    """Loader padding: the rows past ``real`` copy the last real item."""
    for k in ("clip", "target", "index"):
        batch[k][real:] = batch[k][real - 1]
    batch["__size__"] = real
    return batch


@pytest.fixture(scope="module")
def evaluation_model():
    jm = JLinearClassifier(num_class=N_CLASS, dropout=0.9)
    params, stats = random_variables(jm, jnp.zeros((1,) + CLIP), seed=15)
    tm = LinearClassifier(num_class=N_CLASS, dropout=0.9)
    port_classifier(tm, params, stats, True)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=None, tx=None,
                       apply_fn=jm.apply)
    cfgs = []
    for get in (j_get_cfg, t_get_cfg):
        cfg = get()
        cfg.MODEL.ARCH = "s3d"
        cfg.DATA.SAMPLE_SIZE = CLIP[1]
        cfg.TRAIN.DATASET = "ucf101"
        cfg.TPU.COMPUTE_DTYPE = "float32"
        cfgs.append(cfg)
    return jm, state, tm, cfgs


def test_ten_crop_views_equal_jax():
    x = np.random.default_rng(9).normal(size=(2, 3, 36, 40, 3)).astype(
        np.float32)
    got = t_classify.ten_crop_views(torch.from_numpy(x), 32).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        j_classify.ten_crop_views(jnp.asarray(x), 32)))


def test_ten_crop_test_and_retrieval_match_jax(evaluation_model, capsys):
    jm, state, tm, (jcfg, tcfg) = evaluation_model
    rng = np.random.default_rng(10)
    buf = int(1.14 * CLIP[1])
    val = [_video_batch(rng, 3, 1, buf, 0),
           _padded(_video_batch(rng, 3, 1, buf, 3), 2)]
    j_res = j_classify.test_10crop(state, jm, jcfg, val)
    t_res = t_classify.test_10crop(tm, tcfg, val, device="cpu")
    assert t_res == j_res
    train = [_video_batch(rng, 4, 1, CLIP[1], 0),
             _padded(_video_batch(rng, 4, 1, CLIP[1], 4), 3)]
    # batches of 4 clips each, as the train batches: one JAX compile
    test = [_video_batch(rng, 2, 2, CLIP[1], 2 * i) for i in range(2)]
    j_topk = j_classify.test_retrieval(state, jm, jcfg, train, test)
    t_topk = t_classify.test_retrieval(tm, tcfg, train, test, device="cpu")
    assert t_topk == j_topk
    out = capsys.readouterr().out
    assert "10-crop test: top1" in out and "retrieval:" in out


# --------------------------------------------------------------------------
# the CLI on the CPU

@pytest.fixture(scope="module")
def ucf(tmp_path_factory):
    root = tmp_path_factory.mktemp("classify")
    vid, ann = make_synthetic_ucf(str(root / "data"), with_test=True)
    return root, vid, ann


def _cli(ucf, out, *extra):
    _, vid, ann = ucf
    return t_cli.main(["--vid_path", vid, "--annotation_path", ann,
                       "--device", "cpu", "--seq_len", "8", "--img_dim", "32",
                       "--num_class", "3", "--batch_size", "4", "--lr", "0.01",
                       "--output", str(out)] + list(extra))


@pytest.mark.parametrize("train_what,epochs", [("last", 2), ("ft", 1),
                                               ("all", 1)])
def test_cli_trains_and_tests_on_the_cpu(ucf, train_what, epochs, capsys):
    out = ucf[0] / f"out_{train_what}"
    model, optimizer = _cli(ucf, out, "--train_what", train_what,
                            "--epochs", str(epochs))
    stdout = capsys.readouterr().out
    assert stdout.count("val top1") == epochs
    assert f"epoch {epochs - 1}: lr 0.01000 loss" in stdout
    best = out / "tnet_checkpoints" / "s3d" / "model_best.pth.tar"
    scalars = (out / "metrics" / "scalars.csv").read_text()
    for tag in ("train/lr", "train/loss", "train/top1", "train/top5",
                "val/top1"):
        assert f",{tag}," in scalars
    groups = [g["lr_scale"] for g in optimizer.param_groups]
    assert groups == {"last": [1.0], "ft": [1.0, 0.1], "all": [1.0]}[train_what]
    if train_what != "last":
        return
    assert best.exists()  # val top1 rose above 0 at least once
    top1, top5 = _cli(ucf, out / "test", "--train_what", train_what,
                      "--checkpoint_path", str(best))
    stdout = capsys.readouterr().out
    assert "resume: epoch" in stdout and "10-crop test: top1" in stdout
    assert 0.0 <= top1 <= top5 <= 1.0
    topk = _cli(ucf, out / "retrieval", "--train_what", train_what,
                "--checkpoint_path", str(best), "--retrieval")
    assert sorted(topk) == [1, 5, 10, 20, 50]
    assert "retrieval:" in capsys.readouterr().out


def test_cli_computes_in_float32(ucf, tmp_path, monkeypatch):
    """The JAX CLI builds its classifier in float32 and never reads
    TPU.COMPUTE_DTYPE, so the port's CLI steps in float32 (no autocast on
    the card) even when a config file asks for bf16."""
    from video_similarity_search_tpu_torch.train import steps

    class Built(Exception):
        pass

    def spy(cfg, *args, **kwargs):
        raise Built(cfg.TPU.COMPUTE_DTYPE)

    monkeypatch.setattr(steps, "make_classify_train_step", spy)
    yaml = tmp_path / "bf16.yaml"
    yaml.write_text("TPU:\n  COMPUTE_DTYPE: bfloat16\n")
    with pytest.raises(Built, match="^float32$"):
        _cli(ucf, tmp_path / "out", "--cfg", str(yaml), "--epochs", "1")


def test_cli_lmdb_root_raises(tmp_path):
    """``--lmdb_root`` reads the store: a root without its
    ``ucf101_frame.lmdb`` raises FileNotFoundError naming it (the LMDB
    path runs; tests/test_torch_port_lmdb.py trains and tests through
    it)."""
    with pytest.raises(FileNotFoundError, match="ucf101_frame.lmdb"):
        t_cli.main(["--lmdb_root", str(tmp_path), "--device", "cpu",
                    "--epochs", "1", "--output", str(tmp_path / "out")])
