"""The port's SlowFast family against the JAX package's, on the CPU, with the
JAX weights carried across by ``flax_slowfast_to_torch`` (every BatchNorm
statistic with them), at width_per_group 8 on 8x32x32 clips.

* every block in eval and train mode, fed the same input: Nonlocal (dot
  product and softmax, with and without a pool), BasicTransform,
  BottleneckTransform (2 groups, dilation 2), a ResStage whose temporal
  kernels stop before its last block and with a Nonlocal block, the stem,
  the fusion and SubBatchNorm: outputs within 1e-5 of their largest
  magnitude, running statistics within 1e-5. As in the S3D tests, the JAX
  side runs flax's two-pass variance (``use_fast_variance=False``; its
  default E[x^2] - E[x]^2 loses digits the comparison needs);
* SinglePathwayResNet (slow, i3d, c2d) and the whole SlowFast (depths 18
  and 50, with the projection head, and the classifier with JAX's dropout
  mask injected) likewise, end to end;
* ``multipathway_input`` for every T from 1 to 64 at alpha 2, 4 and 8,
  with and without ``fast_mask``;
* one triplet step of SlowFast-18 in float64 on both sides within 1e-6 on
  every parameter and BatchNorm statistic;
* the Caffe2, Sub-BN and 2-D inflation import against the JAX package's
  on the blob dicts of ``tests/test_caffe2_import.py``, and a ``.pkl`` in
  ``tmp_path`` loaded into the port's model;
* ``make_embed_step`` and validation on ``slowfast`` against JAX's.
"""

import pickle

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_caffe2_import import _torch_key_to_caffe2
from test_torch_port_s3d import (ExactVarianceBatchNorm, assert_close,
                                 assert_trees_close, japply, random_variables)
from video_similarity_search_tpu.config import get_cfg as j_get_cfg
from video_similarity_search_tpu.evaluation.validate import \
    make_validate_step as j_validate_step
from video_similarity_search_tpu.models import layers as j_layers
from video_similarity_search_tpu.models import slowfast as jsf
from video_similarity_search_tpu.train import checkpoint as j_ckpt
from video_similarity_search_tpu.train.state import TrainState
from video_similarity_search_tpu.train.state import \
    make_optimizer as j_make_optimizer
from video_similarity_search_tpu.train.steps import \
    make_embed_step as j_embed_step
from video_similarity_search_tpu.train.steps import \
    make_triplet_train_step as j_triplet_step
from video_similarity_search_tpu_torch.config import get_cfg as t_get_cfg
from video_similarity_search_tpu_torch.evaluation.validate import \
    make_validate_step as t_validate_step
from video_similarity_search_tpu_torch.models import layers as t_layers
from video_similarity_search_tpu_torch.models import slowfast as tsf
from video_similarity_search_tpu_torch.train import checkpoint as t_ckpt
from video_similarity_search_tpu_torch.train.state import \
    make_optimizer as t_make_optimizer
from video_similarity_search_tpu_torch.train.steps import (
    make_embed_step, make_triplet_train_step)

W = 8  # width_per_group
CLIP = (8, 32, 32, 3)


@pytest.fixture(scope="module", autouse=True)
def exact_variance():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "BatchNorm", ExactVarianceBatchNorm)
        yield


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def clips(b, shape=CLIP, seed=0):
    return np.random.default_rng(seed).normal(size=(b,) + shape).astype(
        np.float32)


def nchw(x):  # (B,T,H,W,C) numpy -> the blocks' (B,C,T,H,W) tensor
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 4, 1, 2, 3)


def nthwc(y):
    return y.detach().permute(0, 2, 3, 4, 1).numpy()


def block_sd(params, stats, wrap, strip):
    """A bare JAX block's trees -> the port block's state_dict: the trees
    nested under ``wrap`` as in a whole network, named there by
    ``flax_slowfast_to_torch``, and ``strip`` taken off the names."""
    def nest(tree):
        for k in reversed(wrap):
            tree = {k: tree}
        return tree
    sd = t_ckpt.flax_slowfast_to_torch(nest(params), nest(stats))
    return {k[len(strip):]: v for k, v in sd.items()}


def check_stats(model, new_stats, wrap=(), strip=""):
    """Every running mean / variance of ``model`` within 1e-5 of the
    largest magnitude of JAX's updated one (``new_stats``; random weights
    put some variances in the thousands)."""
    want = {k: v for k, v in block_sd({}, new_stats, wrap, strip).items()
            if not k.endswith("num_batches_tracked")}
    got = model.state_dict()
    assert want, "no statistics"
    for k, v in want.items():
        assert_close(got[k].numpy(), v.numpy(), 1e-5, k)


# name -> (JAX block, port block, JAX input shapes, wrap, strip)
BLOCKS = {
    "nonlocal_dot_pool": (
        lambda: jsf.Nonlocal("dot_product", pool_size=(1, 2, 2)),
        lambda: tsf.Nonlocal(16, "dot_product", (1, 2, 2)),
        [(4, 4, 8, 8, 16)], ("s2_pathway0", "nonlocal0"),
        "s2.pathway0_nonlocal0."),
    "nonlocal_softmax_pool": (
        lambda: jsf.Nonlocal("softmax", pool_size=(1, 2, 2)),
        lambda: tsf.Nonlocal(16, "softmax", (1, 2, 2)),
        [(4, 4, 8, 8, 16)], ("s2_pathway0", "nonlocal0"),
        "s2.pathway0_nonlocal0."),
    "nonlocal_dot": (
        lambda: jsf.Nonlocal("dot_product"),
        lambda: tsf.Nonlocal(16, "dot_product"),
        [(4, 2, 4, 4, 16)], ("s2_pathway0", "nonlocal0"),
        "s2.pathway0_nonlocal0."),
    "basic_transform": (
        lambda: jsf.BasicTransform(16, 3, 2),
        lambda: tsf.BasicTransform(8, 16, 3, 2),
        [(4, 4, 8, 8, 8)], ("s2_pathway0", "res0", "branch2"),
        "s2.pathway0_res0.branch2."),
    "bottleneck_groups2_dilation2": (
        lambda: jsf.BottleneckTransform(32, 3, 2, 16, num_groups=2,
                                        dilation=2),
        lambda: tsf.BottleneckTransform(16, 32, 3, 2, 16, num_groups=2,
                                        dilation=2),
        [(4, 4, 8, 8, 16)], ("s2_pathway0", "res0", "branch2"),
        "s2.pathway0_res0.branch2."),
    "res_stage": (
        lambda: jsf.ResStage(32, 8, (3, 1), 2, 3, num_block_temp_kernel=2,
                             nonlocal_inds=(1,), nonlocal_pool=(1, 2, 2)),
        lambda: tsf.ResStage([16], [32], [8], [(3, 1)], 2, 3,
                             num_block_temp_kernel=[2], nonlocal_inds=[(1,)],
                             nonlocal_pool=(1, 2, 2)),
        [(4, 4, 8, 8, 16)], ("s2_pathway0",), "s2."),
    "stem": (
        lambda: jsf.VideoModelStem(8, 5),
        lambda: tsf.VideoModelStem([3], [8], [5]),
        [(4,) + CLIP], ("s1_pathway0_stem",), "s1."),
    "fuse": (
        lambda: jsf.FuseFastToSlow(2, 7, 4),
        lambda: tsf.FuseFastToSlow(4, 2, 7, 4),
        [(4, 2, 8, 8, 16), (4, 8, 8, 8, 4)], ("s1_fuse",), "s1_fuse."),
}
LIST_BLOCKS = ("res_stage", "stem", "fuse")  # a list of pathways in and out


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name, train):
    jfac, tfac, shapes, wrap, strip = BLOCKS[name]
    xs = [clips(s[0], s[1:], seed=i) for i, s in enumerate(shapes)]
    jm = jfac()
    jx = xs if name == "fuse" else xs[0]
    shapes_x = [jnp.zeros(x.shape) for x in xs]
    params, stats = random_variables(
        jm, shapes_x if name == "fuse" else shapes_x[0], seed=7)
    out, mut = jax.jit(lambda v, x: jm.apply(v, x, train=train,
                                             mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats},
        [jnp.asarray(x) for x in jx] if name == "fuse" else jnp.asarray(jx))
    model = tfac()
    model.load_state_dict(block_sd(params, stats, wrap, strip))
    model.train(train)
    tx = [nchw(x) for x in xs]
    with torch.no_grad():
        got = model(tx if name in LIST_BLOCKS else tx[0])
    outs = out if isinstance(out, list) else [out]
    gots = got if isinstance(got, list) else [got]
    assert len(gots) == len(outs)
    for g, o in zip(gots, outs):
        assert_close(nthwc(g), np.asarray(o), 1e-5, name)
    check_stats(model, mut["batch_stats"], wrap, strip)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_sub_batch_norm_matches_jax(train):
    x = clips(8, (2, 4, 4, 6), seed=3) * 2.0 + 0.5
    jm = j_layers.SubBatchNorm(num_splits=4)
    variables = jm.init(jax.random.key(0), jnp.asarray(x),
                        use_running_average=True)
    rng = np.random.default_rng(5)
    params = {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
              "bias": rng.normal(0, 0.1, 6).astype(np.float32)}
    stats = {"mean": rng.normal(0, 0.1, 6).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, 6).astype(np.float32)}
    assert jax.tree.map(np.shape, variables["params"]) == \
        jax.tree.map(np.shape, params)
    out, mut = jm.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(x), use_running_average=not train,
                        mutable=["batch_stats"])
    model = t_layers.SubBatchNorm(6, num_splits=4)
    model.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                           "bias": torch.from_numpy(params["bias"]),
                           "running_mean": torch.from_numpy(stats["mean"]),
                           "running_var": torch.from_numpy(stats["var"])})
    model.train(train)
    with torch.no_grad():
        got = model(nchw(x))
    assert_close(nthwc(got), np.asarray(out), 1e-5)
    np.testing.assert_allclose(model.running_mean.numpy(),
                               mut["batch_stats"]["mean"], atol=1e-6)
    np.testing.assert_allclose(model.running_var.numpy(),
                               mut["batch_stats"]["var"], atol=1e-6)
    if train:  # each contiguous quarter of the batch by its own statistics
        with torch.no_grad():
            bn = torch.nn.functional.batch_norm(
                nchw(x)[2:4], None, None, training=True, eps=1e-5)
            want = bn * model.weight.view(1, -1, 1, 1, 1) + \
                model.bias.view(1, -1, 1, 1, 1)
            assert_close(got[2:4].numpy(), want.numpy(), 1e-5)
        with t_layers.frozen_stats(model), torch.no_grad():
            before = model.running_var.clone()
            model(nchw(x))
            assert torch.equal(model.running_var, before)


def stage_names(tm):
    """The port's stages and fusions -> the JAX modules whose outputs they
    hold: ``s2`` holds ``s2_pathway0`` (and ``s2_pathway1``), ``s1`` the
    stems, a fusion its namesake."""
    out = {}
    for name, mod in tm.named_children():
        if isinstance(mod, tsf.ResStage):
            out[name] = [f"{name}_pathway{p}" for p in range(mod.num_pathways)]
        elif isinstance(mod, tsf.VideoModelStem):
            out[name] = [f"{name}_pathway{p}_stem"
                         for p in range(mod.num_pathways)]
        elif isinstance(mod, tsf.FuseFastToSlow):
            out[name] = [name]
    return out


def _net_case(jm, tm_factory, x, train, dropout=False):
    """One network from the same weights and input, eval or train: every
    stage's output and the network's within 1e-5 of their largest
    magnitude, every running statistic likewise; JAX's dropout mask
    injected. In train mode each stage starts from JAX's input, as the S3D
    tests feed their blocks (a train-mode BatchNorm over a few values a
    channel amplifies float32 rounding from stage to stage, ~3e-5 at the
    output here)."""
    xs = x if isinstance(x, list) else [x]
    params, stats = random_variables(
        jm, [jnp.zeros((1,) + v.shape[1:]) for v in xs]
        if isinstance(x, list) else jnp.zeros((1,) + x.shape[1:]), seed=11)
    tm = tm_factory()
    stages = stage_names(tm)
    jnames = {n for v in stages.values() for n in v}
    kw = {"rngs": {"dropout": jax.random.key(3)}} if dropout else {}
    out, mut = jax.jit(lambda v, inp: jm.apply(
        v, inp, train=train, mutable=["batch_stats", "intermediates"],
        capture_intermediates=lambda m, _: m.name in jnames or isinstance(
            m, flax.linen.Dropout), **kw))(
        {"params": params, "batch_stats": stats},
        [jnp.asarray(v) for v in xs] if isinstance(x, list)
        else jnp.asarray(x))
    inter = mut["intermediates"]

    def jax_out(name):
        v = inter[name]["__call__"][0]
        return [np.asarray(a) for a in (v if isinstance(v, list) else [v])]

    tm.load_state_dict(t_ckpt.flax_slowfast_to_torch(params, stats))
    tm.train(train)
    own, handles = {}, []

    def force(name):
        def hook(mod, inp, outs):
            want = [a for n in stages[name] for a in jax_out(n)]
            own[name] = [nthwc(o) for o in outs]
            return [o + (nchw(w) - o).detach() for o, w in zip(outs, want)]
        return hook

    if train:
        handles = [getattr(tm, n).register_forward_hook(force(n))
                   for n in stages]
    tkw = {}
    if dropout:
        dropped = np.asarray(inter["Dropout_0"]["__call__"][0])
        tkw["dropout_keep"] = torch.from_numpy(dropped != 0)
    tx = [torch.from_numpy(np.asarray(v)) for v in xs]
    with torch.no_grad():
        got = tm(tx if isinstance(x, list) else tx[0], **tkw)
    for h in handles:
        h.remove()
    assert_close(got.numpy(), np.asarray(out), 1e-5, "output")
    for name, outs in own.items():
        want = [a for n in stages[name] for a in jax_out(n)]
        for o, w in zip(outs, want):
            assert_close(o, w, 1e-5, name)
    check_stats(tm, mut["batch_stats"])
    return tm


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("arch", ["slow", "i3d", "c2d"])
def test_single_pathway_resnet_matches_jax(arch, train):
    jm = jsf.SinglePathwayResNet(arch=arch, depth=18, width_per_group=W)
    _net_case(jm, lambda: tsf.SinglePathwayResNet(
        arch=arch, depth=18, width_per_group=W), clips(8 if train else 2),
        train)


SF_CASES = {"d18": (18, "head", False), "d50": (50, "head", False),
            "d50_train": (50, "head", True),
            "d18_train": (18, "head", True),
            "d18_classifier_train": (18, "classifier", True)}


@pytest.mark.parametrize("case", sorted(SF_CASES))
def test_slowfast_matches_jax(case):
    depth, head, train = SF_CASES[case]
    kw = dict(depth=depth, width_per_group=W,
              projection_head=head == "head", projection1_out=32,
              classifier=head == "classifier", num_classes=7)
    x = jsf.multipathway_input(jnp.asarray(clips(8 if train else 2)), 4)
    x = [np.asarray(v) for v in x]
    tm = _net_case(jsf.SlowFast(**kw), lambda: tsf.SlowFast(**kw), x, train,
                   dropout=head == "classifier")
    assert ("head.projection.weight" in tm.state_dict()) == \
        (head == "classifier")


@pytest.mark.parametrize("alpha", [2, 4, 8])
def test_slow_pathway_frames_match_jax(alpha):
    """The slow pathway's frames for every T from 1 to 64: the indices the
    JAX ``multipathway_input`` takes (its float32 linspace, truncated)
    against the port's."""
    for t in range(1, 65):
        want = jnp.linspace(0, t - 1, t // alpha).astype(jnp.int32)
        np.testing.assert_array_equal(tsf.slow_indices(t, alpha),
                                      np.asarray(want), f"T={t}")


@pytest.mark.parametrize("fast_mask", [False, True])
@pytest.mark.parametrize("alpha", [2, 4, 8])
def test_multipathway_input_matches_jax(alpha, fast_mask):
    for t in (1, 7, 8, 32, 37):
        x = clips(2, (t, 3, 2, 4), seed=t)
        want = jsf.multipathway_input(jnp.asarray(x), alpha, fast_mask)
        got = tsf.multipathway_input(torch.from_numpy(x), alpha, fast_mask)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"T={t}")


def _cfgs(extra=()):
    opts = ["MODEL.ARCH", "slowfast", "SLOWFAST.DEPTH", 18,
            "DATA.SAMPLE_DURATION", CLIP[0], "DATA.SAMPLE_SIZE", CLIP[1],
            "TPU.COMPUTE_DTYPE", "float32", "SLOWFAST.OUT_DIM", 16,
            "DATASET.SAMPLING_STRATEGY", "random_negative",
            "OPTIM.LR", 0.1, "OPTIM.MOMENTUM", 0.5] + list(extra)
    out = []
    for get in (j_get_cfg, t_get_cfg):
        cfg = get()
        cfg.merge_from_list(opts)
        out.append(cfg)
    return out


def _models(dtype=jnp.float32, seed=13):
    """SlowFast-18 at width 8 with a 16-d projection in both packages, from
    the same seeded weights (the registry builds width 64)."""
    kw = dict(depth=18, width_per_group=W, projection1_out=32,
              projection2_out=16)
    jm = jsf.SlowFast(**kw, dtype=dtype)
    sample = jsf.multipathway_input(jnp.zeros((1,) + CLIP), 4)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), sample,
                                            train=False))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "'scale'" in name or "'var'" in name:
            return rng.uniform(0.5, 1.5, s.shape)
        if "'bias'" in name or "'mean'" in name:
            return rng.normal(0, 0.1, s.shape)
        return rng.normal(size=s.shape) * np.sqrt(
            2.0 / np.prod(s.shape[:-1]))

    params, stats = (jax.tree_util.tree_map_with_path(draw, shapes[k])
                     for k in ("params", "batch_stats"))
    params, stats = jax.tree.map(lambda v: np.asarray(v, np.float32),
                                 (params, stats))
    tm = tsf.SlowFast(**kw)
    tm.load_state_dict(t_ckpt.flax_slowfast_to_torch(params, stats))
    return jm, params, stats, tm


class _WideNumpy:
    """``jax.numpy`` with ``float32`` read as ``float64``: the JAX SlowFast
    module's hard float32 (its zero-scale BatchNorms and the Nonlocal
    affinity) then computes in float64 too."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def jax_float64(monkeypatch):
    """JAX in float64: x64 on, the BatchNorm compute-dtype hook and the
    SlowFast module's float32 at float64."""
    monkeypatch.setattr(j_layers, "_bn_compute_dtype", lambda: jnp.float64)
    monkeypatch.setattr(jsf, "jnp", _WideNumpy())
    with jax.enable_x64(True):
        yield


def test_slowfast_triplet_step_matches_jax(jax_float64):
    """One triplet step of SlowFast-18 (width 8, 4 anchors, random_negative
    mining, lr 0.1), the network in float64 on both sides: the loss within
    1e-6 relative, every parameter and statistic within 1e-6."""
    jcfg, tcfg = _cfgs()
    jm, params, stats, tm = _models(dtype=jnp.float64)
    tm.double()
    params, stats = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64),
                                 (params, stats))
    tx = j_make_optimizer(jcfg)  # (create_train_state's eager init is slow)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=stats, opt_state=jax.jit(tx.init)(params),
                       tx=tx,
                       apply_fn=jm.apply)
    rng = np.random.default_rng(4)
    b = 4
    batch = {k: 0.5 * rng.normal(size=(b,) + CLIP)
             for k in ("anchor", "positive")}
    a_t = np.array([0, 1, 0, 1])
    batch["targets"] = np.concatenate([a_t, a_t])
    key = jax.random.key(10)
    noise = torch.from_numpy(np.array(jax.random.gumbel(
        jax.random.split(key)[0], (2 * b,) * 3, dtype=jnp.float32)))
    state, jmet = j_triplet_step(jcfg)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    opt, sched = t_make_optimizer(tcfg, tm.parameters())
    tmet = make_triplet_train_step(tcfg, tm, opt, sched, device="cpu")(
        {k: torch.from_numpy(v) for k, v in batch.items()}, noise=noise)
    assert int(tmet["n_triplets"]) == int(jmet["n_triplets"]) > 0
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-6)
    sd = {k: v.numpy() for k, v in t_ckpt.flax_slowfast_to_torch(
        jax.tree.map(np.asarray, state.params),
        jax.tree.map(np.asarray, state.batch_stats)).items()
        if not k.endswith("num_batches_tracked")}
    own = tm.state_dict()
    assert set(sd) <= set(own)
    for k, v in sd.items():
        np.testing.assert_allclose(own[k].numpy(), v, atol=1e-6, err_msg=k)


def test_embed_and_validate_on_slowfast():
    """The eval embed step and the validation step split the pathways on
    the device and give JAX's embeddings and distances."""
    jcfg, tcfg = _cfgs()
    jm, params, stats, tm = _models()
    x = clips(3, seed=6)
    want = np.asarray(j_embed_step(jcfg, jm)(params, stats, jnp.asarray(x)))
    got = make_embed_step(tcfg, tm, device="cpu")(torch.from_numpy(x))
    assert got.shape == (3, 16)
    assert_close(got.numpy(), want, 1e-5, "embeddings")
    views = [clips(2, seed=s) for s in (7, 8, 9)]
    jl, jc, je = j_validate_step(jcfg, jm)(params, stats,
                                           *map(jnp.asarray, views))
    tl, tc, te = t_validate_step(tcfg, tm, device="cpu")(
        *map(torch.from_numpy, views))
    assert_close(te.numpy(), np.asarray(je), 1e-5, "anchor embeddings")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def _gold_blobs():
    """The Caffe2-layout blob dict of ``tests/test_caffe2_import.py``, made
    from the port's own SlowFast-50 (the reference's torch names) plus
    solver blobs, and the same model's state_dict."""
    torch.manual_seed(0)
    tm = tsf.SlowFast(depth=50, width_per_group=W)
    sd = {k: v.numpy().copy() for k, v in tm.state_dict().items()}
    blobs = {c2: v for k, v in sd.items()
             if (c2 := _torch_key_to_caffe2(k)) is not None}
    blobs.update({"conv1_w_momentum": np.zeros(3), "lr": np.float32(0.1),
                  "model_iter": np.int64(1000)})
    return tm, sd, blobs


def test_caffe2_import_matches_jax(tmp_path):
    tm, sd, blobs = _gold_blobs()
    want = j_ckpt.caffe2_blobs_to_torch_sd(blobs, verbose=False)
    got = t_ckpt.caffe2_blobs_to_torch_sd(blobs, verbose=False)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
        assert t_ckpt.caffe2_name_to_torch(k) == j_ckpt.caffe2_name_to_torch(k)
    # the JAX importer reads the port's converted dict to its own trees
    jp, js = j_ckpt.torch_slowfast_to_flax({k: v.numpy()
                                            for k, v in got.items()})
    wp, ws = j_ckpt.torch_slowfast_to_flax(want)
    assert_trees_close(jp, wp, atol=0)
    assert_trees_close(js, ws, atol=0)
    # a .pkl loads every backbone tensor into a fresh port model
    path = tmp_path / "slowfast.pkl"
    with open(path, "wb") as f:
        pickle.dump({"blobs": blobs}, f, protocol=2)
    payload = t_ckpt.load_checkpoint(str(path))
    assert payload["epoch"] == 0 and set(payload["torch_state_dict"]) == \
        set(got)
    fresh = tsf.SlowFast(depth=50, width_per_group=W)
    out = t_ckpt.load_encoder_state(
        fresh, t_ckpt.load_torch_checkpoint(str(path))["torch_state_dict"],
        verbose=False)
    assert all(k.startswith(("fc1.", "fc2.")) or k.endswith(
        "num_batches_tracked") for k in out["missing"])
    own = fresh.state_dict()
    for k in got:
        assert torch.equal(own[k], torch.from_numpy(sd[k])), k


def test_sub_to_normal_bn_sd_matches_jax():
    rng = np.random.default_rng(1)
    sd = {
        "s1.pathway0_stem.bn.weight": rng.normal(size=(8, 1, 1, 1)),
        "s1.pathway0_stem.bn.bias": rng.normal(size=(8, 1, 1, 1)),
        "s1.pathway0_stem.bn.bn.weight": rng.normal(size=8),
        "s1.pathway0_stem.bn.bn.running_mean": rng.normal(size=8),
        "s1.pathway0_stem.bn.bn.running_var": rng.uniform(size=8),
        "s1.pathway0_stem.bn.bn.num_batches_tracked": np.int64(3),
        "s1.pathway0_stem.bn.split_bn.running_mean": rng.normal(size=16),
        "s1.pathway0_stem.conv.weight": rng.normal(size=(8, 3, 1, 7, 7)),
    }
    want = j_ckpt.sub_to_normal_bn_sd(sd)
    for src in (sd, {k: torch.as_tensor(v) for k, v in sd.items()}):
        got = t_ckpt.sub_to_normal_bn_sd(src)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k])
    assert set(t_ckpt.sub_to_normal_bn_sd(want)) == set(want)
    # a Sub-BN state dict loads into the stem's plain BatchNorm
    stem = tsf.VideoModelStem([3], [8], [1])
    t_ckpt.load_encoder_state(stem, {k.replace("s1.", "", 1): torch.as_tensor(v)
                                     for k, v in sd.items()}, verbose=False)
    np.testing.assert_allclose(stem.pathway0_stem.bn.running_var.numpy(),
                               sd["s1.pathway0_stem.bn.bn.running_var"],
                               rtol=1e-6)


def test_2d_inflation_matches_jax(capsys):
    """A 2-D kernel inflates to the model's temporal size as JAX's
    ``merge_pretrained(inflate_temporal=True)`` does: kT copies of w / kT;
    without the flag it stays at init."""
    w2d = np.random.default_rng(0).normal(size=(8, 3, 7, 7)).astype(
        np.float32)
    loaded, _ = j_ckpt.torch_slowfast_to_flax(
        {"s1.pathway0_stem.conv.weight": w2d})
    init = {"s1_pathway0_stem": {"conv": {"Conv_0": {
        "kernel": jnp.zeros((5, 7, 7, 3, 8), jnp.float32)}}}}
    merged, _ = j_ckpt.merge_pretrained(init, {}, loaded, {},
                                        inflate_temporal=True)
    want = np.transpose(np.asarray(
        merged["s1_pathway0_stem"]["conv"]["Conv_0"]["kernel"]),
        (4, 3, 0, 1, 2))
    for inflate in (True, False):
        stem = tsf.VideoModelStem([3], [8], [5])
        before = stem.pathway0_stem.conv.weight.detach().clone()
        t_ckpt.merge_pretrained(stem, {"pathway0_stem.conv.weight":
                                       torch.from_numpy(w2d)},
                                inflate_temporal=inflate)
        got = stem.pathway0_stem.conv.weight.detach()
        if inflate:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
            assert "temporally inflated 1" in capsys.readouterr().out
        else:
            assert torch.equal(got, before)
    # a kT = 1 target takes a 2-D kernel without inflation, as in JAX
    stem = tsf.VideoModelStem([3], [8], [1])
    t_ckpt.load_encoder_state(stem, {
        "pathway0_stem.conv.weight": torch.from_numpy(w2d),
        **{f"pathway0_stem.bn.{k}": v for k, v in
           tsf.ResNetBasicStem(3, 8, 1).bn.state_dict().items()}},
        verbose=False)
    np.testing.assert_array_equal(stem.pathway0_stem.conv.weight[:, :, 0]
                                  .detach().numpy(), w2d)


SF_YAML = ("MODEL:\n  ARCH: slowfast\nSLOWFAST:\n  DEPTH: 18\n"
           f"DATA:\n  SAMPLE_SIZE: {CLIP[1]}\n  SAMPLE_DURATION: {CLIP[0]}\n"
           "TRAIN:\n  DATASET: ucf101\n  BATCH_SIZE: 4\n  EPOCHS: 1\n"
           "  NUM_DATA_WORKERS: 2\n  LOG_INTERVAL: 100\n"
           "  RETRIEVAL_INTERVAL: 1\n"
           "VAL:\n  BATCH_SIZE: 4\n"
           "LOSS:\n  K: 4\n  FEAT_DIM: 128\n"
           "DATASET:\n  MODALITY: rgb\n"
           "OPTIM:\n  LR: 0.001\n"
           "TPU:\n  COMPUTE_DTYPE: float32\n")


@pytest.mark.parametrize("loss", ["triplet", "contrastive"])
def test_slowfast_cli_trains_and_evaluates(loss, tmp_path):
    """``MODEL.ARCH slowfast`` (SlowFast-18 at the registry's width 64)
    through the training CLI for an epoch with the triplet and the
    contrastive loss, and the evaluate CLI on the triplet run's
    checkpoint."""
    from synthetic_data import make_synthetic_ucf
    from video_similarity_search_tpu_torch.cli import evaluate as t_eval
    from video_similarity_search_tpu_torch.cli import online_train as t_cli

    vid, ann = make_synthetic_ucf(str(tmp_path / "data"), with_test=True)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(SF_YAML)
    out = str(tmp_path / "out")
    data = ["DATASET.VID_PATH", vid, "DATASET.ANNOTATION_PATH", ann]
    t_cli.main(["--cfg", str(cfg), "--output", out, "--device", "cpu"]
               + data + ["LOSS.TYPE", loss])
    ckpt = tmp_path / "out" / "tnet_checkpoints" / "slowfast" / \
        "checkpoint.pth.tar"
    with open(tmp_path / "out" / "tnet_checkpoints" /
              "train_loss_and_acc.txt") as f:
        assert np.isfinite(float(f.read().split()[-1]))
    if loss == "triplet":
        topk = t_eval.main(["--cfg", str(cfg), "--output",
                            str(tmp_path / "eval"), "--checkpoint_path",
                            str(ckpt), "--device", "cpu"] + data)
        assert set(topk) >= {1, 5} and 0.0 <= topk[1] <= 1.0
