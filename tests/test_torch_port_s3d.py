"""The port's S3D / S3D-G, R3D and their embedders against the JAX
package's, on the CPU in float32, with the JAX weights carried across by
``flax_s3d_to_torch`` / ``flax_r3d_to_torch``.

* eval mode, (2, 8, 32, 32, 3) clips: the S3D(-G) feature map, the R3D
  and S3D embedders within 1e-5 of the output's largest magnitude;
* train mode, (8, 8, 32, 32, 3) clips, each block fed the JAX block's
  input: every block's output within 1e-5 of its largest magnitude, and
  every BatchNorm's running statistics within 1e-5. Two things make an
  end-to-end float32 comparison meaningless at these sizes, and the test
  steps around both. A train-mode BatchNorm over a handful of values
  amplifies rounding: at batch 2, block 5 normalizes 2 values a channel,
  and the port's own float32 run is 1.6 from its float64 run at the
  output. And flax's default variance, E[x^2] - E[x]^2, puts the JAX
  blocks up to 9e-5 from a float64 run where the port's two-pass variance
  stays within 1e-5. So the JAX side runs flax's two-pass variance
  (``use_fast_variance=False``) here, batch 8 gives block 5 eight values
  a channel, and each block starts from JAX's input;
* the JAX package's own importers (``torch_s3d_backbone_to_flax``,
  ``torch_s3d_to_flax``, ``torch_r3d_to_flax``) read the port's
  ``state_dict`` back to the same trees, the reference's ``blockN.M``
  aliases load through ``load_torch_checkpoint``, ``merge_pretrained``
  loads by name and shape, and the registry builds ``s3d`` / ``r3d`` and
  the last archs to be ported (``slowfast``, ``info_nce``, ``uber_nce``)
  with the JAX registry's shapes.
"""

import functools

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_similarity_search_tpu.config import get_cfg as j_get_cfg
from video_similarity_search_tpu.models import model_selector as j_selector
from video_similarity_search_tpu.models.r3d import R3DNet as JR3DNet
from video_similarity_search_tpu.models.s3d import S3D as JS3D
from video_similarity_search_tpu.train.checkpoint import (
    torch_r3d_backbone_to_flax, torch_r3d_to_flax, torch_s3d_backbone_to_flax,
    torch_s3d_to_flax)
from video_similarity_search_tpu_torch.config import get_cfg as t_get_cfg
from video_similarity_search_tpu_torch.models import model_selector as t_selector
from video_similarity_search_tpu_torch.models.heads import R3DEmbedder
from video_similarity_search_tpu_torch.models.r3d import R3DNet
from video_similarity_search_tpu_torch.models.s3d import S3D
from video_similarity_search_tpu_torch.train import (make_embed_step,
                                                     make_optimizer,
                                                     make_triplet_train_step)
from video_similarity_search_tpu_torch.train.checkpoint import (
    flax_r3d_to_torch, flax_s3d_to_torch, load_encoder_state,
    load_torch_checkpoint, merge_pretrained)

CLIP = (8, 32, 32, 3)
B_EVAL, B_TRAIN = 2, 8
S3D_BLOCKS = ("Conv_1a", "Conv_2b", "Conv_2c", "Mixed_3b", "Mixed_3c",
              "Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f",
              "Mixed_5b", "Mixed_5c")


class ExactVarianceBatchNorm(flax.linen.BatchNorm):
    """flax's BatchNorm with its two-pass variance (see the docstring)."""

    use_fast_variance: bool = False


ExactVarianceBatchNorm.__name__ = "BatchNorm"  # flax names it BatchNorm_0


@pytest.fixture(scope="module", autouse=True)
def exact_variance():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "BatchNorm", ExactVarianceBatchNorm)
        yield


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op threads: a parallel test run shares the cores among
    its workers, and an oversubscribed torch runs several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def random_variables(module, x, seed):
    """Seeded numpy weights of ``module``'s shapes: He-normal kernels,
    BatchNorm scale/bias and running statistics spread around their
    defaults so that they matter."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), x,
                                                train=False))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "'scale'" in name or "'var'" in name:
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if "'bias'" in name or "'mean'" in name:
            return rng.normal(0, 0.1, s.shape).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.normal(size=s.shape) * np.sqrt(2.0 / fan_in)
                ).astype(np.float32)

    return (jax.tree_util.tree_map_with_path(draw, shapes["params"]),
            jax.tree_util.tree_map_with_path(draw, shapes["batch_stats"]))


def japply(module, variables, x, **kw):
    """``module.apply`` jitted: op-by-op dispatch of a whole net costs more
    than its compile."""
    return jax.jit(functools.partial(module.apply, **kw))(variables,
                                                          jnp.asarray(x))


def clips(b, seed=0):
    return np.random.default_rng(seed).normal(size=(b,) + CLIP).astype(
        np.float32)


def assert_close(got, want, tol, what=""):
    """|got - want| <= tol * max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def assert_trees_close(got, want, atol):
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(want_leaves) == len(got_leaves)
    for path, leaf in want_leaves:
        np.testing.assert_allclose(np.asarray(got_leaves[path]),
                                   np.asarray(leaf), atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def numpy_sd(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def teacher_force(model, names, jax_outputs):
    """Forward hooks that make each named block pass JAX's output on
    (value only: the gradient still flows through the port's block) and
    record the port's own output. -> (record, hook handles)."""
    own, handles = {}, []

    def hook(name):
        def f(mod, inp, out):
            own[name] = out.detach().permute(0, 2, 3, 4, 1).numpy()
            want = torch.from_numpy(np.array(jax_outputs[name])).permute(
                0, 4, 1, 2, 3)
            return out + (want - out).detach()
        return f

    for n in names:
        handles.append(getattr(model, n).register_forward_hook(hook(n)))
    return own, handles


@pytest.fixture(scope="module", params=[False, True], ids=["s3d", "s3dg"])
def s3d(request):
    """One JAX S3D(-G) per gating: weights, the eval output at batch 2, and
    the train-mode block outputs and statistics at batch 8."""
    gating = request.param
    jm = JS3D(gating=gating)
    params, stats = random_variables(jm, jnp.zeros((1,) + CLIP),
                                     seed=1 + gating)
    variables = {"params": params, "batch_stats": stats}
    x_eval, x_train = clips(B_EVAL), clips(B_TRAIN, seed=1)
    y_eval = np.asarray(japply(jm, variables, x_eval, train=False))
    _, mut = japply(jm, variables, x_train, train=True,
                    mutable=["batch_stats", "intermediates"],
                    capture_intermediates=True)
    blocks = {n: np.asarray(mut["intermediates"][n]["__call__"][0])
              for n in S3D_BLOCKS}
    return {"gating": gating, "params": params, "stats": stats,
            "x_eval": x_eval, "y_eval": y_eval, "x_train": x_train,
            "blocks": blocks, "new_stats": mut["batch_stats"]}


def port_s3d(s):
    model = S3D(gating=s["gating"])
    model.load_state_dict(flax_s3d_to_torch(s["params"], s["stats"]))
    return model


def test_s3d_eval_forward_matches_jax(s3d):
    model = port_s3d(s3d).eval()
    with torch.no_grad():
        y = model(torch.from_numpy(s3d["x_eval"]))
    assert y.shape == (B_EVAL, 1024, 1, 1, 1)
    assert_close(y.permute(0, 2, 3, 4, 1).numpy(), s3d["y_eval"], 1e-5)


def test_s3d_train_forward_and_statistics_match_jax(s3d):
    model = port_s3d(s3d).train()
    own, _ = teacher_force(model, S3D_BLOCKS, s3d["blocks"])
    with torch.no_grad():
        model(torch.from_numpy(s3d["x_train"]))
    for name in S3D_BLOCKS:
        assert_close(own[name], s3d["blocks"][name], 1e-5, name)
    _, t_stats = torch_s3d_backbone_to_flax(numpy_sd(model))
    assert_trees_close(t_stats, s3d["new_stats"], atol=1e-5)


def test_jax_importer_reads_the_ports_s3d_state_dict(s3d):
    t_params, t_stats = torch_s3d_backbone_to_flax(numpy_sd(port_s3d(s3d)))
    assert_trees_close(t_params, s3d["params"], atol=0)
    assert_trees_close(t_stats, s3d["stats"], atol=0)


def test_s3d_collapsed_dimension_raises():
    with pytest.raises(AssertionError, match="need T>=8"):
        S3D()(torch.zeros(1, 4, 32, 32, 3))


@pytest.mark.parametrize("arch", ["s3d", "r3d"])
def test_registry_embedders_match_jax(arch, tmp_path):
    """model_selector builds the same embedder in both packages, and the
    port's eval step (the evaluate path's ``make_embed_step``) gives JAX's
    embeddings; the port's weights go to JAX through the JAX importer and
    back."""
    jcfg, tcfg = j_get_cfg(), t_get_cfg()
    for cfg in (jcfg, tcfg):
        cfg.MODEL.ARCH = arch
        cfg.TPU.COMPUTE_DTYPE = "float32"
    jm, tm = j_selector(jcfg), t_selector(tcfg)
    params, stats = random_variables(jm, jnp.zeros((1,) + CLIP), seed=3)
    to_torch, to_flax = ((flax_s3d_to_torch, torch_s3d_to_flax)
                         if arch == "s3d" else
                         (flax_r3d_to_torch, torch_r3d_to_flax))
    tm.load_state_dict(to_torch(params, stats))
    x = clips(B_EVAL)
    want = np.asarray(japply(jm, {"params": params, "batch_stats": stats},
                             x, train=False))
    got = make_embed_step(tcfg, tm, device="cpu")(torch.from_numpy(x)).numpy()
    assert got.shape == (B_EVAL, 128)
    assert_close(got, want, 1e-5, arch)
    p2, s2 = to_flax(numpy_sd(tm))
    assert_trees_close(p2, params, atol=1e-7)
    assert_trees_close(s2, stats, atol=0)
    # a reference-layout file (DDP prefix, S3D's block aliases beside the
    # direct names) loads every tensor through load_torch_checkpoint
    sd = {"module." + k: v for k, v in tm.state_dict().items()}
    if arch == "s3d":
        sd.update({"module.0.block3.1." + k[len("0.Mixed_3b."):]: v
                   for k, v in tm.state_dict().items()
                   if k.startswith("0.Mixed_3b.")})
    path = str(tmp_path / "ref.pth.tar")
    torch.save({"state_dict": sd}, path)
    fresh = t_selector(tcfg)
    loaded = load_encoder_state(
        fresh, load_torch_checkpoint(path)["torch_state_dict"])
    assert loaded["missing"] == [] and loaded["skipped"] == []
    with torch.no_grad():
        np.testing.assert_array_equal(fresh.eval()(torch.from_numpy(x)).numpy(),
                                      got)


@pytest.mark.parametrize("arch", ["s3d", "r3d"])
def test_registry_embedders_take_a_triplet_step(arch):
    """The pretrain path's triplet step runs on the S3D and R3D embedders
    and moves every weight."""
    cfg = t_get_cfg()
    cfg.MODEL.ARCH = arch
    model = t_selector(cfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_triplet_train_step(cfg, model,
                                   *make_optimizer(cfg, model.parameters()),
                                   device="cpu")
    x = torch.from_numpy(clips(8, seed=3))
    met = step({"anchor": x[:4], "positive": x[4:],
                "targets": torch.tensor([0, 1, 0, 1] * 2)},
               generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(met["loss"])) and int(met["n_triplets"]) > 0
    still = [k for k, p in model.named_parameters()
             if torch.equal(p.detach(), before[k])]
    assert still == []


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_r3d_backbone_matches_jax(train):
    """R3DNet(1,1,1,1): eval at batch 2; train mode at batch 8, each stage
    fed JAX's input, with the statistics after it."""
    jm = JR3DNet(layer_sizes=(1, 1, 1, 1))
    params, stats = random_variables(jm, jnp.zeros((1,) + CLIP), seed=4)
    model = R3DNet((1, 1, 1, 1))
    model.load_state_dict(flax_r3d_to_torch(params, stats))
    x = clips(B_TRAIN if train else B_EVAL, seed=2)
    out, mut = japply(jm, {"params": params, "batch_stats": stats}, x,
                      train=train, mutable=["batch_stats", "intermediates"],
                      capture_intermediates=True)
    model.train(train)
    stages = ("conv2", "conv3", "conv4", "conv5")
    jax_stage = {f"conv{s}": mut["intermediates"][f"conv{s}_block0"]
                 ["__call__"][0] for s in range(2, 6)}
    own, _ = teacher_force(model, stages, jax_stage)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert_close(got, np.asarray(out), 1e-5, "pooled features")
    for name in stages:
        assert_close(own[name], jax_stage[name], 1e-5, name)
    t_params, t_stats = torch_r3d_backbone_to_flax(numpy_sd(model))
    assert_trees_close(t_stats, mut["batch_stats"], atol=1e-5)
    assert_trees_close(t_params, params, atol=0)


def test_r3d_embedder_options():
    """The classifier head and the flattened conv map of R3DNet, and the
    embedder's reference key names."""
    x = torch.from_numpy(clips(B_EVAL))
    assert R3DNet(with_classifier=True, num_classes=7).eval()(x).shape == (2, 7)
    jm = JR3DNet(layer_sizes=(1, 1, 1, 1), return_conv=True)
    params, stats = random_variables(jm, jnp.zeros((1,) + CLIP), seed=5)
    model = R3DNet(return_conv=True)
    model.load_state_dict(flax_r3d_to_torch(params, stats))
    want = japply(jm, {"params": params, "batch_stats": stats}, x.numpy(),
                  train=False)
    with torch.no_grad():
        assert_close(model.eval()(x).numpy(), np.asarray(want), 1e-5)
    keys = set(R3DEmbedder().state_dict())
    assert {"0.conv1.temporal_spatial_conv.weight",
            "0.conv3.block1.downsampleconv.temporal_spatial_conv.weight",
            "1.weight", "3.bias"} <= keys


def test_merge_pretrained_counts(capsys):
    model = S3D()
    donor = S3D(gating=True).state_dict()
    donor["Conv_1a.conv1.weight"] = torch.zeros(1)  # a shape mismatch
    matched, kept = merge_pretrained(model, donor)
    own = model.state_dict()
    assert kept == 1 and matched == len(own) - 1
    assert "partial load: matched" in capsys.readouterr().out
    assert torch.equal(own["Conv_2b.conv.weight"], donor["Conv_2b.conv.weight"])


@pytest.mark.parametrize("arch,item", [("slowfast", "item 17"),
                                       ("info_nce", "item 16"),
                                       ("uber_nce", "item 16")])
def test_archs_still_to_port_raise(arch, item):
    """The archs that raised until their ROADMAP item was ported now build
    from the registry, at the config's defaults, with the parameter and
    statistic shapes of the JAX registry's module, and load its weights
    carried across (SlowFast-50 at width 64, the MoCo S3D encoder)."""
    from video_similarity_search_tpu.models.slowfast import \
        multipathway_input
    from video_similarity_search_tpu_torch.train.checkpoint import (
        flax_moco_encoder_to_torch, flax_slowfast_to_torch)
    jcfg, tcfg = j_get_cfg(), t_get_cfg()
    for cfg in (jcfg, tcfg):
        cfg.MODEL.ARCH = arch
    jm, tm = j_selector(jcfg), t_selector(tcfg)
    x = jnp.zeros((1,) + CLIP)
    if arch == "slowfast":
        x = multipathway_input(x, jcfg.SLOWFAST.ALPHA)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), x,
                                            train=False))
    to_torch = (flax_slowfast_to_torch if arch == "slowfast"
                else flax_moco_encoder_to_torch)
    rng = np.random.default_rng(len(arch))
    params, stats = (jax.tree.map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes[k])
        for k in ("params", "batch_stats"))
    sd = to_torch(params, stats)
    own = tm.state_dict()
    assert set(sd) == set(own), item
    tm.load_state_dict(sd)
    for k, v in sd.items():
        assert torch.equal(tm.state_dict()[k], v), k


def test_s3d_key_names_are_the_references():
    keys = set(S3D(gating=True).state_dict())
    assert {"Conv_1a.conv1.weight", "Mixed_3b.branch1.1.conv2.weight",
            "Mixed_3b.branch3.1.conv.weight", "Mixed_4b.gating_b0.fc.weight",
            "Mixed_4b.gating_b0.fc.bias"} <= keys
    assert not any(k.endswith(("conv.bias", "conv1.bias", "conv2.bias"))
                   for k in keys)
