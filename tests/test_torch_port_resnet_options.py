"""The port's ResNet3D options against the flax ResNet3D, on the CPU in
float32: a narrow R3D-10 (inplanes 8/16/32/64, 4 frames of 16 px, 4
clips), flax weights with randomized BatchNorm terms carried across by
``flax_resnet3d_to_torch``.

* ``attention``, the classifier head with dropout (JAX's mask read off
  ``Dropout_0``'s output and injected), the temporal-downsample head,
  ``stem_s2d`` and ``remat``: the output in eval and in train mode within
  1e-4 and the BatchNorm running statistics after the train-mode forward
  within 1e-5;
* the space-to-depth stem equals the 7x7 stem, its weights made by
  ``conv1_kernel_to_s2d`` (also when a 7x7 checkpoint is loaded into an
  s2d model);
* ``remat`` (all stages, or stage 1) gives the gradient and the running
  statistics of the plain model (ROADMAP hazard H7: the recomputed
  forward must not write the statistics a second time).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_similarity_search_tpu.models import generate_model as j_generate
from video_similarity_search_tpu.train.checkpoint import \
    torch_resnet3d_to_flax
from video_similarity_search_tpu_torch.models import generate_model as t_generate
from video_similarity_search_tpu_torch.models.resnet3d import (
    conv1_kernel_to_s2d, space_to_depth)
from video_similarity_search_tpu_torch.train.checkpoint import (
    flax_resnet3d_to_torch, load_encoder_state)

T, S, B = 4, 16, 4
KW = dict(block_inplanes=(8, 16, 32, 64), hidden_layer=32, out_dim=8,
          no_max_pool=True)
OPTIONS = {
    "attention": dict(attention=True),
    "classifier": dict(classifier=True, dropout=0.5, num_classes=5),
    "predict_temporal_ds": dict(predict_temporal_ds=True),
    "stem_s2d": dict(stem_s2d=True),
    "remat": dict(remat=True),
}


def _clips(seed=1):
    rng = np.random.default_rng(seed)
    return rng.normal(0.2, 1.0, size=(B, T, S, S, 3)).astype(np.float32)


def _models(opts, seed=0):
    """The flax model and its variables (BatchNorm terms randomized) and
    the port's model holding the same values."""
    jmodel = j_generate(10, **KW, **opts)
    variables = jmodel.init(jax.random.key(seed),
                            jnp.zeros((2, T, S, S, 3)), train=False)
    rng = np.random.default_rng(seed)

    def rand(path, v):
        name = jax.tree_util.keystr(path)
        if "BatchNorm" in name and "scale" in name:
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if "bias" in name:
            return rng.normal(0, 0.1, v.shape).astype(np.float32)
        return np.asarray(v)

    params = jax.tree_util.tree_map_with_path(rand, variables["params"])
    stats = jax.tree.map(
        lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32),
        variables["batch_stats"])
    tmodel = t_generate(10, **KW, **opts)
    tmodel.load_state_dict(flax_resnet3d_to_torch(
        params, stats, use_dropout=bool(opts.get("dropout"))))
    return jmodel, params, stats, tmodel


def _outputs(out):
    return [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]


def _port_stats(tmodel):
    sd = {k: v.detach().numpy() for k, v in tmodel.state_dict().items()}
    return torch_resnet3d_to_flax(sd)[1]


def _assert_trees_close(got, want, atol):
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(want_leaves) == len(got_leaves)
    for path, leaf in want_leaves:
        np.testing.assert_allclose(np.asarray(got_leaves[path]),
                                   np.asarray(leaf), atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_option_matches_flax_in_eval_and_train_mode(option):
    jmodel, params, stats, tmodel = _models(OPTIONS[option])
    x = _clips()
    apply = jax.jit(jmodel.apply, static_argnames=(
        "train", "mutable", "capture_intermediates"))
    want = apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                 train=False)
    tmodel.eval()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    for g, w in zip(_outputs(got), _outputs(want)):
        np.testing.assert_allclose(g, w, atol=1e-4)

    want, mut = apply({"params": params, "batch_stats": stats},
                      jnp.asarray(x), train=True,
                      mutable=("batch_stats", "intermediates"),
                      capture_intermediates=True,
                      rngs={"dropout": jax.random.key(3)})
    keep = None
    if "Dropout_0" in mut["intermediates"]:
        keep = torch.from_numpy(np.asarray(
            mut["intermediates"]["Dropout_0"]["__call__"][0]) != 0)
    tmodel.train()
    got = tmodel(torch.from_numpy(x), dropout_keep=keep)
    for g, w in zip(_outputs(tuple(o.detach() for o in got)
                             if isinstance(got, tuple) else got.detach()),
                    _outputs(want)):
        np.testing.assert_allclose(g, w, atol=1e-4)
    _assert_trees_close(_port_stats(tmodel), mut["batch_stats"], atol=1e-5)


def test_s2d_stem_equals_the_7x7_stem():
    torch.manual_seed(0)
    plain = t_generate(10, **KW)
    s2d = t_generate(10, **KW, stem_s2d=True)
    sd = plain.state_dict()
    s2d.load_state_dict(dict(sd, **{
        "conv1.weight": conv1_kernel_to_s2d(sd["conv1.weight"])}))
    x = torch.from_numpy(_clips(2))
    plain.eval()
    s2d.eval()
    with torch.no_grad():
        np.testing.assert_allclose(s2d(x).numpy(), plain(x).numpy(),
                                   atol=1e-5)
        # the stems alone, before BatchNorm
        want = plain.conv1(x.permute(0, 4, 1, 2, 3))
        xs = space_to_depth(x).permute(0, 4, 1, 2, 3)
        got = s2d.conv1(xs)[..., :S // 2, :S // 2]
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    # a 7x7 checkpoint loads into the s2d model through the transform
    fresh = t_generate(10, **KW, stem_s2d=True)
    load_encoder_state(fresh, sd, verbose=False)
    assert torch.equal(fresh.conv1.weight, s2d.conv1.weight)


@pytest.mark.parametrize("stages", [None, (1,)])
def test_remat_keeps_the_gradient_and_the_statistics(stages):
    torch.manual_seed(0)
    plain = t_generate(10, **KW)
    remat = t_generate(10, **KW, remat=True, remat_stages=stages)
    remat.load_state_dict(plain.state_dict())
    x = torch.from_numpy(_clips(3))
    for m in (plain, remat):
        m.train()
        for _ in range(2):  # statistics move once a forward
            m.zero_grad()
            (m(x) ** 2).sum().backward()
    for (name, p), q in zip(plain.named_parameters(), remat.parameters()):
        np.testing.assert_allclose(q.grad.numpy(), p.grad.numpy(), atol=1e-6,
                                   rtol=1e-5, err_msg=name)
    want, got = plain.state_dict(), remat.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v) or torch.allclose(
            got[k].float(), v.float(), atol=1e-7), k
