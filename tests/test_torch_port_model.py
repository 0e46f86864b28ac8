"""Parity of the PyTorch port's R3D models with the flax ResNet3D, on the
CPU.

Flax weights (with randomized BatchNorm statistics and affine terms) go
through ``flax_resnet3d_to_torch`` into the port; the eval forward on the
same numpy clips must agree within atol 2e-4 (float32, as in
tests/test_torch_parity.py). The port's state_dict must come back through
the JAX ``torch_resnet3d_to_flax`` unchanged.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_similarity_search_tpu.config import get_cfg as j_get_cfg
from video_similarity_search_tpu.models import generate_model as j_generate
from video_similarity_search_tpu.models.registry import \
    embedding_dim as j_embedding_dim
from video_similarity_search_tpu.models.registry import \
    model_selector as j_selector
from video_similarity_search_tpu.train.checkpoint import \
    torch_resnet3d_to_flax
from video_similarity_search_tpu_torch.config import get_cfg as t_get_cfg
from video_similarity_search_tpu_torch.models import generate_model as t_generate
from video_similarity_search_tpu_torch.models import \
    embedding_dim as t_embedding_dim
from video_similarity_search_tpu_torch.models import \
    model_selector as t_selector
from video_similarity_search_tpu_torch.train.checkpoint import \
    flax_resnet3d_to_torch

KW = dict(no_max_pool=True, widen_factor=0.25, hidden_layer=32, out_dim=16)


def _randomize(tree, rng):
    """Replace BN scale/bias/mean/var and dense biases by random values so
    the forward exercises them (their inits are constants)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
        elif k in ("scale", "var"):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k in ("bias", "mean"):
            out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


def _flax_weights(depth, shortcut, seed=0, x=None):
    model = j_generate(depth, shortcut_type=shortcut, **KW)
    x = np.zeros((1, 4, 32, 32, 3), np.float32) if x is None else x
    variables = model.init(jax.random.key(seed), jnp.asarray(x), train=False)
    rng = np.random.default_rng(seed)
    params = _randomize(jax.tree.map(np.asarray, variables["params"]), rng)
    stats = _randomize(jax.tree.map(np.asarray, variables["batch_stats"]),
                       rng)
    return model, params, stats


@pytest.mark.parametrize("depth,shortcut", [(10, "A"), (10, "B"), (18, "A"),
                                            (18, "B"), (50, "A")])
def test_eval_forward_matches_flax(depth, shortcut):
    x = np.random.default_rng(depth).normal(
        size=(2, 4, 32, 32, 3)).astype(np.float32)
    fmodel, params, stats = _flax_weights(depth, shortcut)
    expect = np.asarray(fmodel.apply({"params": params, "batch_stats": stats},
                                     jnp.asarray(x), train=False))
    tmodel = t_generate(depth, shortcut_type=shortcut, **KW)
    tmodel.load_state_dict(flax_resnet3d_to_torch(params, stats))
    with torch.no_grad():
        got = tmodel.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, expect, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("depth,shortcut", [(10, "A"), (18, "B")])
def test_state_dict_round_trips_through_jax_import(depth, shortcut):
    _, params, stats = _flax_weights(depth, shortcut, seed=1)
    tmodel = t_generate(depth, shortcut_type=shortcut, **KW)
    tmodel.load_state_dict(flax_resnet3d_to_torch(params, stats))
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    back_p, back_s = torch_resnet3d_to_flax(sd)
    for ref, got in ((params, back_p), (stats, back_s)):
        ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
        got_leaves = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(ref_leaves) == len(got_leaves)
        for path, leaf in ref_leaves:
            np.testing.assert_array_equal(np.asarray(got_leaves[path]), leaf)


def test_model_selector_full_width_matches_flax_shapes():
    """The Kinetics config's R3D-18 at full width: the port's parameter
    shapes equal the flax ones (read abstractly, nothing is computed)."""
    opts = ["MODEL.ARCH", "3dresnet", "RESNET.MODEL_DEPTH", 18,
            "DATA.SAMPLE_SIZE", 128, "DATA.SAMPLE_DURATION", 16]
    jcfg, tcfg = j_get_cfg(), t_get_cfg()
    jcfg.merge_from_list(list(opts))
    tcfg.merge_from_list(list(opts))
    assert tcfg == jcfg
    assert t_embedding_dim(tcfg) == j_embedding_dim(jcfg) == 128
    fmodel = j_selector(jcfg)
    shapes = jax.eval_shape(
        lambda: fmodel.init(jax.random.key(0),
                            jnp.zeros((1, 16, 128, 128, 3)), train=False))
    tmodel = t_selector(tcfg)
    n_flax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    # torch counts one num_batches_tracked scalar per BN layer extra
    n_bn = sum(isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
               for m in tmodel.modules())
    n_torch = sum(v.numel() for v in tmodel.state_dict().values())
    assert n_torch - n_bn == n_flax


@pytest.mark.parametrize("option", ["attention", "stem_s2d", "remat",
                                    "classifier", "predict_temporal_ds"])
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_generate(10, **{option: True}, **KW)
