"""The port's CoCLR clip transforms against the JAX package's
(``data/augment.py:258-443``), on the CPU, each from JAX's own draws.

The JAX functions draw from a key; the test repeats their key splits
(augment.py:292-443, the base augmentation's through
``test_torch_port_augment._jax_draws``) and injects the draws into the
port's (ROADMAP hazard H2). Tolerances: ``scale_clip`` 1e-3 on 0..255
floats and at most one level on uint8, with at most 0.1% of the values
one level off (hazard H5: the same Keys cubic weights, contracted in
another order; ties at .5 round either way); ``rotate_clip`` 1e-5;
``pad_clip``, ``random_gray_clip`` and ``center_crop_normalize`` equal
(1e-6 after normalizing); the controllers, whose base view crops and
resizes, 1e-4 as ``test_torch_port_augment.py``'s cropped chain.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_port_augment import _jax_draws
from video_similarity_search_tpu.data import augment as ja
from video_similarity_search_tpu_torch.data import augment as ta

S = 16  # output clip size of the controllers


def _clips(b=4, t=3, h=24, w=24, seed=0, dtype=np.uint8):
    x = np.random.default_rng(seed).integers(0, 256, (b, t, h, w, 3),
                                             np.uint8)
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_pad_clip_matches_jax(dtype):
    x = _clips(2, 2, 5, 7, dtype=dtype)
    want = np.asarray(ja.pad_clip(jnp.asarray(x), 3))
    got = ta.pad_clip(torch.from_numpy(x), 3).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw,size", [
    ((40, 56), 24),           # short edge (height) down, antialiased
    ((56, 40), 24),           # short edge (width) down
    ((24, 33), 24),           # short edge already 24: unchanged
    ((20, 26), 30),           # short edge up
    ((128, 170), (96, 128)),  # an exact size, both dims down
    ((40, 28), (60, 30)),     # height up, width nearly the same
    ((30, 30), (30, 45)),     # one dim unchanged, the other up
])
def test_scale_clip_matches_jax(hw, size):
    x = _clips(2, 2, *hw, seed=sum(hw))
    for dtype in (np.float32, np.uint8):
        xi = x.astype(dtype)
        want = np.asarray(ja.scale_clip(jnp.asarray(xi), size))
        got = ta.scale_clip(torch.from_numpy(xi), size).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
        if dtype == np.float32:
            assert diff.max() <= 1e-3, diff.max()
        else:
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, \
                ((diff > 0).sum(), diff.size)


def test_scale_clip_linear_matches_jax():
    x = _clips(1, 2, 40, 56, seed=9, dtype=np.float32)
    want = np.asarray(ja.scale_clip(jnp.asarray(x), (20, 70),
                                    method="linear"))
    got = ta.scale_clip(torch.from_numpy(x), (20, 70), method="linear")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


def _gray_draws(key, n, p):
    """random_gray_clip's draws (augment.py:311-313)."""
    k_do, k_ch = jax.random.split(key)
    apply = np.array(jax.random.uniform(k_do, (n,)) < p)
    channel = np.array(jax.random.randint(k_ch, (n,), 0, 3))
    return torch.from_numpy(apply), torch.from_numpy(channel)


@pytest.mark.parametrize("consistent,seq_len,n", [
    (True, 0, 4),          # one draw a clip
    (False, 0, 4 * 5),     # one a frame
    (True, 2, 4 * 3),      # one a block of 2 frames (5 = 2 + 2 + 1)
])
def test_random_gray_clip_matches_jax(consistent, seq_len, n):
    x = _clips(4, 5, 6, 6, seed=2)
    for seed in range(3):
        key = jax.random.key(seed)
        want = np.asarray(ja.random_gray_clip(
            jnp.asarray(x), key, p=0.5, consistent=consistent,
            seq_len=seq_len))
        apply, channel = _gray_draws(key, n, 0.5)
        got = ta.random_gray_clip(torch.from_numpy(x), 0.5, consistent,
                                  seq_len, apply=apply,
                                  channel=channel).numpy()
        np.testing.assert_array_equal(got, want)


def test_center_crop_normalize_matches_jax():
    x = _clips(3, 2, 24, 30, seed=4)
    for dataset in ("ucf101", "kinetics"):
        want = np.asarray(ja.center_crop_normalize(jnp.asarray(x), S,
                                                   dataset=dataset))
        got = ta.center_crop_normalize(torch.from_numpy(x), S,
                                       dataset=dataset).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("hw,degree,p", [((20, 28), 30.0, 0.7),
                                         ((17, 17), 15.0, 1.0),
                                         ((24, 16), 90.0, 0.5)])
def test_rotate_clip_matches_jax(hw, degree, p):
    x = (_clips(4, 2, *hw, seed=5) / 255.0).astype(np.float32)
    for seed in range(3):
        key = jax.random.key(seed)
        want = np.asarray(ja.rotate_clip(jnp.asarray(x), key, degree=degree,
                                         p=p))
        k_angle, k_do = jax.random.split(key)  # augment.py:364-366
        angles = np.array(jax.random.uniform(k_angle, (4,),
                                               minval=-degree,
                                               maxval=degree))
        apply = np.array(jax.random.uniform(k_do, (4,)) < p)
        got = ta.rotate_clip(torch.from_numpy(x), degree, p,
                             angles=torch.from_numpy(angles),
                             apply=torch.from_numpy(apply)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)


def _covering(draw, cond):
    """The first of 50 keys whose draws satisfy ``cond``."""
    for seed in range(50):
        key = jax.random.key(seed)
        d = draw(key)
        if cond(d):
            return key, d
    raise AssertionError("no key takes every branch")


def _mixed(mask):
    return bool(mask.any()) and not bool(mask.all())


def test_two_clip_transform_matches_jax():
    b, h = 6, 24
    c1, c2 = _clips(b, 3, h, h, seed=6), _clips(b, 3, h, h, seed=7)

    def draw(key):  # augment.py:392-403
        k1, k2, kd1, kd2 = jax.random.split(key, 4)
        return ((_jax_draws(k1, b, h, h, False),
                 _jax_draws(k2, b, h, h, False)),
                tuple(torch.from_numpy(np.array(
                    jax.random.uniform(k, (b,)) < 0.5)) for k in (kd1, kd2)))

    key, (params, use_base) = _covering(
        draw, lambda d: all(_mixed(m) for m in d[1]))
    want = ja.two_clip_transform(jnp.asarray(c1), jnp.asarray(c2), key, S,
                                 p=0.5)
    got = ta.two_clip_transform(torch.from_numpy(c1), torch.from_numpy(c2),
                                S, p=0.5, params=params, use_base=use_base)
    for g, w in zip(got, want):
        assert g.shape == (b, 3, S, S, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_one_clip_transform_matches_jax():
    b, h = 6, 24
    c1, c2 = _clips(b, 3, h, h, seed=8), _clips(b, 3, h, h, seed=9)

    def draw(key):  # augment.py:412-421
        k_pick, k_order, k_aug = jax.random.split(key, 3)
        return (torch.from_numpy(np.array(
                    jax.random.uniform(k_pick, (b,)) < 0.5)),
                torch.from_numpy(np.array(
                    jax.random.uniform(k_order, (b,)) < 0.5)),
                _jax_draws(k_aug, b, h, h, False))

    key, (pick1, base_first, params) = _covering(
        draw, lambda d: _mixed(d[0]) and _mixed(d[1]))
    want = ja.one_clip_transform(jnp.asarray(c1), jnp.asarray(c2), key, S)
    got = ta.one_clip_transform(torch.from_numpy(c1), torch.from_numpy(c2),
                                S, pick1=pick1, base_first=base_first,
                                params=params)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_two_crops_transform_matches_jax():
    b, h = 4, 28
    x = _clips(b, 2, h, h, seed=10)
    key = jax.random.key(3)
    params = tuple(_jax_draws(k, b, h, h, False)  # augment.py:428
                   for k in jax.random.split(key))
    want = ja.two_crops_transform(jnp.asarray(x), key, S, dataset="kinetics")
    got = ta.two_crops_transform(torch.from_numpy(x), S, dataset="kinetics",
                                 params=params)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_transform_controller_matches_jax():
    """The pick JAX makes from its key (augment.py:438-443), injected,
    calls the same transform; drawn from a generator, the weights hold."""
    x = _clips(2, 2, 20, 20, seed=11)
    fns = [lambda c: ("null", ta.center_crop_normalize(c, S)),
           lambda c: ("pad", c.shape)]
    j_fns = [lambda c: ("null", ja.center_crop_normalize(c, S)),
             lambda c: ("pad", c.shape)]
    for seed in range(4):
        key = jax.random.key(seed)
        weights = [0.3, 0.7]
        j_name, j_out = ja.transform_controller(j_fns, weights, key,
                                                jnp.asarray(x))
        w = np.asarray(weights) / np.sum(weights)
        pick = int(np.random.default_rng(int(jax.random.randint(
            key, (), 0, 2 ** 31 - 1))).choice(2, p=w))
        t_name, t_out = ta.transform_controller(fns, weights,
                                                torch.from_numpy(x),
                                                choice=pick)
        assert t_name == j_name
        if t_name == "null":
            np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                                       atol=1e-6)
        else:
            assert tuple(t_out) == tuple(j_out)
    gen = torch.Generator().manual_seed(0)
    picks = [ta.transform_controller([lambda: 0, lambda: 1, lambda: 2],
                                     [0.2, 0.8, 0.0], generator=gen)
             for _ in range(400)]
    assert 2 not in picks and 0.7 < np.mean(picks) < 0.9


def test_transforms_draw_from_a_generator():
    """No draw injected: the same seed gives the same views, another seed
    other views; every view is finite and of the crop's shape."""
    x = torch.from_numpy(_clips(4, 2, 24, 24, seed=12))

    def views(seed):
        g = torch.Generator().manual_seed(seed)
        xf = x.float() / 255
        return (ta.two_clip_transform(x, x, S, generator=g)
                + ta.one_clip_transform(x, x, S, generator=g)
                + ta.two_crops_transform(x, S, generator=g)
                + (ta.rotate_clip(xf, generator=g),
                   ta.random_gray_clip(x, consistent=False, generator=g)))

    a, b, c = views(0), views(0), views(1)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not all(torch.equal(u, v) for u, v in zip(a, c))
    assert all(v.shape == (4, 2, S, S, 3) and bool(torch.isfinite(v).all())
               for v in a[:6])
    with pytest.raises(ValueError, match="Generator"):
        ta.rotate_clip(x.float())
