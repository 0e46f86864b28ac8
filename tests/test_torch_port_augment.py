"""The port's device augmentation against the JAX package's, on the CPU.

Each op meets its JAX private counterpart on the same inputs and
parameters: the jitter for every order of its four ops, RGB <-> HSV on
gray and saturated pixels, the 15x15 blur, and the resized crop on up- and
down-scaling boxes (the antialiased triangle kernel). The whole
``train_augment`` chain, pre-cropped and not, is held to JAX's from the
draws JAX makes: the test repeats ``_augment_one``'s key splits and feeds
the resulting parameters to the port's ``apply_augment``. Tolerances: 1e-5
absolute (normalized values), 1e-4 for chains with the crop.
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_similarity_search_tpu.data import augment as ja
from video_similarity_search_tpu_torch.data import augment as ta

S = 16  # output clip size
SCALE = (ja.TRAIN_CROP_MIN_SCALE, 1.0)
RATIO = (ja.TRAIN_CROP_MIN_RATIO, 1.0 / ja.TRAIN_CROP_MIN_RATIO)


def _clips(b=3, t=3, h=S, w=S, c=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, t, h, w, c),
                                                np.uint8)


def _special_pixels():
    """Gray, black, white, saturated and near-tie pixels: the edge cases
    of the HSV conversion (delta == 0, r == maxc, g == maxc)."""
    px = [[0, 0, 0], [1, 1, 1], [.5, .5, .5], [1, 0, 0], [0, 1, 0],
          [0, 0, 1], [1, 1, 0], [0, 1, 1], [1, 0, 1], [.3, .3, .1],
          [.2, .6, .6], [.7, .2, .7], [.4, .4, .4000001]]
    rng = np.random.default_rng(1)
    return np.concatenate([np.array(px, np.float32),
                           rng.random((200, 3), np.float32)])


def test_rgb_hsv_round_trip_matches_jax():
    rgb = _special_pixels()
    jh, js, jv = ja._rgb_to_hsv(jnp.asarray(rgb))
    th, ts, tv = ta.rgb_to_hsv(torch.from_numpy(rgb))
    for j, t in ((jh, th), (js, ts), (jv, tv)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)
    hues = np.concatenate([np.asarray(jh), [0.0, 1 / 6, 0.5, 0.999999]])
    s = np.concatenate([np.asarray(js), [1.0, 0.0, 0.5, 1.0]])
    v = np.concatenate([np.asarray(jv), [1.0, 0.3, 0.0, 0.8]])
    back_j = ja._hsv_to_rgb(*(jnp.asarray(a, jnp.float32) for a in (hues, s, v)))
    back_t = ta.hsv_to_rgb(*(torch.tensor(a, dtype=torch.float32)
                             for a in (hues, s, v)))
    np.testing.assert_allclose(back_t.numpy(), np.asarray(back_j), atol=1e-6)
    np.testing.assert_allclose(back_t.numpy()[:len(rgb)], rgb, atol=1e-5)


@pytest.mark.parametrize("perm", list(itertools.permutations(range(4))))
def test_jitter_every_order_matches_jax(perm):
    x = (_clips(1, t=2, h=8, w=8, seed=sum(perm)) / 255.0).astype(np.float32)
    factors = (1.3, 0.6, 1.4, -0.27)
    want = ja._jitter_clip(jnp.asarray(x[0]), jnp.asarray(perm),
                           tuple(jnp.float32(f) for f in factors))
    got = ta.jitter_clips(torch.from_numpy(x), torch.tensor([perm]),
                          torch.tensor([factors], dtype=torch.float32))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=1e-5)


def test_jitter_per_clip_orders_and_factors():
    """A batch whose clips have different orders and factors equals the
    clip-by-clip JAX jitter."""
    x = (_clips(4, t=2, h=8, w=8, seed=5) / 255.0).astype(np.float32)
    perms = np.array([[0, 1, 2, 3], [3, 2, 1, 0], [1, 3, 0, 2], [2, 0, 3, 1]])
    fac = np.array([[1.2, .7, 1.1, .1], [.5, 1.5, .6, -.4], [1, 1, 1, 0],
                    [.9, 1.3, 1.4, .45]], np.float32)
    got = ta.jitter_clips(torch.from_numpy(x), torch.from_numpy(perms),
                          torch.from_numpy(fac)).numpy()
    for i in range(4):
        want = ja._jitter_clip(jnp.asarray(x[i]), jnp.asarray(perms[i]),
                               tuple(jnp.float32(f) for f in fac[i]))
        np.testing.assert_allclose(got[i], np.asarray(want), atol=1e-5)


def test_blur_matches_jax():
    x = (_clips(2, t=2, h=20, w=24, c=4) / 255.0).astype(np.float32)
    want = np.stack([np.asarray(ja._blur_clip(jnp.asarray(c))) for c in x])
    got = ta.blur_clips(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(ta.gaussian_kernel().numpy(),
                               np.asarray(ja._gaussian_kernel()), atol=1e-7)


@pytest.mark.parametrize("box", [
    (0.0, 0.0, 24.0, 24.0),      # the whole frame, downscaled 1.5x
    (3.7, 5.2, 9.3, 12.6),       # upscaled
    (1.25, 0.5, 20.5, 15.75),    # downscaled rows, nearly 1:1 columns
    (10.0, 2.0, 14.0, 6.0),      # upscaled columns, at the bottom edge
])
def test_resized_crop_matches_scale_and_translate(box):
    x = (_clips(1, t=2, h=24, w=24, seed=3) / 255.0).astype(np.float32)
    want = ja._resized_crop(jnp.asarray(x[0]), *(jnp.float32(v) for v in box),
                            S)
    got = ta.resized_crop(torch.from_numpy(x),
                          torch.tensor([box], dtype=torch.float32), S)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=1e-5)


def test_crop_sampling_matches_jax():
    h, w = 30, 40
    for seed in range(6):
        k1, k2, k3 = jax.random.split(jax.random.key(seed), 3)
        area = jax.random.uniform(k1, (10,), minval=SCALE[0], maxval=SCALE[1])
        ratio = jax.random.uniform(k2, (10,), minval=jnp.log(RATIO[0]),
                                   maxval=jnp.log(RATIO[1]))
        pos = jax.random.uniform(k3, (2,))
        if seed == 5:  # no attempt fits: the whole frame
            area = jnp.full((10,), 1.0)
            ratio = jnp.full((10,), 0.25)
        want = np.array(ja._sample_crop(jax.random.key(seed), h, w, SCALE,
                                        RATIO)) if seed < 5 else None
        got = ta.crop_from_draws(*(torch.from_numpy(np.array(a))[None]
                                   for a in (area, ratio, pos)), h, w)[0]
        if want is not None:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        else:
            assert got[2:].tolist() == [h, w]


def _jax_draws(key, b, h, w, pre_cropped):
    """The draws of the JAX ``train_augment(clips, key, ...)``, by
    ``_augment_one``'s key splits (augment.py:184, :215)."""
    out = {k: [] for k in ("flip", "factors", "perm", "jitter", "gray",
                           "blur", "crop")}
    s = 0.5
    for k in jax.random.split(key, b):
        keys = jax.random.split(k, 8)
        if not pre_cropped:
            out["crop"].append(np.array(ja._sample_crop(keys[0], h, w, SCALE,
                                                        RATIO)))
        out["flip"].append(bool(jax.random.bernoulli(keys[1])))
        out["factors"].append([
            float(jax.random.uniform(keys[i], (), minval=max(0.0, 1 - s),
                                     maxval=1 + s)) for i in (2, 3, 4)]
            + [float(jax.random.uniform(keys[5], (), minval=-0.5,
                                        maxval=0.5))])
        out["perm"].append(np.asarray(jax.random.permutation(keys[6], 4)))
        out["jitter"].append(bool(jax.random.uniform(keys[7]) < 0.8))
        k_gray, k_blur = jax.random.split(jax.random.fold_in(k, 101))
        out["gray"].append(bool(jax.random.uniform(k_gray) < 0.2))
        out["blur"].append(bool(jax.random.uniform(k_blur) < 0.2))
    params = {k: torch.tensor(np.array(v)) for k, v in out.items() if v}
    params["factors"] = params["factors"].float()
    if "crop" in params:
        params["crop"] = params["crop"].float()
    return params


def _covering_key(b, h, w, pre_cropped):
    """The first key whose draws take every branch of the chain."""
    for seed in range(100):
        key = jax.random.key(seed)
        p = _jax_draws(key, b, h, w, pre_cropped)
        if all(p[k].any() and not p[k].all()
               for k in ("flip", "jitter", "gray", "blur")):
            return key, p
    raise AssertionError("no covering key")


@pytest.mark.parametrize("pre_cropped,hw,dataset,c,tol", [
    (True, S, "ucf101", 3, 1e-5),
    (True, S, "kinetics", 4, 1e-5),  # an extension channel (mean 0, std 1)
    (False, 28, "ucf101", 3, 1e-4),
])
def test_train_augment_matches_jax_from_jax_draws(pre_cropped, hw, dataset,
                                                  c, tol):
    b = 8
    clips = _clips(b, t=3, h=hw, w=hw, c=c, seed=hw)
    key, params = _covering_key(b, hw, hw, pre_cropped)
    want = ja.train_augment(jnp.asarray(clips), key, S, dataset=dataset,
                            pre_cropped=pre_cropped)
    got = ta.apply_augment(torch.from_numpy(clips), params, S,
                           dataset=dataset, pre_cropped=pre_cropped)
    assert got.shape == (b, 3, S, S, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol)


def test_draws_are_well_formed_and_seeded():
    g = torch.Generator().manual_seed(3)
    p = ta.draw_augment_params(g, 64, pre_cropped=False, in_hw=(30, 40))
    assert sorted(p) == ["blur", "crop", "factors", "flip", "gray", "jitter",
                         "perm"]
    assert (p["perm"].sort(1).values == torch.arange(4)).all()
    f = p["factors"]
    assert ((f[:, :3] >= 0.5) & (f[:, :3] < 1.5)).all()
    assert ((f[:, 3] >= -0.5) & (f[:, 3] < 0.5)).all()
    top, left, ch, cw = p["crop"].unbind(1)
    assert ((top >= 0) & (left >= 0) & (top + ch <= 30 + 1e-4)
            & (left + cw <= 40 + 1e-4)).all()
    assert (ch * cw >= 0.25 * 30 * 40 * (1 - 1e-5)).all()
    again = ta.draw_augment_params(torch.Generator().manual_seed(3), 64,
                                   pre_cropped=False, in_hw=(30, 40))
    assert all(torch.equal(p[k], again[k]) for k in p)
    out = ta.train_augment(torch.from_numpy(_clips(4, h=30, w=40)),
                           torch.Generator().manual_seed(0), S)
    assert out.shape == (4, 3, S, S, 3) and bool(torch.isfinite(out).all())
