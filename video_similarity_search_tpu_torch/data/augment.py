"""Clip augmentation on the device (port of the JAX package's
``data/augment.py``).

The train chain — RandomResizedCrop, horizontal flip, ColorJitter (p=0.8,
the four ops in a random order), ColorDrop (grayscale, p=0.2), a 15x15
sigma-2 GaussianBlur (p=0.2), normalize — is split in two:
``draw_augment_params`` draws each clip's parameters from an explicit
``torch.Generator`` and ``apply_augment`` applies them to a uint8 batch,
so a test can hand both packages the same draws (``jax.random`` and torch
generators never give the same numbers, ROADMAP hazard H2). Every op keeps
the JAX semantics, not torchvision's: contrast blends with the mean gray of
the whole clip, the gray conversion is the float ``x @ [0.299, 0.587,
0.114]``, the blur pads with zeros, and the crop resamples as
``jax.image.scale_and_translate(method="bilinear")`` does, antialiased
(the triangle kernel widens when the crop is scaled down; hazard H5).

The eval path (``normalize_only``) only scales and normalizes: the host
already resized and center-cropped.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

# reference datasets/data_loader.py:53-66
MEAN_STD = {
    "kinetics": ((0.4345, 0.4051, 0.3775), (0.2768, 0.2713, 0.2737)),
    "imagenet": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
}
# reference datasets/data_loader.py:29-30
TRAIN_CROP_MIN_SCALE = 0.25
TRAIN_CROP_MIN_RATIO = 0.75
CROP_ATTEMPTS = 10
# ColorJitter(0.5, 0.5, 0.5, 0.5) p=0.8, ColorDrop p=0.2, blur p=0.2
JITTER_STRENGTH = 0.5
HUE_STRENGTH = 0.5
P_JITTER, P_GRAY, P_BLUR = 0.8, 0.2, 0.2
GRAY = (0.299, 0.587, 0.114)  # PIL 'L' weights
_F32_EPS = 1.1920928955078125e-07  # np.finfo(np.float32).eps


def normalization_constants(dataset: str, num_channels: int = 3,
                            device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean/std vectors; extension channels get mean 0 / std 1
    (reference get_normalize_method, datasets/data_loader.py:69-83)."""
    mean, std = MEAN_STD["kinetics" if dataset == "kinetics" else "imagenet"]
    extra = num_channels - 3
    mean = tuple(mean) + (0.0,) * extra
    std = tuple(std) + (1.0,) * extra
    return (torch.tensor(mean, dtype=torch.float32, device=device),
            torch.tensor(std, dtype=torch.float32, device=device))


def normalize_only(clips_u8: torch.Tensor,
                   dataset: str = "ucf101") -> torch.Tensor:
    """Eval path: uint8 (B,T,H,W,C) -> float32 scaled and normalized, on the
    clips' own device."""
    x = clips_u8.to(torch.float32) / 255.0
    mean, std = normalization_constants(dataset, clips_u8.shape[-1],
                                        device=clips_u8.device)
    return (x - mean) / std


# --------------------------------------------------------------------------
# parameter draws

def _uniform(generator: torch.Generator, shape, lo, hi) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return lo + (hi - lo) * u


def crop_from_draws(area_scale: torch.Tensor, log_ratio: torch.Tensor,
                    position: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """torchvision ``RandomResizedCrop.get_params`` as the JAX package's
    ``_sample_crop`` vectorizes it: ``area_scale`` and ``log_ratio`` (B, 10)
    are the ten attempts' draws, ``position`` (B, 2) the placement
    uniforms. The first attempt that fits wins; with none, the whole frame.
    -> (B, 4) float boxes (top, left, height, width)."""
    target_area = (h * w) * area_scale
    aspect = torch.exp(log_ratio)
    ws = torch.sqrt(target_area * aspect)
    hs = torch.sqrt(target_area / aspect)
    valid = (ws <= w) & (hs <= h)
    pick = torch.argmax(valid.to(torch.int8), dim=1, keepdim=True)  # first
    any_valid = valid.any(dim=1)
    cw = torch.where(any_valid, ws.gather(1, pick)[:, 0], float(w))
    ch = torch.where(any_valid, hs.gather(1, pick)[:, 0], float(h))
    top = position[:, 0] * (h - ch)
    left = position[:, 1] * (w - cw)
    return torch.stack([top, left, ch, cw], dim=1)


def draw_augment_params(generator: torch.Generator, b: int, *,
                        pre_cropped: bool = True,
                        in_hw: Tuple[int, int] = (0, 0)
                        ) -> Dict[str, torch.Tensor]:
    """Per-clip draws of the train chain, on ``generator``'s device:

    ``flip``, ``jitter``, ``gray``, ``blur`` (B,) bool coins; ``factors``
    (B, 4) the brightness, contrast, saturation and hue factors; ``perm``
    (B, 4) the jitter ops' order (0 brightness, 1 contrast, 2 saturation,
    3 hue); and, unless ``pre_cropped``, ``crop`` (B, 4) boxes in the
    ``in_hw`` frame."""
    g = generator
    s = JITTER_STRENGTH
    lo = max(0.0, 1.0 - s)
    out = {}
    if not pre_cropped:
        h, w = in_hw
        area = _uniform(g, (b, CROP_ATTEMPTS), TRAIN_CROP_MIN_SCALE, 1.0)
        ratio = _uniform(g, (b, CROP_ATTEMPTS),
                         math.log(TRAIN_CROP_MIN_RATIO),
                         math.log(1.0 / TRAIN_CROP_MIN_RATIO))
        out["crop"] = crop_from_draws(area, ratio, _uniform(g, (b, 2), 0, 1),
                                      h, w)
    out["flip"] = _uniform(g, (b,), 0.0, 1.0) < 0.5
    out["factors"] = torch.cat([
        _uniform(g, (b, 3), lo, 1.0 + s),
        _uniform(g, (b, 1), -HUE_STRENGTH, HUE_STRENGTH)], dim=1)
    out["perm"] = torch.argsort(_uniform(g, (b, 4), 0.0, 1.0), dim=1)
    out["jitter"] = _uniform(g, (b,), 0.0, 1.0) < P_JITTER
    out["gray"] = _uniform(g, (b,), 0.0, 1.0) < P_GRAY
    out["blur"] = _uniform(g, (b,), 0.0, 1.0) < P_BLUR
    return out


# --------------------------------------------------------------------------
# the ops, on float clips (B, T, H, W, C) with one parameter set per clip

def _per_clip(v: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1, 1, 1, 1) to broadcast over a clip."""
    return v.reshape(-1, 1, 1, 1, 1)


def _weight_mat(in_size: int, out_size: int, scale: torch.Tensor,
                translation: torch.Tensor) -> torch.Tensor:
    """(B, in, out) resampling weights of ``jax.image.scale_and_translate``
    with the triangle kernel and antialiasing (jax/_src/image/scale.py,
    ``compute_weight_mat``), one matrix per clip, in the same float32
    arithmetic."""
    dev = scale.device
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp_min(inv_scale, 1.0)
    out_pos = torch.arange(out_size, dtype=torch.float32, device=dev)
    sample_f = ((out_pos[None, :] + 0.5) * inv_scale[:, None]
                - translation[:, None] * inv_scale[:, None] - 0.5)
    in_pos = torch.arange(in_size, dtype=torch.float32, device=dev)
    x = (torch.abs(sample_f[:, None, :] - in_pos[None, :, None])
         / kernel_scale[:, None, None])
    weights = torch.clamp_min(1.0 - torch.abs(x), 0.0)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * _F32_EPS,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, torch.zeros_like(weights))


def resized_crop(frames: torch.Tensor, boxes: torch.Tensor,
                 out_size: int) -> torch.Tensor:
    """(B, T, H, W, C) float -> (B, T, S, S, C): each clip's box (top,
    left, height, width) cropped and resized bilinearly in one pass, as the
    JAX package's ``_resized_crop`` does with ``scale_and_translate``."""
    _, _, h, w, _ = frames.shape
    top, left, ch, cw = boxes.unbind(1)
    scale_y = out_size / ch
    scale_x = out_size / cw
    wy = _weight_mat(h, out_size, scale_y, -top * scale_y)  # (B, H, S)
    wx = _weight_mat(w, out_size, scale_x, -left * scale_x)  # (B, W, S)
    rows = torch.einsum("bthwc,bhy->btywc", frames, wy)
    return torch.einsum("btywc,bwx->btyxc", rows, wx)


def _gray(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (...): x @ [0.299, 0.587, 0.114], unrounded."""
    return x[..., 0] * GRAY[0] + x[..., 1] * GRAY[1] + x[..., 2] * GRAY[2]


def rgb_to_hsv(rgb: torch.Tensor):
    r, g, b = rgb.unbind(-1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, delta / torch.clamp_min(maxc, 1e-8), zero)
    safe = torch.clamp_min(delta, 1e-8)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(delta == 0, zero, h)
    return h, s, v


def hsv_to_rgb(h: torch.Tensor, s: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)
    conds = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    out = []
    for ch in range(3):
        c = torch.zeros_like(v)
        for k in range(5, -1, -1):  # jnp.select: the first match wins
            c = torch.where(i == k, conds[k][ch], c)
        out.append(c)
    return torch.stack(out, dim=-1)


def _brightness(x, f):
    return torch.clamp(x * f, 0.0, 1.0)


def _contrast(x, f):
    # blend with the mean gray of the whole clip
    mean = _gray(x).mean(dim=(1, 2, 3)).reshape(-1, 1, 1, 1, 1)
    return torch.clamp(mean + f * (x - mean), 0.0, 1.0)


def _saturation(x, f):
    gray = _gray(x)[..., None]
    return torch.clamp(gray + f * (x - gray), 0.0, 1.0)


def _hue(x, f):
    h, s, v = rgb_to_hsv(x)
    h = torch.remainder(h + f[..., 0], 1.0)
    return torch.clamp(hsv_to_rgb(h, s, v), 0.0, 1.0)


_JITTER_OPS = (_brightness, _contrast, _saturation, _hue)


def jitter_clips(rgb: torch.Tensor, perm: torch.Tensor,
                 factors: torch.Tensor) -> torch.Tensor:
    """The four jitter ops in each clip's ``perm`` order. Every op is
    computed for the whole batch at each of the four steps and each clip
    keeps the one its order names there, so no draw is read on the host."""
    fs = [_per_clip(factors[:, k]) for k in range(4)]
    for step in range(4):
        out = rgb
        for k, op in enumerate(_JITTER_OPS):
            out = torch.where(_per_clip(perm[:, step] == k), op(rgb, fs[k]),
                              out)
        rgb = out
    return rgb


def gaussian_kernel(size: int = 15, sigma: float = 2.0,
                    device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    k = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return k / k.sum()


def blur_clips(frames: torch.Tensor, size: int = 15,
               sigma: float = 2.0) -> torch.Tensor:
    """Separable 15x15 sigma-2 blur of every frame and channel with zero
    padding (the JAX package's ``_blur_clip``; the reference calls
    cv2.GaussianBlur((15, 15), 2), spatial_transforms.py:311-325)."""
    b, t, h, w, c = frames.shape
    k = gaussian_kernel(size, sigma, frames.device)
    pad = size // 2
    x = frames.permute(0, 1, 4, 2, 3).reshape(b * t * c, 1, h, w)
    x = F.conv2d(x, k.reshape(1, 1, size, 1), padding=(pad, 0))
    x = F.conv2d(x, k.reshape(1, 1, 1, size), padding=(0, pad))
    return x.reshape(b, t, c, h, w).permute(0, 1, 3, 4, 2)


def apply_augment(clips_u8: torch.Tensor, params: Dict[str, torch.Tensor],
                  out_size: int, dataset: str = "ucf101",
                  pre_cropped: bool = True) -> torch.Tensor:
    """(B, T, H, W, C) uint8 -> (B, T, S, S, C) normalized float32 with the
    drawn ``params`` (``draw_augment_params``); ``pre_cropped``
    (TPU.HOST_RRC): the host already cropped and resized to S x S."""
    x = clips_u8.to(torch.float32) / 255.0
    if not pre_cropped:
        x = resized_crop(x, params["crop"], out_size)
    x = torch.where(_per_clip(params["flip"]), x.flip(3), x)
    rgb, ext = x[..., :3], x[..., 3:]
    jittered = jitter_clips(rgb, params["perm"], params["factors"])
    rgb = torch.where(_per_clip(params["jitter"]), jittered, rgb)
    gray3 = _gray(rgb)[..., None].expand_as(rgb)
    rgb = torch.where(_per_clip(params["gray"]), gray3, rgb)
    x = torch.cat([rgb, ext], dim=-1) if ext.shape[-1] else rgb
    x = torch.where(_per_clip(params["blur"]), blur_clips(x), x)
    mean, std = normalization_constants(dataset, x.shape[-1], device=x.device)
    return (x - mean) / std


def train_augment(clips_u8: torch.Tensor, generator: torch.Generator,
                  out_size: int, dataset: str = "ucf101",
                  pre_cropped: bool = False) -> torch.Tensor:
    """Draw and apply: the train chain of the reference's spatial
    transforms (datasets/data_loader.py:96-108) on a uint8 batch that lies
    on ``generator``'s device."""
    params = draw_augment_params(generator, clips_u8.shape[0],
                                 pre_cropped=pre_cropped,
                                 in_hw=tuple(clips_u8.shape[2:4]))
    return apply_augment(clips_u8, params, out_size, dataset=dataset,
                         pre_cropped=pre_cropped)
