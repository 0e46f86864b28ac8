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

CoCLR's clip transforms (``pad_clip``, ``scale_clip``,
``random_gray_clip``, ``center_crop_normalize``, ``rotate_clip`` and the
``two_clip`` / ``one_clip`` / ``two_crops`` controllers with
``transform_controller``) take their draws as arguments, or draw them
from a ``torch.Generator``, in the JAX semantics: ``scale_clip`` resizes
with Keys' cubic weight matrices, antialiased, and ``rotate_clip``
samples as ``map_coordinates(order=1, mode="nearest")``.
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


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(1.0 - torch.abs(x), 0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel with a = -0.5 on |x|, as jax.image's "cubic"
    (``_fill_keys_cubic_kernel``); torch's bicubic uses a = -0.75."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _weight_mat(in_size: int, out_size: int, scale: torch.Tensor,
                translation: torch.Tensor, kernel=_triangle,
                inv_scale: torch.Tensor = None) -> torch.Tensor:
    """(B, in, out) resampling weights of ``jax.image.scale_and_translate``
    with ``kernel`` (the triangle by default) and antialiasing
    (jax/_src/image/scale.py, ``compute_weight_mat``), one matrix per clip,
    in the same float32 arithmetic. ``inv_scale``: 1 / scale when the
    caller has it more exactly than float32 division gives it."""
    dev = scale.device
    if inv_scale is None:
        inv_scale = 1.0 / scale
    kernel_scale = torch.clamp_min(inv_scale, 1.0)
    out_pos = torch.arange(out_size, dtype=torch.float32, device=dev)
    sample_f = ((out_pos[None, :] + 0.5) * inv_scale[:, None]
                - translation[:, None] * inv_scale[:, None] - 0.5)
    in_pos = torch.arange(in_size, dtype=torch.float32, device=dev)
    x = (torch.abs(sample_f[:, None, :] - in_pos[None, :, None])
         / kernel_scale[:, None, None])
    weights = kernel(x)
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
                  pre_cropped: bool = False,
                  shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Draw and apply: the train chain of the reference's spatial
    transforms (datasets/data_loader.py:96-108) on a uint8 batch that lies
    on ``generator``'s device. ``shard`` (rank, world): the batch is rank's
    rows of a global batch of world x B clips; the parameters are drawn
    for the global batch and rank's rows applied, so W ranks augment as
    one process fed the global batch does."""
    rank, world = shard
    b = clips_u8.shape[0]
    params = draw_augment_params(generator, b * world,
                                 pre_cropped=pre_cropped,
                                 in_hw=tuple(clips_u8.shape[2:4]))
    if world > 1:
        params = {k: v[rank * b:(rank + 1) * b] for k, v in params.items()}
    return apply_augment(clips_u8, params, out_size, dataset=dataset,
                         pre_cropped=pre_cropped)


# --------------------------------------------------------------------------
# CoCLR clip transforms (the JAX package's data/augment.py:258-443;
# reference coclr_utils/augmentation.py). Every draw can be injected; one
# that is not comes from ``generator``, on its device.

def _draw(generator: torch.Generator, shape) -> torch.Tensor:
    if generator is None:
        raise ValueError("pass the draws or a torch.Generator to draw them")
    return torch.rand(shape, generator=generator, device=generator.device)


def pad_clip(clips: torch.Tensor, pad: int) -> torch.Tensor:
    """Padding (reference augmentation.py:16-21, ImageOps.expand border
    fill 0): zero-pad the spatial dims of (B, T, H, W, C) clips."""
    return F.pad(clips, (0, 0, pad, pad, pad, pad))


def scale_clip(clips: torch.Tensor, size, method: str = "cubic"
               ) -> torch.Tensor:
    """Scale (reference augmentation.py:24-45): short-edge resize when
    ``size`` is an int (no-op if the short edge already matches), exact
    (h, w) otherwise. ``jax.image.resize(method="cubic")``: Keys' cubic
    (a = -0.5), antialiased when it shrinks, each dim whose size changes
    resampled by its weight matrix (hazard H5); "linear" takes the
    triangle. Integer clips are rounded half to even and clipped to
    0..255, as the JAX function does."""
    b, t, h, w, c = clips.shape
    if isinstance(size, int):
        if (w <= h and w == size) or (h <= w and h == size):
            return clips
        if w < h:
            ow, oh = size, int(size * h / w)
        else:
            oh, ow = size, int(size * w / h)
    else:
        oh, ow = size
    kernel = {"cubic": _keys_cubic, "linear": _triangle}[method]
    dev = clips.device
    x = clips.to(torch.float32)
    zero = torch.zeros(1, device=dev)

    def weights(n_in, n_out):  # scale n_out / n_in, as jax.image.resize
        scale = n_out / n_in
        return _weight_mat(n_in, n_out,
                           torch.tensor([scale], device=dev), zero, kernel,
                           torch.tensor([1.0 / scale], device=dev))[0]

    if oh != h:
        x = torch.einsum("bthwc,hy->btywc", x, weights(h, oh))
    if ow != w:
        x = torch.einsum("btywc,wx->btyxc", x, weights(w, ow))
    if not clips.is_floating_point():
        x = torch.clamp(torch.round(x), 0, 255)
    return x.to(clips.dtype)


def random_gray_clip(clips: torch.Tensor, p: float = 0.5,
                     consistent: bool = True, seq_len: int = 0, *,
                     apply: torch.Tensor = None, channel: torch.Tensor = None,
                     generator: torch.Generator = None) -> torch.Tensor:
    """RandomGray (reference augmentation.py:182-219): channel SPLITTING,
    one chosen channel copied to all three, with probability ``p`` per
    clip (``consistent``), per frame, or per ``seq_len`` block of frames.
    ``apply`` (bool) and ``channel`` (0..2) hold one draw per clip (B,),
    per frame (B * T,) or per block (B * ceil(T / seq_len),)."""
    b, t = clips.shape[0], clips.shape[1]
    if consistent and seq_len == 0:
        n = b
    elif seq_len == 0:
        n = b * t
    else:
        n = b * -(-t // seq_len)
    if apply is None:
        apply = _draw(generator, (n,)) < p
    if channel is None:
        channel = torch.floor(_draw(generator, (n,)) * 3).long().clamp_max(2)
    apply, channel = apply.to(clips.device), channel.to(clips.device).long()
    if seq_len:  # one draw per block, over the block's frames
        blocks = -(-t // seq_len)
        apply = apply.reshape(b, blocks).repeat_interleave(seq_len, 1)[:, :t]
        channel = channel.reshape(b, blocks).repeat_interleave(seq_len,
                                                               1)[:, :t]
    if consistent and seq_len == 0:
        shape = (b, 1, 1, 1, 1)
    else:
        shape = (b, t, 1, 1, 1)
    idx = channel.reshape(shape).expand(*clips.shape[:4], 1)
    gray = torch.gather(clips, -1, idx).expand_as(clips)
    return torch.where(apply.reshape(shape), gray, clips)


def center_crop_normalize(clips_u8: torch.Tensor, out_size: int,
                          dataset: str = "ucf101") -> torch.Tensor:
    """The CoCLR 'null' transform: center crop, scale and normalize
    (reference augmentation.py, the null transform of TwoClipTransform)."""
    h, w = clips_u8.shape[2], clips_u8.shape[3]
    top, left = (h - out_size) // 2, (w - out_size) // 2
    return normalize_only(
        clips_u8[:, :, top:top + out_size, left:left + out_size, :],
        dataset=dataset)


def rotate_clip(clips: torch.Tensor, degree: float = 15.0, p: float = 1.0,
                *, angles: torch.Tensor = None, apply: torch.Tensor = None,
                generator: torch.Generator = None) -> torch.Tensor:
    """RandomRotation (reference coclr_utils/augmentation.py:334-347) as
    the JAX package does it: each clip turned by its angle (degrees,
    (B,) in [-degree, degree], where ``apply``) about the frame's centre
    on the fixed canvas, every frame and channel sampled bilinearly at the
    source coordinates with the edge repeated (``map_coordinates(order=1,
    mode="nearest")``, the four corners summed in its order). Float clips
    (B, T, H, W, C) in [0, 1]."""
    b, t, h, w, c = clips.shape
    dev = clips.device
    if angles is None:
        angles = -degree + 2 * degree * _draw(generator, (b,))
    if apply is None:
        apply = _draw(generator, (b,)) < p
    angles, apply = angles.to(dev, torch.float32), apply.to(dev)
    theta = torch.where(apply, torch.deg2rad(angles), torch.zeros_like(angles))
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    cos = torch.cos(theta).reshape(b, 1, 1)
    sin = torch.sin(theta).reshape(b, 1, 1)
    src_y = cy + (yy - cy) * cos - (xx - cx) * sin  # (B, H, W)
    src_x = cx + (yy - cy) * sin + (xx - cx) * cos

    def nodes(coord, size):
        lower = torch.floor(coord)
        upper_w = coord - lower
        index = lower.to(torch.int64)
        return [(index.clamp(0, size - 1), 1 - upper_w),
                ((index + 1).clamp(0, size - 1), upper_w)]

    flat = clips.reshape(b, t, h * w, c)
    out = None
    for iy, wy in nodes(src_y, h):
        for ix, wx in nodes(src_x, w):
            pix = (iy * w + ix).reshape(b, 1, h * w, 1).expand(b, t, h * w, c)
            term = ((wy * wx).reshape(b, 1, h, w, 1)
                    * torch.gather(flat, 2, pix).reshape(b, t, h, w, c))
            out = term if out is None else out + term
    return out


def _use(draw: torch.Tensor, clips: torch.Tensor) -> torch.Tensor:
    return _per_clip(draw.to(clips.device))


def _augment_params(clips_u8, generator):
    return draw_augment_params(generator, clips_u8.shape[0],
                               pre_cropped=False,
                               in_hw=tuple(clips_u8.shape[2:4]))


def two_clip_transform(clip1_u8: torch.Tensor, clip2_u8: torch.Tensor,
                       out_size: int, dataset: str = "ucf101",
                       p: float = 0.3, *, params=None, use_base=None,
                       generator: torch.Generator = None):
    """TwoClipTransform (reference augmentation.py:383-408): each clip
    independently gets the base augmentation (``train_augment``'s chain,
    with its crop) with probability ``p``, else the null (center crop and
    normalize). ``params``: the two clips' ``draw_augment_params``;
    ``use_base``: two (B,) bool masks."""
    if params is None:
        params = tuple(_augment_params(c, generator)
                       for c in (clip1_u8, clip2_u8))
    if use_base is None:
        use_base = tuple(_draw(generator, (clip1_u8.shape[0],)) < p
                         for _ in range(2))

    def mix(clips, prm, base):
        aug = apply_augment(clips, prm, out_size, dataset=dataset,
                            pre_cropped=False)
        null = center_crop_normalize(clips, out_size, dataset=dataset)
        return torch.where(_use(base, clips), aug, null)

    return (mix(clip1_u8, params[0], use_base[0]),
            mix(clip2_u8, params[1], use_base[1]))


def one_clip_transform(clip1_u8: torch.Tensor, clip2_u8: torch.Tensor,
                       out_size: int, dataset: str = "ucf101", *,
                       pick1=None, base_first=None, params=None,
                       generator: torch.Generator = None):
    """OneClipTransform (reference augmentation.py:411-435): keep ONE of
    the two clips (``pick1``: clip 1 where true) and return (base(x),
    null(x)) in a random order (``base_first``), per clip; ``params`` the
    base augmentation's draws."""
    b = clip1_u8.shape[0]
    if pick1 is None:
        pick1 = _draw(generator, (b,)) < 0.5
    if base_first is None:
        base_first = _draw(generator, (b,)) < 0.5
    x = torch.where(_use(pick1, clip1_u8), clip1_u8, clip2_u8)
    if params is None:
        params = _augment_params(x, generator)
    aug = apply_augment(x, params, out_size, dataset=dataset,
                        pre_cropped=False)
    null = center_crop_normalize(x, out_size, dataset=dataset)
    first = _use(base_first, x)
    return torch.where(first, aug, null), torch.where(first, null, aug)


def two_crops_transform(clips_u8: torch.Tensor, out_size: int,
                        dataset: str = "ucf101", *, params=None,
                        generator: torch.Generator = None):
    """TwoCropsTransform (reference augmentation.py:452-461): two
    independent base augmentations of the same clips (query and key);
    ``params`` their two draws."""
    if params is None:
        params = tuple(_augment_params(clips_u8, generator) for _ in range(2))
    return tuple(apply_augment(clips_u8, prm, out_size, dataset=dataset,
                               pre_cropped=False) for prm in params)


def transform_controller(fns, weights, *args, choice: int = None,
                         generator: torch.Generator = None, **kwargs):
    """TransformController (reference augmentation.py:438-450): call one of
    ``fns`` with the arguments, picked with probability proportional to
    ``weights`` (``choice`` injects the pick; else one draw from
    ``generator``, read on the host, since the pick chooses the code to
    run)."""
    if choice is None:
        w = torch.as_tensor(weights, dtype=torch.float64)
        u = float(_draw(generator, (1,)).item())
        cdf = torch.cumsum(w / w.sum(), 0)
        choice = min(int(torch.searchsorted(cdf, u, right=True)),
                     len(fns) - 1)
    return fns[choice](*args, **kwargs)
