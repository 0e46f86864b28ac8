"""Host-side dataset objects: triplet sampling and single-video eval items
(port of the JAX package's ``data/datasets.py``).

These produce fixed-shape uint8 clip arrays (T, H, W, C); the photometric
and geometric augmentation runs later on the device. What stays on the
host is what must: file IO, frame decoding, index-domain sampling, and
data-dependent view choices (channel replacement needs to choose which
files to read).

Reference parity:
  * TripletsData (datasets/triplets_dataset.py:29-208): positive = same
    video w.p. POSITIVE_SAMPLING_P else another video with the same
    label/cluster-label; third clip for relative-speed (2x positive) /
    local-local (second anchor) / intra-negative (block-shuffled anchor);
    explicit negative clip when ``negative_sampling`` (val); temporal-ds
    prediction targets.
  * construct_net_input (datasets/dataset_utils.py:22-114): channel
    extension concat, or full positive replacement by a 3x-replicated
    mask/flow view w.p. PROB_POS_CHANNEL_REPLACE (salient views rejected
    when mean < 0.01).
  * VideoDataset (datasets/video_dataset.py:14-121): one clip per video;
    'test' split expands every non-overlapping window.

Differences from the JAX package:
  * no OpenCV: frames are resized by :func:`resize_linear`, cv2's
    ``INTER_LINEAR`` fixed-point arithmetic written in torch integer ops
    (half-pixel centres, no antialias); it is within one gray level of
    ``cv2.resize`` and nearly always equal;
  * the RGB decode backend (``native`` C++ or ``pil``) is chosen once,
    when the ``ClipReader`` is built, and a native decode error raises
    instead of retrying the clip through PIL. The one per-clip PIL path
    the JAX package also needs is kept: a clip whose leading frame is
    missing (the native decoder has no earlier frame to repeat).
    ``ClipReader.decoded`` counts the clips each path decoded.
"""

from __future__ import annotations

import collections
import math
import os
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import native_loader
from .loaders import ImageLoaderPIL, VideoLoader
from .manifests import default_image_name_formatter
from .temporal import Shuffle, get_test_video_frame_indices, \
    temporal_ds_frame_indices

SALIENT_MASK_THRESHOLD = 0.01  # reference dataset_utils.py:38


def _hwc(f: np.ndarray) -> np.ndarray:
    return f[..., None] if f.ndim == 2 else f


def _taps(n_in: int, n_out: int):
    """cv2 ``INTER_LINEAR`` taps along one axis: half-pixel source
    coordinate ``(dst + 0.5) * n_in / n_out - 0.5``, clamped at both edges,
    weights in 11-bit fixed point (cv2's ``INTER_RESIZE_COEF_BITS``)."""
    f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(f).astype(np.int64)
    f = f - i0
    lo, hi = i0 < 0, i0 >= n_in - 1
    f[lo | hi] = 0.0
    i0 = np.clip(i0, 0, n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    w1 = np.rint(f * 2048).astype(np.int32)
    w0 = np.rint((1.0 - f) * 2048).astype(np.int32)
    return (torch.from_numpy(i0), torch.from_numpy(i1),
            torch.from_numpy(w0), torch.from_numpy(w1))


def resize_linear(frames: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(T, H, W, C) uint8 -> (T, out_h, out_w, C) uint8 by cv2
    ``INTER_LINEAR``'s own arithmetic, in torch integer ops: half-pixel
    taps with 11-bit weights (:func:`_taps`), a horizontal pass in int32,
    then cv2's vectorized vertical pass, ``((((r0 >> 4) * b0) >> 16) +
    (((r1 >> 4) * b1) >> 16) + 2) >> 2``. No antialias on downscale, as in
    cv2. The result equals ``cv2.resize`` but for a rare 1 where cv2 takes
    its scalar path on a row's last few bytes."""
    t, h, w, c = frames.shape
    x0, x1, a0, a1 = _taps(w, out_w)
    y0, y1, b0, b1 = _taps(h, out_h)
    flat = np.ascontiguousarray(frames).reshape(t * h, w * c)
    chan = np.arange(c)

    def tap(i: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        # gather whole pixels of each row (np.take on the flattened row
        # is several times faster than a strided torch.index_select)
        cols = (i.numpy()[:, None] * c + chan).ravel()
        g = torch.from_numpy(np.take(flat, cols, axis=1)).to(torch.int32)
        return g.mul_(a.repeat_interleave(c))

    rows = tap(x0, a0).add_(tap(x1, a1)).bitwise_right_shift_(4)
    rows = rows.view(t, h, out_w * c)
    out = rows.index_select(1, y0).mul_(b0[:, None]).bitwise_right_shift_(16)
    out.add_(rows.index_select(1, y1).mul_(b1[:, None])
             .bitwise_right_shift_(16))
    out.add_(2).bitwise_right_shift_(2)
    return out.clamp_(0, 255).to(torch.uint8).view(
        t, out_h, out_w, c).numpy()


def _map_frames(frames: List[np.ndarray], fn) -> np.ndarray:
    """Apply ``fn`` ((n, H, W, C) -> (n, h, w, C)) to runs of frames of one
    shape at once (one call per clip when every frame has the same size)."""
    frames = [_hwc(f) for f in frames]
    out, start = [], 0
    for i in range(1, len(frames) + 1):
        if i == len(frames) or frames[i].shape != frames[start].shape:
            out.append(fn(np.stack(frames[start:i], 0)))
            start = i
    return np.concatenate(out, 0)


def _resize_frames(frames: List[np.ndarray], size: Tuple[int, int],
                   keep_aspect_short_edge: Optional[int] = None
                   ) -> np.ndarray:
    """Resize decoded frames to a fixed buffer; (T, H, W, C) uint8."""
    th, tw = size

    def fn(stack: np.ndarray) -> np.ndarray:
        if keep_aspect_short_edge is None:
            return resize_linear(stack, th, tw)
        h, w = stack.shape[1:3]
        s = keep_aspect_short_edge / min(h, w)
        nh, nw = int(round(h * s)), int(round(w * s))
        r = resize_linear(stack, nh, nw)
        # center crop to (size)
        top = max(0, (nh - th) // 2)
        left = max(0, (nw - tw) // 2)
        return r[:, top:top + th, left:left + tw]

    return _map_frames(frames, fn)


class ClipReader:
    """Decode + buffer-resize one clip, with channel extension logic.

    ``rrc_size``: host-side RandomResizedCrop mode (``TPU.HOST_RRC``) — the
    reference's own protocol (spatial_transforms.py:171-225 runs RRC on
    dataloader workers): one crop box per clip sampled here in
    original-image coordinates and fused into the native decode, so the
    produced clip is already (T, rrc_size, rrc_size, C).

    ``backend`` is ``"native"`` when the port's C++ decoder built, else
    ``"pil"``; it is fixed here, for the reader's lifetime. ``decoded``
    counts RGB clips per path (``native``, ``native_rrc``, ``pil``,
    ``pil_rrc``, ``pil_leading_frame_missing``, ``pil_no_header``); the
    worker threads update it under a lock."""

    def __init__(self, channel_ext: Dict[str, Tuple[str, object]],
                 buffer_size: int, eval_mode: bool,
                 image_name_formatter=default_image_name_formatter,
                 prob_pos_channel_replace: float = 0.25,
                 rng: Optional[np.random.Generator] = None,
                 rrc_size: Optional[int] = None):
        self.loader = VideoLoader(image_name_formatter)
        self.channel_ext = channel_ext or {}
        self.buffer_size = buffer_size
        self.eval_mode = eval_mode
        self.prob_replace = prob_pos_channel_replace
        self.rng = rng or np.random.default_rng()
        self.rrc_size = None if eval_mode else rrc_size
        self.backend = "native" if native_loader.available() else "pil"
        self.decoded: collections.Counter = collections.Counter()
        self._count_lock = threading.Lock()

    def _count(self, path: str) -> None:
        with self._count_lock:
            self.decoded[path] += 1

    # -- host RandomResizedCrop ------------------------------------------
    def _sample_rrc_box(self, h: int, w: int):
        """torchvision RandomResizedCrop.get_params (reference
        spatial_transforms.py:171-225: scale 0.25-1.0, ratio 3/4-4/3,
        10 attempts then center fallback). Returns (top, left, ch, cw)
        floats in original-pixel coords."""
        area = h * w
        for _ in range(10):
            target_area = area * self.rng.uniform(0.25, 1.0)
            aspect = math.exp(self.rng.uniform(math.log(3 / 4),
                                               math.log(4 / 3)))
            cw = math.sqrt(target_area * aspect)
            ch = math.sqrt(target_area / aspect)
            if cw <= w and ch <= h:
                return (self.rng.uniform(0, h - ch),
                        self.rng.uniform(0, w - cw), ch, cw)
        # fallback: largest center crop within the ratio bounds
        in_ratio = w / h
        if in_ratio < 3 / 4:
            cw, ch = float(w), w / (3 / 4)
        elif in_ratio > 4 / 3:
            ch, cw = float(h), h * (4 / 3)
        else:
            ch, cw = float(h), float(w)
        return ((h - ch) / 2, (w - cw) / 2, ch, cw)

    def _crop_resize_frames(self, frames: List[np.ndarray], box,
                            out: int, box_dims=None) -> np.ndarray:
        """RRC window of PIL-decoded frames (the native path does it
        in-decode).

        ``box`` is in ``box_dims`` = (h, w) coordinates (the RGB frame the
        box was sampled from); frames stored at a different resolution
        (e.g. saliency masks) get the box rescaled to their own dims so
        every view crops the SAME relative window."""
        top, left, ch, cw = box

        def fn(stack: np.ndarray) -> np.ndarray:
            sy = stack.shape[1] / box_dims[0] if box_dims else 1.0
            sx = stack.shape[2] / box_dims[1] if box_dims else 1.0
            y0, x0 = int(round(top * sy)), int(round(left * sx))
            y1 = int(round((top + ch) * sy))
            x1 = int(round((left + cw) * sx))
            win = stack[:, max(0, y0):max(y0 + 1, y1),
                        max(0, x0):max(x0 + 1, x1)]
            return resize_linear(win, out, out)

        return _map_frames(frames, fn)

    def _native_frame_paths(self, video_path: str, frame_indices):
        """Frame paths for the native decoder, substituting the last seen
        path for missing tail frames (loop-padding); None when the FIRST
        frame is missing — the caller then takes the PIL path."""
        fmt = self.loader.image_name_formatter
        paths, last = [], None
        for i in frame_indices:
            p = os.path.join(video_path, fmt(i))
            ok = os.path.exists(p)  # one stat per frame (hot path)
            if ok:
                last = p
            elif last is None:
                return None  # leading frame missing: use the PIL path
            paths.append(p if ok else last)
        return paths

    def _native_paths_or_count(self, video_path: str, frame_indices):
        """Native backend: the frame paths, or None after counting a clip
        whose leading frame is missing. PIL backend: None."""
        if self.backend != "native":
            return None
        paths = self._native_frame_paths(video_path, frame_indices)
        if paths is None:
            self._count("pil_leading_frame_missing")
        return paths

    def _read_rgb_rrc(self, video_path: str, frame_indices,
                      box, box_dims=None) -> np.ndarray:
        """RGB clip with its RRC window: native (crop fused into the
        decode) or PIL + resize."""
        paths = self._native_paths_or_count(video_path, frame_indices)
        if paths is not None:
            top, left, ch, cw = box
            bh, bw = box_dims if box_dims else (-1.0, -1.0)
            clip = native_loader.decode_frames_rrc(
                paths, top, left, ch, cw, self.rrc_size, box_h=bh, box_w=bw)
            self._count("native_rrc")
            return clip
        if self.backend == "pil":
            self._count("pil_rrc")
        # PIL with DCT-draft scaling: the decoded crop window only needs to
        # stay >= rrc_size, so frames whose window is k x larger can decode
        # at 1/k scale (k in {2,4,8}); _crop_resize_frames rescales the box
        # by the actual decoded dims, so coordinates stay exact.
        min_dim = None
        if box_dims is not None:
            k = max(1, int(min(box[2], box[3]) // self.rrc_size))
            min_dim = max(self.rrc_size, -(-min(box_dims) // k))
        frames = self._read_rgb_drafted(video_path, frame_indices, min_dim)
        return self._crop_resize_frames(frames, box, self.rrc_size,
                                        box_dims)

    def _frame_dims(self, video_path: str, frame_indices):
        """Header-only size read of the first READABLE frame (PIL lazy
        open); None when no frame opens — the caller then takes the
        non-RRC path instead of crashing the loader worker."""
        from PIL import Image

        for i in frame_indices:
            p = os.path.join(video_path, self.loader.image_name_formatter(i))
            try:
                with Image.open(p) as im:
                    w, h = im.size
                return h, w
            except OSError:
                continue
        return None

    def _read_rgb_drafted(self, video_path: str, frame_indices,
                          min_dim: Optional[int]) -> List[np.ndarray]:
        """PIL read of the RGB view with a DCT-draft hint: the decoded short
        side stays >= ``min_dim`` while 2-8x-larger sources decode at
        1/2-1/8 scale in the DCT domain (loaders.ImageLoaderPIL). Callers
        resize/crop afterwards, so only decode cost changes."""
        loader = self.loader
        if min_dim:
            loader = VideoLoader(self.loader.image_name_formatter,
                                 ImageLoaderPIL(min_dim=min_dim))
        return self._read(loader, video_path, frame_indices)

    def _read(self, loader, path, frame_indices) -> List[np.ndarray]:
        frames = loader(path, frame_indices)
        if not frames:
            raise FileNotFoundError(f"no frames under {path}")
        while len(frames) < len(frame_indices):
            frames.append(frames[-1])
        return frames

    def _buffered(self, frames: List[np.ndarray]) -> np.ndarray:
        size = (self.buffer_size, self.buffer_size)
        if self.eval_mode:
            # Resize(short edge)+CenterCrop (ref data_loader.py:107-115)
            return _resize_frames(frames, size,
                                  keep_aspect_short_edge=self.buffer_size)
        return _resize_frames(frames, size)

    def _read_rgb_buffered(self, video_path: str,
                           frame_indices) -> np.ndarray:
        """RGB clip at the buffer size: one GIL-free native C++ call decodes
        and resizes the whole clip, or PIL + resize."""
        paths = self._native_paths_or_count(video_path, frame_indices)
        if paths is not None:
            clip = native_loader.decode_frames(paths, self.buffer_size,
                                               self.eval_mode)
            self._count("native")
            return clip
        if self.backend == "pil":
            self._count("pil")
        # both train (square resize) and eval (short-edge resize + center
        # crop) only need the short side >= buffer_size.
        return self._buffered(self._read_rgb_drafted(
            video_path, frame_indices, self.buffer_size))

    def load(self, sample: dict, frame_indices: Sequence[int],
             use_channel_ext: bool = True,
             pos_channel_replace: bool = False) -> np.ndarray:
        """-> (T, S, S, C) uint8 (C = 3 + #extensions or 3; S = rrc_size
        in host-RRC mode, else buffer_size).

        ONE control path for both modes: the replacement-probability draw,
        salient-mean rejection, and channel-concat logic are shared; only
        the per-view materialization differs (host-RRC crop window vs
        plain buffer resize). In host-RRC mode the SAME relative crop
        window is applied to the RGB decode and to every extension/
        replacement view (rescaled to each view's native resolution)."""
        box = box_dims = None
        if self.rrc_size:
            box_dims = self._frame_dims(sample["video"], frame_indices)
            if box_dims is not None:
                box = self._sample_rrc_box(*box_dims)
            # box_dims None (no readable RGB frame header): degrade to a
            # full-frame resize at rrc_size so the item keeps the static
            # shape; a truly empty video still raises in _read below

        def rgb_view() -> np.ndarray:
            if box is not None:
                return self._read_rgb_rrc(sample["video"], frame_indices,
                                          box, box_dims)
            if self.rrc_size:
                self._count("pil_no_header")
                return _resize_frames(
                    self._read(self.loader, sample["video"], frame_indices),
                    (self.rrc_size, self.rrc_size))
            return self._read_rgb_buffered(sample["video"], frame_indices)

        def ext_view(frames: List[np.ndarray]) -> np.ndarray:
            if box is not None:
                return self._crop_resize_frames(frames, box, self.rrc_size,
                                                box_dims)
            if self.rrc_size:
                return _resize_frames(frames,
                                      (self.rrc_size, self.rrc_size))
            return self._buffered(frames)

        clip = None
        if pos_channel_replace and self.channel_ext:
            if self.rng.random() < self.prob_replace:
                key = self.rng.choice(list(self.channel_ext))
                _, ch_loader = self.channel_ext[key]
                arr = ext_view(self._read(ch_loader, sample[key],
                                          frame_indices))
                if key != "salient" or arr.mean() / 255.0 >= \
                        SALIENT_MASK_THRESHOLD:
                    clip = np.repeat(arr[..., :1], 3, axis=-1)
        if clip is None:
            clip = rgb_view()
            if use_channel_ext and not pos_channel_replace:
                for key, (_, ch_loader) in self.channel_ext.items():
                    ext = ext_view(self._read(ch_loader, sample[key],
                                              frame_indices))
                    clip = np.concatenate([clip, ext[..., :1]], axis=-1)
        return clip


class TripletsDataset:
    """Anchor/positive(/extra/negative) item sampler (see module docstring)."""

    POSITIVE_TYPES = ("same_inst", "diff_inst")

    def __init__(self, samples: List[dict], *,
                 temporal_transforms: Dict[str, Callable],
                 reader: ClipReader,
                 target_type: str = "label",
                 positive_sampling_p: float = 1.0,
                 negative_sampling: bool = False,
                 pos_channel_replace: bool = False,
                 relative_speed_perception: bool = False,
                 local_local_contrast: bool = False,
                 intra_negative: bool = False,
                 predict_temporal_ds: bool = False,
                 sample_duration: int = 16,
                 split: str = "train",
                 seed: int = 0):
        self.samples = samples
        self.tt = temporal_transforms
        self.reader = reader
        self.target_type = target_type
        self.positive_sampling_p = positive_sampling_p
        self.negative_sampling = negative_sampling
        self.pos_channel_replace = pos_channel_replace
        self.rsp = relative_speed_perception
        self.llc = local_local_contrast
        self.intra_negative = intra_negative
        self.predict_temporal_ds = predict_temporal_ds
        self.sample_duration = sample_duration
        self.split = split
        self.rng = np.random.default_rng(seed)
        self.shuffle_tt = Shuffle()

        self.data_labels = np.array([s[target_type] for s in samples])
        self.label_to_indices = {
            label: np.where(self.data_labels == label)[0]
            for label in np.unique(self.data_labels)
        }

    def __len__(self) -> int:
        return len(self.samples)

    def set_epoch_seed(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)

    def _sample_positive(self, index: int, a_target) -> dict:
        p_type = self.rng.choice(
            self.POSITIVE_TYPES,
            p=[self.positive_sampling_p, 1 - self.positive_sampling_p])
        if p_type == "same_inst" and self.split == "train":
            return self.samples[index]
        pool = self.label_to_indices[a_target]
        p_idx = self.rng.choice(pool)
        while p_idx == index and len(pool) > 1:
            p_idx = self.rng.choice(pool)
        return self.samples[p_idx]

    def _clip(self, sample: dict, role: str, *, shuffle: bool = False,
              ds: Optional[int] = None) -> np.ndarray:
        frame_indices = list(range(1, sample["num_frames"] + 1))
        if ds is not None:
            start = int(self.rng.integers(1, sample["num_frames"] + 1))
            frame_id = temporal_ds_frame_indices(
                self.sample_duration, sample["num_frames"], start, ds)
        else:
            frame_id = self.tt[role](frame_indices)
        if shuffle:
            frame_id = self.shuffle_tt(frame_id)
        use_ext = not (self.pos_channel_replace and role == "anchor")
        replace = self.pos_channel_replace and role != "anchor" \
            and role != "negative"
        return self.reader.load(sample, frame_id, use_channel_ext=use_ext,
                                pos_channel_replace=replace)

    def __getitem__(self, index: int) -> dict:
        anchor = self.samples[index]
        a_target = anchor[self.target_type]
        positive = self._sample_positive(index, a_target)
        p_target = positive[self.target_type]

        if self.split == "train" and self.predict_temporal_ds:
            ds_label = int(self.rng.integers(1, 5))  # ref :127 randint(1,4)
            return {
                "anchor": self._clip(anchor, "anchor", ds=ds_label),
                "positive": self._clip(positive, "positive", ds=ds_label),
                "targets": (a_target, p_target),
                "ds_label": ds_label,
                "index": index,
            }

        item = {
            "anchor": self._clip(anchor, "anchor"),
            "positive": self._clip(positive, "positive"),
            "targets": (a_target, p_target),
            "index": index,
        }
        if self.rsp:
            item["extra"] = self._clip(positive, "fast_positive")
        elif self.llc:
            item["extra"] = self._clip(anchor, "anchor")
        elif self.intra_negative:
            item["extra"] = self._clip(anchor, "intra_negative", shuffle=True)

        if self.negative_sampling:
            neg_idx = int(self.rng.integers(len(self)))
            while neg_idx == index:
                neg_idx = int(self.rng.integers(len(self)))
            negative = self.samples[neg_idx]
            item["negative"] = self._clip(negative, "negative")
            item["n_target"] = negative[self.target_type]
            item["negative_index"] = neg_idx
        return item


class VideoDataset:
    """One (or all test windows of a) video per item
    (reference datasets/video_dataset.py:14-121)."""

    def __init__(self, samples: List[dict], *,
                 temporal_transform: Callable,
                 reader: ClipReader,
                 target_type: str = "label",
                 split: str = "train",
                 sample_duration: int = 16):
        self.samples = samples
        self.tt = temporal_transform
        self.reader = reader
        self.target_type = target_type
        self.split = split
        # test-split window length (cfg.DATA.SAMPLE_DURATION): the
        # temporal transform is a Compose with no .size attribute, so the
        # old hasattr fallback silently pinned 16-frame windows for every
        # non-16 SAMPLE_DURATION, diverging from the 8-frame train bank
        self.sample_duration = sample_duration

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int) -> dict:
        sample = self.samples[index]
        target = sample[self.target_type]
        if self.split == "test":
            windows = get_test_video_frame_indices(
                sample["num_frames"],
                getattr(self.tt, "size", self.sample_duration))
            clips = np.stack([
                self.reader.load(sample, win) for win in windows
            ])  # (n_windows, T, H, W, C)
            return {"clip": clips, "target": target,
                    "path": sample["video"], "index": index}
        frame_indices = list(range(1, sample["num_frames"] + 1))
        frame_id = self.tt(frame_indices)
        return {"clip": self.reader.load(sample, frame_id),
                "target": target, "path": sample["video"], "index": index}
