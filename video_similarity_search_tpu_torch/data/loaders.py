"""Host-side frame loaders: JPEG dirs, binary masks, HDF5 video / TVL1 flow
(the port's copy of the JAX package's ``data/loaders.py``; ``h5py`` is
imported only when an HDF5 file is read).

Same loader surface as the reference (datasets/loader.py:10-94), returning
numpy uint8 HWC frames instead of PIL images — the fixed-shape uint8 arrays
feed the device augmentation kernel (host decodes, device transforms).
"""

from __future__ import annotations

import io
import os
from typing import Callable, List, Optional

import numpy as np


def _to_uint8_rgb(img) -> np.ndarray:
    arr = np.asarray(img.convert("RGB"))
    return arr


class ImageLoaderPIL:
    """Per-frame JPEG via PIL (reference datasets/loader.py:10-21).

    ``min_dim``: optional DCT-draft hint. When the consumer only needs the
    decoded short side to stay >= ``min_dim`` (it crops/resizes afterwards),
    libjpeg can decode at 1/2, 1/4 or 1/8 scale straight from the DCT
    coefficients (``Image.draft``) — the same scaled-decode trick the native
    loader uses (native/vss_loader.cpp). Non-JPEG formats ignore the hint.
    Default None decodes at full resolution (exact reference behavior)."""

    def __init__(self, min_dim: Optional[int] = None):
        self.min_dim = min_dim

    def __call__(self, path: str) -> np.ndarray:
        from PIL import Image

        with open(path, "rb") as f:
            with Image.open(f) as img:
                if self.min_dim:
                    img.draft(None, (self.min_dim, self.min_dim))
                return _to_uint8_rgb(img)


class BinaryImageLoaderPIL:
    """Grayscale masks / flow channels, single channel
    (reference datasets/loader.py:24-35)."""

    def __call__(self, path: str) -> np.ndarray:
        from PIL import Image

        with open(path, "rb") as f:
            with Image.open(f) as img:
                return np.asarray(img.convert("L"))[..., None]


class VideoLoader:
    """Frame-directory loader: path + indices -> list of frames
    (reference datasets/loader.py:38-55)."""

    def __init__(self, image_name_formatter: Callable[[int], str],
                 image_loader=None):
        self.image_name_formatter = image_name_formatter
        self.image_loader = image_loader() if isinstance(image_loader, type) \
            else (image_loader or ImageLoaderPIL())

    def __call__(self, video_path: str, frame_indices) -> List[np.ndarray]:
        frames = []
        for i in frame_indices:
            image_path = os.path.join(video_path,
                                      self.image_name_formatter(i))
            if os.path.exists(image_path):
                frames.append(self.image_loader(image_path))
        return frames


class VideoLoaderHDF5:
    """HDF5 'video' dataset of encoded frames (reference datasets/loader.py:58-71)."""

    def __call__(self, video_path: str, frame_indices) -> List[np.ndarray]:
        import h5py
        from PIL import Image

        with h5py.File(video_path, "r") as f:
            video_data = f["video"]
            frames = []
            for i in frame_indices:
                if i < len(video_data):
                    frames.append(_to_uint8_rgb(
                        Image.open(io.BytesIO(video_data[i]))))
                elif frames:
                    frames.append(frames[-1])
                # first index already out of range (annotation longer than
                # the stored data): return the partial/empty list like the
                # reference (datasets/loader.py:64-69) instead of IndexError
        return frames


class VideoLoaderFlowHDF5:
    """HDF5 TVL1 flow: u and v datasets; returns (u, v, u) 3-channel frames
    (reference datasets/loader.py:74-94 duplicates a channel)."""

    def __init__(self):
        self.flows = ["u", "v"]

    def __call__(self, video_path: str, frame_indices) -> List[np.ndarray]:
        import h5py
        from PIL import Image

        with h5py.File(video_path, "r") as f:
            flow_data = [f[f"video_{flow}"] for flow in self.flows]
            frames = []
            for i in frame_indices:
                if i < len(flow_data[0]):
                    u = np.asarray(Image.open(io.BytesIO(flow_data[0][i]))
                                   .convert("L"))
                    v = np.asarray(Image.open(io.BytesIO(flow_data[1][i]))
                                   .convert("L"))
                    frames.append(np.stack([u, v, u], axis=-1))
                elif frames:  # see VideoLoaderHDF5 note
                    frames.append(frames[-1])
        return frames
