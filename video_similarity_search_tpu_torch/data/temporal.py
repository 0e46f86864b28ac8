"""Temporal transforms: pure frame-index samplers (the port's copy of the
JAX package's ``data/temporal.py``). ``TemporalTransform.rng`` is this
module's own class-level generator, separate from the JAX package's.

Same surface as the reference (datasets/temporal_transforms.py:8-246):
Begin/End/Center/Specific/Random crops, Random@2x speed, EvenCrop,
SlidingWindow, Subsampling, CenterFrame, block Shuffle, LoopPadding,
Compose. These run on host in the index domain (numpy RNG, seedable),
feeding the device loader with fixed-length index lists.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np


class TemporalTransform:
    rng = np.random.default_rng()

    @classmethod
    def seed(cls, seed: int) -> None:
        cls.rng = np.random.default_rng(seed)


def _loop_to(out: List[int], size: int) -> List[int]:
    """Loop-pad by cycling the clip until ``size`` (ref LoopPadding :28-41)."""
    i = 0
    while len(out) < size and out:
        out.append(out[i])
        i += 1
    return out


class Compose(TemporalTransform):
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, frame_indices):
        for i, t in enumerate(self.transforms):
            if frame_indices and isinstance(frame_indices[0], list):
                rest = Compose(self.transforms[i:])
                return [rest(clip) for clip in frame_indices]
            frame_indices = t(frame_indices)
        return frame_indices


class LoopPadding(TemporalTransform):
    def __init__(self, size: int):
        self.size = size

    def __call__(self, frame_indices):
        return _loop_to(list(frame_indices), self.size)


class TemporalBeginCrop(TemporalTransform):
    def __init__(self, size: int):
        self.size = size

    def __call__(self, frame_indices):
        return _loop_to(list(frame_indices[:self.size]), self.size)


class TemporalEndCrop(TemporalTransform):
    def __init__(self, size: int):
        self.size = size

    def __call__(self, frame_indices):
        return _loop_to(list(frame_indices[-self.size:]), self.size)


class TemporalCenterCrop(TemporalTransform):
    def __init__(self, size: int):
        self.size = size

    def __call__(self, frame_indices):
        center = len(frame_indices) // 2
        begin = max(0, center - self.size // 2)
        end = min(begin + self.size, len(frame_indices))
        return _loop_to(list(frame_indices[begin:end]), self.size)


class TemporalSpecificCrop(TemporalTransform):
    def __init__(self, begin_index: int, size: int):
        self.begin_index = begin_index
        self.size = size

    def __call__(self, frame_indices):
        out = list(frame_indices[self.begin_index:self.begin_index + self.size])
        return _loop_to(out, self.size)


class TemporalRandomCrop(TemporalTransform):
    """Random window of ``size`` frames; ``start_index`` bounds the earliest
    start (ref :111-128 — note the reference does NOT loop-pad here)."""

    def __init__(self, size: int, start_index: int = 0):
        self.size = size
        self.start_index = start_index

    def __call__(self, frame_indices):
        rand_end = max(0, len(frame_indices) - self.size)
        rand_start = min(rand_end, self.start_index)
        begin = int(self.rng.integers(rand_start, rand_end + 1))
        end = min(begin + self.size, len(frame_indices))
        return list(frame_indices[begin:end])


class TemporalRandomCrop2xSpeed(TemporalTransform):
    """Random 2x-subsampled window (relative-speed positive, ref :131-148)."""

    def __init__(self, size: int, start_index: int = 0):
        self.size = size
        self.start_index = start_index

    def __call__(self, frame_indices):
        rand_end = max(0, len(frame_indices) - 2 * self.size)
        rand_start = min(rand_end, self.start_index)
        begin = int(self.rng.integers(rand_start, rand_end + 1))
        end = min(begin + 2 * self.size, len(frame_indices))
        return list(frame_indices[begin:end:2])


class TemporalEvenCrop(TemporalTransform):
    def __init__(self, size: int, n_samples: int = 1):
        self.size = size
        self.n_samples = n_samples

    def __call__(self, frame_indices):
        n = len(frame_indices)
        if self.n_samples == 1:
            stride = 1
        else:
            stride = max(1, math.ceil((n - 1 - self.size)
                                      / (self.n_samples - 1)))
        out = []
        for begin in frame_indices[::stride]:
            if len(out) >= self.n_samples:
                break
            end = min(frame_indices[-1] + 1, begin + self.size)
            sample = list(range(begin, end))
            if len(sample) < self.size:
                out.append(_loop_to(sample, self.size))
                break
            out.append(sample)
        return out


class TemporalCenterFrame(TemporalTransform):
    def __call__(self, frame_indices):
        return [frame_indices[len(frame_indices) // 2]]


class SlidingWindow(TemporalTransform):
    """Non-overlapping (or strided) windows — the test-time protocol
    (ref :199-221; used via get_test_video_frame_indices)."""

    def __init__(self, size: int, stride: int = 0):
        self.size = size
        self.stride = stride if stride else size

    def __call__(self, frame_indices):
        out = []
        for begin in frame_indices[::self.stride]:
            end = min(frame_indices[-1] + 1, begin + self.size)
            sample = list(range(begin, end))
            if len(sample) < self.size:
                out.append(_loop_to(sample, self.size))
                break
            out.append(sample)
        return out


class TemporalSubsampling(TemporalTransform):
    def __init__(self, stride: int):
        self.stride = stride

    def __call__(self, frame_indices):
        return list(frame_indices[::self.stride])


class Shuffle(TemporalTransform):
    """Block shuffle (intra-negative view, ref :233-246)."""

    def __init__(self, block_size: int = 2):
        self.block_size = block_size

    def __call__(self, frame_indices):
        blocks = [list(frame_indices[i:i + self.block_size])
                  for i in range(0, len(frame_indices), self.block_size)]
        order = self.rng.permutation(len(blocks))
        return [idx for b in order for idx in blocks[b]]


def temporal_ds_frame_indices(sample_duration: int, total_frame_len: int,
                              start_frame: int, ds: int = 1) -> List[int]:
    """Wrapping strided indices for temporal-downsample-rate prediction
    (reference datasets/triplets_dataset.py:203-208)."""
    return [(start_frame + i * ds) % total_frame_len + 1
            for i in range(sample_duration)]


def get_test_video_frame_indices(num_frames: int, sample_duration: int
                                 ) -> List[List[int]]:
    """Every non-overlapping test window (ref datasets/video_dataset.py:64-76)."""
    return SlidingWindow(sample_duration)(list(range(1, num_frames + 1)))
