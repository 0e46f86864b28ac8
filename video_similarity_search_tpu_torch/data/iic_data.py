"""IIC-protocol raw-video datasets; port of the JAX package's
``data/iic_data.py``.

Capability parity with reference iic_datasets/ucf101.py:23-190 and
hmdb51.py twins: decode the whole video file, sample ``sample_num`` (10)
evenly-spaced clips per video for retrieval feature extraction, with
clip-consistent spatial transforms. The reference decodes with
skvideo.io; here, as in the JAX package, OpenCV decodes
(cv2.VideoCapture, BGR turned to RGB) and resizes (``cv2.resize``'s
INTER_LINEAR), so items come out byte-equal to the JAX package's. cv2 is
imported inside the functions that use it, never with the module.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np


def decode_video(path: str, max_frames: Optional[int] = None) -> np.ndarray:
    """Whole-video decode -> (T, H, W, 3) uint8 RGB."""
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        if max_frames and len(frames) >= max_frames:
            break
    cap.release()
    if not frames:
        raise IOError(f"could not decode {path}")
    return np.stack(frames)


def parse_split_file(list_path: str, class_index_path: str
                     ) -> List[Tuple[str, int]]:
    """UCF101 official split lists: 'ApplyEyeMakeup/v_..._c01.avi 1' plus
    classInd.txt (reference iic_datasets/ucf101.py uses the same files)."""
    class_idx = {}
    with open(class_index_path) as f:
        for line in f:
            idx, name = line.strip().split()
            class_idx[name] = int(idx) - 1
    items = []
    with open(list_path) as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            rel = parts[0]
            label = class_idx[rel.split("/")[0]]
            items.append((rel, label))
    return items


# Directory layouts of the two IIC benchmarks (reference
# iic_datasets/ucf101.py:41-50 vs hmdb51.py:41-50).
_IIC_LAYOUTS = {
    "ucf101": {"split_dir": "split", "class_file": "classInd.txt",
               "video_dir": "videos"},
    "hmdb51": {"split_dir": "prev_split", "class_file": "ClassInd.txt",
               "video_dir": "avi"},
}


class VideoRecognitionDataset:
    """IIC recognition dataset: UCF101Dataset (reference
    iic_datasets/ucf101.py:23-117) and its HMDB51 twin (hmdb51.py:23-120)
    unified behind a ``layout`` switch.

    train: one random ``clip_len`` window -> {'clip': (T,H,W,3) uint8}.
    test: ``test_sample_num`` evenly spaced clips ->
    {'clip': (N,T,H,W,3)} (multi-window, collate_videos flattens).
    """

    def __init__(self, root_dir: str, clip_len: int, split: str = "1",
                 train: bool = True, test_sample_num: int = 10,
                 layout: str = "ucf101", sample_size: Optional[int] = None,
                 seed: Optional[int] = None):
        lay = _IIC_LAYOUTS[layout]
        self.root_dir = root_dir
        self.video_dir = os.path.join(root_dir, lay["video_dir"])
        self.clip_len = clip_len
        self.train = train
        self.test_sample_num = test_sample_num
        self.sample_size = sample_size
        self.rng = np.random.default_rng(seed)

        split_dir = os.path.join(root_dir, lay["split_dir"])
        class_index_path = os.path.join(split_dir, lay["class_file"])
        list_name = ("trainlist0" if train else "testlist0") + split + ".txt"
        self.items = parse_split_file(os.path.join(split_dir, list_name),
                                      class_index_path)

    def __len__(self) -> int:
        return len(self.items)

    def set_epoch_seed(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)

    def _maybe_resize(self, clip: np.ndarray) -> np.ndarray:
        if not self.sample_size:
            return clip
        import cv2

        return np.stack([cv2.resize(f, (self.sample_size, self.sample_size))
                         for f in clip])

    def __getitem__(self, index: int) -> dict:
        rel, label = self.items[index]
        video = decode_video(os.path.join(self.video_dir, rel))
        t = len(video)
        if t < self.clip_len:
            reps = int(np.ceil(self.clip_len / t))
            video = np.concatenate([video] * reps)[:self.clip_len]
            t = len(video)
        if self.train:
            start = int(self.rng.integers(0, t - self.clip_len + 1))
            clip = self._maybe_resize(video[start:start + self.clip_len])
            return {"clip": clip, "target": label, "index": index}
        # test: evenly spaced clip centers (reference :98-101)
        centers = np.linspace(self.clip_len / 2, t - self.clip_len / 2,
                              self.test_sample_num)
        clips = np.stack([
            self._maybe_resize(
                video[int(c - self.clip_len / 2):
                      int(c - self.clip_len / 2) + self.clip_len])
            for c in centers
        ])
        return {"clip": clips, "target": label, "index": index}


class UCF101Dataset(VideoRecognitionDataset):
    """reference iic_datasets/ucf101.py:23-117."""

    def __init__(self, root_dir, clip_len, **kwargs):
        super().__init__(root_dir, clip_len, layout="ucf101", **kwargs)


class HMDB51Dataset(VideoRecognitionDataset):
    """reference iic_datasets/hmdb51.py:23-120."""

    def __init__(self, root_dir, clip_len, **kwargs):
        super().__init__(root_dir, clip_len, layout="hmdb51", **kwargs)


class ClipRetrievalDataset:
    """``sample_num`` evenly spaced clips per video
    (reference iic_datasets/ucf101.py:120-190 UCF101ClipRetrievalDataset)."""

    def __init__(self, root_dir: str, items: List[Tuple[str, int]], *,
                 clip_len: int = 16, sample_num: int = 10,
                 sample_size: Optional[int] = None):
        self.root_dir = root_dir
        self.items = items
        self.clip_len = clip_len
        self.sample_num = sample_num
        self.sample_size = sample_size

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, index: int) -> dict:
        rel, label = self.items[index]
        video = decode_video(os.path.join(self.root_dir, rel))
        t = len(video)
        if t < self.clip_len:
            reps = int(np.ceil(self.clip_len / t))
            video = np.concatenate([video] * reps)[:self.clip_len]
            t = len(video)
        starts = np.linspace(0, t - self.clip_len, self.sample_num
                             ).astype(int)
        clips = np.stack([video[s:s + self.clip_len] for s in starts])
        if self.sample_size:
            import cv2

            resized = np.stack([
                np.stack([cv2.resize(f, (self.sample_size, self.sample_size))
                          for f in clip]) for clip in clips])
            clips = resized
        return {"clips": clips, "label": label, "index": index}


class UCF101ClipRetrievalDataset(ClipRetrievalDataset):
    """reference iic_datasets/ucf101.py:120-190: retrieval clips from the
    official split layout (split/classInd.txt + videos/)."""

    def __init__(self, root_dir: str, clip_len: int, sample_num: int = 10,
                 train: bool = True, split: str = "1",
                 sample_size: Optional[int] = None, layout: str = "ucf101"):
        lay = _IIC_LAYOUTS[layout]
        split_dir = os.path.join(root_dir, lay["split_dir"])
        list_name = ("trainlist0" if train else "testlist0") + split + ".txt"
        items = parse_split_file(
            os.path.join(split_dir, list_name),
            os.path.join(split_dir, lay["class_file"]))
        super().__init__(os.path.join(root_dir, lay["video_dir"]), items,
                         clip_len=clip_len, sample_num=sample_num,
                         sample_size=sample_size)


class HMDB51ClipRetrievalDataset(UCF101ClipRetrievalDataset):
    """reference iic_datasets/hmdb51.py retrieval twin
    (prev_split/ClassInd.txt + avi/)."""

    def __init__(self, root_dir: str, clip_len: int, **kwargs):
        super().__init__(root_dir, clip_len, layout="hmdb51", **kwargs)
