"""CoCLR-style LMDB datasets (msgpack-framed JPEG stores); port of the JAX
package's ``data/lmdb_data.py``.

Capability parity with reference coclr_utils/lmdb_dataset.py:52-882: the
concrete UCF101 / HMDB51 / K400 x RGB / Flow x 1-clip / 2-clip / 2-stream
classes over the same LMDB files and sidecar metadata:

  * LMDB special keys ``__len__`` / ``__keys__`` / ``__order__``
    (+ ``__vlen__`` for flow stores); video keys are ``'%09d' % i`` over
    the db order (reference :75-81, :110-112);
  * class list from ``<root>/ClassInd.txt`` (optionally ``id,name`` rows,
    reference :83-90);
  * split listing ``<root>/<split>_split%02d.csv`` (mode 'val' reads the
    'test' split then keeps pandas' ``sample(frac=0.3,
    random_state=666)`` subset, reference :92-121);
  * too-short filter ``vlen - num_frames//2*ds - 1 <= 0`` (:113-118);
  * ``frame_sampler``: train = one random window at fixed downsample
    ``ds`` with left-pad for short videos; test = half-overlap windows
    (step ``num_frames*ds//2 - 1``), randomly keeping 10 (with
    replacement, as the reference does) (:123-157);
  * ``double_sampler`` two independent windows for _2CLIP pretraining
    (:159-162); 2-stream merges RGB+flow stores (:411-568).

Every draw comes from a numpy ``Generator`` in the JAX package's order,
so one seed gives the same frames in both packages. Two things differ
from the JAX module in how, not what: values are unframed by the port's
own msgpack reader (``msgpack_lite``; the JAX module imports msgpack), and
``subsample_val`` draws pandas' subset with numpy alone (the JAX module
calls pandas, and without pandas picks another subset).

Storage access goes through a small KV-reader seam so the identical
dataset logic runs over a real LMDB (``LMDBReader``, through the port's
pure-Python ``lmdb_lite`` pager whether or not py-lmdb is installed) or
an in-memory dict (``DictReader``).
"""

from __future__ import annotations

import csv
import io
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import msgpack_lite
from .lmdb_lite import LiteEnv


# ---------------------------------------------------------------------------
# Storage backends
# ---------------------------------------------------------------------------

class DictReader:
    """In-memory KV store with the reference LMDB key scheme."""

    def __init__(self, mapping: Dict[bytes, bytes]):
        self._m = dict(mapping)

    def get(self, key: bytes) -> Optional[bytes]:
        return self._m.get(key)


class LMDBReader:
    """Real LMDB-file backend: the port's pure-Python pager
    (:mod:`.lmdb_lite`) over the LMDB 0.9 on-disk format, on every
    machine (the reference opens the file with py-lmdb, :74-76)."""

    def __init__(self, db_path: str):
        self._env = LiteEnv(db_path)

    def get(self, key: bytes) -> Optional[bytes]:
        return self._env.get(key)


def open_store(db_path_or_reader):
    if isinstance(db_path_or_reader, (DictReader, LMDBReader)):
        return db_path_or_reader
    return LMDBReader(db_path_or_reader)


def _decode_jpeg(raw: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))


# ---------------------------------------------------------------------------
# Metadata
# ---------------------------------------------------------------------------

def read_class_index(root: str) -> Tuple[Dict[str, int], Dict[int, str]]:
    """<root>/ClassInd.txt, optionally 'id,name' rows (reference :83-87)."""
    with open(os.path.join(root, "ClassInd.txt")) as f:
        classes = [line.strip() for line in f if line.strip()]
    if classes and "," in classes[0]:
        classes = [c.split(",")[-1].strip() for c in classes]
    class_to_idx = {c: i for i, c in enumerate(classes)}
    return class_to_idx, {i: c for c, i in class_to_idx.items()}


def read_split_csv(root: str, mode: str, which_split: int,
                   flow_layout: bool = False) -> List[dict]:
    """<root>/<split>_split%02d.csv rows -> [{vpath, vlen, vlabel, vname}].

    Columns: vpath, vlen (RGB layout, reference :92-99) — the flow stores
    carry the flow vlen in an extra final column (reference :376-381:
    ``vpath, _, vlabel, vname, vlen``; the sidecar adds rgb_vlen then
    flow_vlen). vlabel/vname are derived from the path like the reference
    (str.split('/') -3 / -2).
    """
    split_mode = "test" if mode == "val" else mode
    path = os.path.join(root, f"{split_mode}_split{which_split:02d}.csv")
    rows = []
    with open(path) as f:
        for parts in csv.reader(f):
            if not parts:
                continue
            vpath = parts[0]
            pieces = vpath.split("/")
            vlabel = pieces[-3]
            vname = vlabel + "/" + pieces[-2]
            vlen = int(parts[-1]) if flow_layout else int(parts[1])
            rows.append({"vpath": vpath, "vlen": vlen, "vlabel": vlabel,
                         "vname": vname})
    return rows


def subsample_val(rows: List[dict], frac: float = 0.3,
                  random_state: int = 666) -> List[dict]:
    """mode=='val' 30% subsample (reference :120-121), the rows pandas'
    ``DataFrame.sample(frac=frac, random_state=random_state)`` keeps, in
    its order, without pandas: ``sample`` draws ``round(frac * n)`` rows
    (Python's round) with ``RandomState(random_state).choice(n, size,
    replace=False)``."""
    n = len(rows)
    keep = np.random.RandomState(random_state).choice(
        n, size=round(frac * n), replace=False)
    return [rows[int(i)] for i in keep]


# ---------------------------------------------------------------------------
# Samplers (reference :123-162)
# ---------------------------------------------------------------------------

def frame_sampler(vlen: int, num_frames: int, ds: int, mode: str,
                  window: bool = False, test_keep: int = 10,
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Flat frame-index array (reference UCF101LMDB_2CLIP.frame_sampler).

    test/window: half-overlap sliding windows (step num_frames*ds//2 - 1),
    ``test_keep`` windows chosen WITH replacement like the reference's
    np.random.choice default (:138). train/val: one random window; short
    videos left-pad with frame 0 (:148-153).
    """
    rng = rng or np.random.default_rng()
    span = num_frames * ds
    if mode == "test" or window:
        if vlen - span <= 0:
            sequence = np.arange(num_frames) * ds
            seq_idx = np.zeros_like(sequence)
            sequence = sequence[sequence < vlen]
            if len(sequence):
                seq_idx[-len(sequence):] = sequence
            return seq_idx
        available = vlen - span
        step = max(span // 2 - 1, 1)
        start = np.arange(0, available + 1, step)[:, None]
        seq_idx = np.arange(num_frames)[None, :] * ds + start
        ind = rng.choice(seq_idx.shape[0], size=test_keep, replace=True)
        return seq_idx[ind].flatten()
    if vlen - span <= 0:
        sequence = np.arange(num_frames) * ds + int(rng.integers(0, ds))
        seq_idx = np.zeros_like(sequence)
        sequence = sequence[sequence < vlen]
        if len(sequence):
            seq_idx[-len(sequence):] = sequence
        return seq_idx
    start = int(rng.integers(0, vlen - span))
    return np.arange(num_frames) * ds + start


def double_sampler(vlen: int, num_frames: int, ds: int, mode: str,
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Two independent windows, concatenated (reference :159-162)."""
    rng = rng or np.random.default_rng()
    a = frame_sampler(vlen, num_frames, ds, mode, rng=rng)
    b = frame_sampler(vlen, num_frames, ds, mode, rng=rng)
    return np.concatenate([a, b])


# ---------------------------------------------------------------------------
# Concrete dataset family (reference :52-882)
# ---------------------------------------------------------------------------

class UCF101LMDB_2CLIP:
    """Two-clip pretraining reader (reference :52-198).

    ``__getitem__`` returns {'clips': (2*num_frames, H, W, 3) uint8,
    'label', 'index', 'vname'} — channels-last numpy for the device
    augmentation path (torch stacking/transforms happen on device here).
    """

    flow_layout = False

    def __init__(self, root: str, db_path, mode: str = "val",
                 num_frames: int = 32, ds: int = 1, which_split: int = 1,
                 window: bool = False, return_label: bool = False,
                 seed: Optional[int] = None):
        self.root = root
        self.mode = mode
        self.num_frames = num_frames
        self.ds = ds
        self.window = window
        self.return_label = return_label
        self.rng = np.random.default_rng(seed)
        self.store = open_store(db_path)

        self.db_length = msgpack_lite.loads(self.store.get(b"__len__"))
        self.db_keys = msgpack_lite.loads(self.store.get(b"__keys__"))
        self.db_order = msgpack_lite.loads(self.store.get(b"__order__"))

        self.class_to_idx, self.idx_to_class = read_class_index(root)
        self.num_class = len(self.class_to_idx)

        order = [o.decode() if isinstance(o, bytes) else o
                 for o in self.db_order]
        self.get_video_id = {name: f"{i:09d}" for i, name in enumerate(order)}

        rows = read_split_csv(root, mode, which_split, self.flow_layout)
        # too-short filter: max padding = half the clip (reference :113-118)
        rows = [r for r in rows
                if r["vlen"] - self.num_frames // 2 * self.ds - 1 > 0]
        # full filtered list, BEFORE the val subsample: the 2-stream
        # wrapper aligns its second modality against this (two independent
        # 30% subsamples would intersect to ~9% of videos)
        self.all_rows = rows
        if mode == "val":
            rows = subsample_val(rows)
        self.video_subset = rows

    def __len__(self) -> int:
        return len(self.video_subset)

    def encode_action(self, name: str) -> int:
        return self.class_to_idx[name]

    def decode_action(self, idx: int) -> str:
        return self.idx_to_class[idx]

    def _sample(self, vlen: int) -> np.ndarray:
        return double_sampler(vlen, self.num_frames, self.ds, self.mode,
                              self.rng)

    def _frames(self, vname: str, frame_index: np.ndarray) -> np.ndarray:
        raw = self.store.get(self.get_video_id[vname].encode("ascii"))
        if raw is None:
            raise KeyError(f"video {vname!r} not in store")
        frames_raw = msgpack_lite.loads(raw)
        return np.stack([_decode_jpeg(frames_raw[int(i)])
                         for i in frame_index])

    def __getitem__(self, index: int) -> dict:
        row = self.video_subset[index]
        frame_index = self._sample(row["vlen"])
        clips = self._frames(row["vname"], frame_index)
        # the label is always attached (the reference gates on return_label
        # only because its tuple layout changes; a dict has no such cost)
        return {"clips": clips, "index": index, "vname": row["vname"],
                "label": self.encode_action(row["vlabel"])}


class UCF101LMDB(UCF101LMDB_2CLIP):
    """Single-clip classification reader (reference :201-229)."""

    def _sample(self, vlen: int) -> np.ndarray:
        return frame_sampler(vlen, self.num_frames, self.ds, self.mode,
                             self.window, rng=self.rng)


class HMDB51LMDB(UCF101LMDB):
    """Same reader over the HMDB51 store (reference :231-236)."""


class UCF101Flow_LMDB_2CLIP(UCF101LMDB_2CLIP):
    """TVL1-flow two-clip reader (reference :238-374): split csv carries
    the flow vlen in its final column."""

    flow_layout = True


class UCF101Flow_LMDB(UCF101Flow_LMDB_2CLIP):
    """Single-clip flow reader (reference :376-402)."""

    def _sample(self, vlen: int) -> np.ndarray:
        return frame_sampler(vlen, self.num_frames, self.ds, self.mode,
                             self.window, rng=self.rng)


class HMDB51Flow_LMDB(UCF101Flow_LMDB):
    """reference :404-409."""


class KineticsLMDB_2CLIP(UCF101LMDB_2CLIP):
    """K400 readers share the UCF layout (reference :571-882)."""


class K400_LMDB_2CLIP(KineticsLMDB_2CLIP):
    pass


class K400_LMDB(UCF101LMDB):
    """Single-clip K400 classification reader (reference :706-882)."""


class K400_Flow_LMDB_2CLIP(UCF101Flow_LMDB_2CLIP):
    pass


class K400_Flow_LMDB(UCF101Flow_LMDB):
    """Single-clip K400 flow reader."""


class UCF101_2STREAM_LMDB_2CLIP:
    """RGB + flow stores, length-aligned clips (reference :411-568):
    frame indices are sampled once on the min(rgb_vlen, flow_vlen)."""

    def __init__(self, root: str, db_path_rgb, db_path_flow,
                 mode: str = "val", num_frames: int = 32, ds: int = 1,
                 which_split: int = 1, seed: Optional[int] = None):
        self.rgb = UCF101LMDB_2CLIP(root, db_path_rgb, mode=mode,
                                    num_frames=num_frames, ds=ds,
                                    which_split=which_split, seed=seed)
        self.flow = UCF101Flow_LMDB_2CLIP(root, db_path_flow, mode=mode,
                                          num_frames=num_frames, ds=ds,
                                          which_split=which_split, seed=seed)
        self.rng = np.random.default_rng(seed)
        self.num_frames = num_frames
        self.ds = ds
        self.mode = mode
        # align by vname: the RGB subset (with its val subsample) is the
        # authority; flow rows come from the flow dataset's FULL filtered
        # list. Matching two independently-subsampled 30% val sets would
        # keep only their ~9% intersection (the reference builds both
        # modalities from ONE csv and subsamples once, :411-466).
        flow_by_name = {r["vname"]: r for r in self.flow.all_rows}
        self.video_subset = [
            (r, flow_by_name[r["vname"]])
            for r in self.rgb.video_subset if r["vname"] in flow_by_name
        ]

    def __len__(self) -> int:
        return len(self.video_subset)

    def __getitem__(self, index: int) -> dict:
        rgb_row, flow_row = self.video_subset[index]
        vlen = min(rgb_row["vlen"], flow_row["vlen"])
        frame_index = double_sampler(vlen, self.num_frames, self.ds,
                                     self.mode, self.rng)
        return {
            "rgb": self.rgb._frames(rgb_row["vname"], frame_index),
            "flow": self.flow._frames(flow_row["vname"], frame_index),
            "label": self.rgb.encode_action(rgb_row["vlabel"]),
            "index": index,
        }


class K400_2STREAM_LMDB_2CLIP(UCF101_2STREAM_LMDB_2CLIP):
    pass


class LMDBClipAdapter:
    """Adapts an LMDB dataset to the frame-JPEG item contract
    ({'clip', 'target', 'index'}) so ``PrefetchLoader`` + ``collate_videos``
    feed it to the same train/eval steps.

    Frames are host-resized to a square ``buffer_size`` (the device
    augmentation crops from this buffer, like ClipReader); test-mode
    multi-window index arrays come back as a (windows, T, S, S, C) stack.
    """

    def __init__(self, ds, buffer_size: int, seq_len: int):
        self.ds = ds
        self.buffer_size = buffer_size
        self.seq_len = seq_len

    def __len__(self) -> int:
        return len(self.ds)

    def set_epoch_seed(self, seed: int) -> None:
        self.ds.rng = np.random.default_rng(seed)

    def _resize(self, frames: np.ndarray) -> np.ndarray:
        from PIL import Image

        s = self.buffer_size
        if frames.shape[1] == s and frames.shape[2] == s:
            return frames
        return np.stack([
            np.asarray(Image.fromarray(f).resize((s, s))) for f in frames
        ])

    def __getitem__(self, index: int) -> dict:
        item = self.ds[index]
        clips = self._resize(item["clips"])
        n = clips.shape[0]
        if n > self.seq_len:  # multi-window test item
            clips = clips.reshape(n // self.seq_len, self.seq_len,
                                  *clips.shape[1:])
        return {"clip": clips, "target": item["label"], "index": index}


def build_lmdb_loader(args_dataset: str, lmdb_root: str, split: str, cfg,
                      batch_size: int, *, flow: bool = False,
                      buffer_size: Optional[int] = None,
                      which_split: int = 1, device="cuda"):
    """--lmdb_root CLI wiring: metadata (ClassInd.txt + split csvs) and the
    conventionally-named store ``<dataset>[_tvl1]_frame.lmdb`` live under
    ``lmdb_root`` (reference defaults, coclr_utils/lmdb_dataset.py:34,54).
    With ``TPU.PREFETCH_DEVICE_PUT`` and a CUDA ``device`` the loader
    uploads each batch through its pinned ring on a side stream, as
    ``build_data_loader`` does; ``device="cpu"`` keeps batches on the
    host. -> (loader, (adapter, idx_to_class))."""
    import torch

    from ..utils.device import resolve_device
    from .pipeline import PrefetchLoader, collate_videos

    upload = (bool(cfg.TPU.PREFETCH_DEVICE_PUT)
              and torch.device(device).type == "cuda")
    if upload:
        device = resolve_device(device)  # before any file is read
    name = {"ucf101": "ucf101", "hmdb51": "hmdb51", "k400": "k400"}[
        args_dataset]
    db_name = f"{name}_tvl1_frame.lmdb" if flow else f"{name}_frame.lmdb"
    db_path = os.path.join(lmdb_root, db_name)
    ds = get_lmdb_dataset(args_dataset, lmdb_root, db_path, flow=flow,
                          mode="train" if split == "train" else split,
                          num_frames=cfg.DATA.SAMPLE_DURATION,
                          which_split=which_split)
    buffer = buffer_size or (2 * cfg.DATA.SAMPLE_SIZE if split == "train"
                             else cfg.DATA.SAMPLE_SIZE)
    adapter = LMDBClipAdapter(ds, buffer, cfg.DATA.SAMPLE_DURATION)
    return PrefetchLoader(
        adapter, batch_size, shuffle=split == "train",
        drop_last=split == "train", collate=collate_videos,
        num_workers=cfg.TRAIN.NUM_DATA_WORKERS,
        prefetch_depth=cfg.TPU.PREFETCH_DEPTH,
        device_upload=upload, device=device,
    ), (adapter, ds.idx_to_class)


def get_lmdb_dataset(dataset: str, root: str, db_path, *, flow: bool = False,
                     two_clip: bool = False, **kwargs):
    """Name -> concrete class (reference coclr_classify.py get_data)."""
    table = {
        ("ucf101", False, False): UCF101LMDB,
        ("ucf101", False, True): UCF101LMDB_2CLIP,
        ("ucf101", True, False): UCF101Flow_LMDB,
        ("ucf101", True, True): UCF101Flow_LMDB_2CLIP,
        ("hmdb51", False, False): HMDB51LMDB,
        ("hmdb51", True, False): HMDB51Flow_LMDB,
        ("k400", False, False): K400_LMDB,
        ("k400", False, True): K400_LMDB_2CLIP,
        ("k400", True, False): K400_Flow_LMDB,
        ("k400", True, True): K400_Flow_LMDB_2CLIP,
    }
    key = (dataset, flow, two_clip)
    if key not in table:
        raise ValueError(f"no LMDB dataset for {key}")
    return table[key](root, db_path, **kwargs)
