"""Triplet pretraining fed by the program's own loader from JPEG files.

The store is a UCF-101-layout set of JPEG frames at 320x240 with its
``optical_u`` flow frames (the workload's ``store``: classes x videos,
train and test lengths), written once a checkout from a fixed seed under
the git-ignored ``port_bench/store/`` and reused by later runs. Set-up builds the
program's train loader as ``train/driver.py::train`` builds it
(``build_data_loader("train", ..., triplets=True)`` on the configuration
with the store's paths, the loader's seed and epoch from ``--seed``), and
the step as the in-memory cell does. The first three steps are checked
as there; the clips they were fed are the loader's (its decode, crop and
upload), so the reference follows the program from those clips, and the
decode is checked by itself: a sample of the anchors the loader decoded
during set-up is decoded again by ``reference/decode.py`` from the same
frames and crop box. The window then asks the same loader for batch after
batch, a new loader epoch when one ends, through the program's epoch.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import common
from ..reference import decode
from . import triplet_step

STORE = os.path.join(common.HERE, "store")
DECODE_SAMPLES = 8


# --------------------------------------------------------------------------
# the store (copied from chip_smoke.py::_write_video / make_ucf_dataset at
# commit f61503500a14f114e7bf022962bdb138585f8add)

def _write_video(job) -> None:
    """Frames of one synthetic video: a smooth class-coloured pattern that
    drifts sideways ``speed`` pixels a frame, its mean shifted ``tint`` x
    150 levels towards the class colour."""
    from PIL import Image

    vdir, n, (h, w), color, freq, phase, speed, gray, tint = job
    yy, xx = np.mgrid[0:h, 0:w + speed * n].astype(np.float32)
    wave = np.sin(xx * freq + phase) + 0.5 * np.cos(yy * freq * 1.7 + phase)
    os.makedirs(vdir, exist_ok=True)
    if gray:  # optical_u: one channel, TVL1 layout frame%06d.jpg
        canvas = np.clip(128 + 60 * wave, 0, 255).astype(np.uint8)
        name = "frame{:06d}.jpg"
    else:
        canvas = np.clip(128 + 80 * wave[..., None] * color
                         + tint * 150 * (color - 0.6), 0, 255).astype(np.uint8)
        name = "image_{:05d}.jpg"
    for f in range(n):
        frame = np.ascontiguousarray(canvas[:, speed * f:speed * f + w])
        Image.fromarray(frame).save(os.path.join(vdir, name.format(f + 1)))


def make_store(root: str, syn: dict):
    """Seeded UCF-101-layout store (kenshohara JSON, <label>/<vid>/
    image_%05d.jpg, optical_u/<vid>/frame%06d.jpg for the train videos);
    the last video of each class is a test video. Reused when ``root``
    holds one made from the same ``syn``. -> (jpg root, annotation path,
    optical_u root, seconds spent writing)."""
    jpg, flow = os.path.join(root, "jpg"), os.path.join(root, "optical_u")
    ann_path = os.path.join(root, "annotation.json")
    marker = os.path.join(root, "done.json")
    spec = json.dumps(syn, sort_keys=True)
    if os.path.exists(marker):
        with open(marker) as f:
            if f.read() == spec:
                return jpg, ann_path, flow, 0.0
    t0 = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(syn["seed"])
    labels = [f"class{c:02d}" for c in range(syn["classes"])]
    hw = (syn["height"], syn["width"])
    database, jobs = {}, []
    for label in labels:
        color = rng.uniform(0.2, 1.0, 3).astype(np.float32)
        freq = float(rng.uniform(0.01, 0.05))
        for v in range(syn["videos_per_class"]):
            test = v == syn["videos_per_class"] - 1
            n = syn["test_frames"] if test else syn["train_frames"]
            vid = f"v_{label}_g{v:02d}_c01"
            phase, speed = float(rng.uniform(0, 6.28)), int(rng.integers(1, 5))
            jobs.append((os.path.join(jpg, label, vid), n, hw, color, freq,
                         phase, speed, False, syn["tint"]))
            if syn["flow"] and not test:
                jobs.append((os.path.join(flow, vid), n, hw, color,
                             freq * 1.3, phase, speed, True, 0.0))
            database[vid] = {"subset": "test" if test else "training",
                             "annotations": {"label": label,
                                             "segment": [1, n + 2]}}
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        list(pool.map(_write_video, jobs))
    with open(ann_path, "w") as f:
        json.dump({"labels": labels, "database": database}, f)
    with open(marker, "w") as f:
        f.write(spec)
    return jpg, ann_path, flow, time.perf_counter() - t0


def mean_jpeg_bytes(jpg: str, n: int = 200) -> float:
    """Mean size of the first ``n`` RGB frames of the store."""
    sizes = []
    for d, _, files in sorted(os.walk(jpg)):
        sizes += [os.path.getsize(os.path.join(d, f)) for f in sorted(files)
                  if f.endswith(".jpg")]
        if len(sizes) >= n:
            break
    return float(np.mean(sizes[:n]))


# --------------------------------------------------------------------------
# what the loader decoded

class LoadRecorder:
    """Keeps the first ``keep`` RGB-only clips the reader decodes while
    ``on``: the video, the frame indices, the crop box it drew and the
    clip. Wraps the reader's ``load`` and ``_sample_rrc_box`` on the
    instance; the reader's worker threads each note their own box."""

    def __init__(self, reader, keep: int):
        self.items, self.keep, self.on = [], keep, True
        local, lock = threading.local(), threading.Lock()
        load, draw = reader.load, reader._sample_rrc_box

        def box(*args):
            local.box = draw(*args)
            return local.box

        def recorded(sample, frame_indices, use_channel_ext=True,
                     pos_channel_replace=False):
            local.box = None
            clip = load(sample, frame_indices, use_channel_ext,
                        pos_channel_replace)
            if (self.on and not use_channel_ext and not pos_channel_replace
                    and local.box is not None):
                with lock:
                    if len(self.items) < self.keep:
                        self.items.append((sample["video"],
                                           list(frame_indices), local.box,
                                           clip.copy()))
            return clip

        reader.load, reader._sample_rrc_box = recorded, box


class Setup(triplet_step.Setup):
    def make_feed(self) -> None:
        from video_similarity_search_tpu_torch.data import build_data_loader

        ctx, cfg = self.ctx, self.cfg
        syn = dict(ctx.workload["traffic_params"]["store"])
        syn.update(ctx.scale.get("store", {}))
        root = os.path.join(STORE, ctx.scale.get("store_name", "ucf_synth"))
        jpg, ann, flow, write_s = make_store(root, syn)
        cfg.merge_from_list(["DATASET.VID_PATH", jpg,
                             "DATASET.ANNOTATION_PATH", ann,
                             "DATASET.OPTICAL_U_PATH", flow])
        self.store_info = {"store_write_s": write_s,
                           "mean_jpeg_bytes": mean_jpeg_bytes(jpg)}
        self.loader, (dataset, _) = build_data_loader(
            "train", cfg, True, triplets=True, shard_index=0, num_shards=1,
            batch_size=cfg.TRAIN.BATCH_SIZE, device=ctx.device)
        # the reader's crop boxes and channel replacements, from the seed
        dataset.reader.rng = np.random.default_rng(ctx.seed + 3)
        self.recorder = LoadRecorder(dataset.reader, DECODE_SAMPLES)
        self.loader.seed = ctx.seed
        self.epoch = 0
        self.loader.set_epoch(self.epoch)
        self.it = iter(self.loader)
        self.fed = []

    def next_batch(self) -> dict:
        """The loader's next batch, a new loader epoch when one ends."""
        for _ in range(2):
            try:
                return next(self.it)
            except StopIteration:
                self.epoch += 1
                self.loader.set_epoch(self.epoch)
                self.it = iter(self.loader)
        raise RuntimeError("the train loader yields no batch")

    def check_batches(self):
        for _ in range(triplet_step.CHECK_STEPS):
            b = self.next_batch()
            self.fed.append({**{v: torch.as_tensor(b[v]).cpu().clone()
                                for v in self.views},
                             "targets": np.asarray(b["targets"])})
            yield b
        self.recorder.on = False

    def warm_batches(self):
        for _ in range(triplet_step.WARM_STEPS):
            yield self.next_batch()

    def window_source(self, i: int) -> dict:
        return self.next_batch()

    def reference_batches(self, half: bool) -> list:
        out = []
        for b in self.fed:
            keep = self.b // 2 if half else self.b
            t = b["targets"]
            out.append({
                **{v: b[v][:keep].to(self.ctx.device) for v in self.views},
                "targets": torch.as_tensor(np.concatenate(
                    [t[:keep], t[self.b:self.b + keep]]),
                    device=self.ctx.device)})
        return out

    def close(self) -> None:
        """Stop the loader's producer and wait for it."""
        self.it.close()
        live = self.loader._live
        if live is not None:
            live[0].set()
            live[1].join(timeout=60)

    def decode_gap(self, shift: int = 0) -> float:
        """Mean |program - reference| in levels over the sampled clips;
        ``shift`` pairs each clip with the reference of the next one (a
        fault, read to set the limit)."""
        items = self.recorder.items
        size = int(self.cfg.DATA.SAMPLE_SIZE)
        gaps = []
        for k, (video, frames, box, clip) in enumerate(items):
            other = items[(k + shift) % len(items)]
            ref = decode.decode_clip(other[0], other[1], other[2], size)
            gaps.append(float(np.abs(clip.astype(np.int16)
                                     - ref.astype(np.int16)).mean()))
        return max(gaps)


def run(ctx: common.Ctx) -> dict:
    s = Setup(ctx)
    try:
        w = s.window()
    finally:
        s.close()
    peak = (torch.cuda.max_memory_allocated(ctx.device)
            if ctx.device.type == "cuda" else 0)
    s.release()
    numbers = triplet_step.compare(s.checked,
                                   s.reference(picks=s.checked["picks"]))
    numbers["decode_gap"] = s.decode_gap()
    extra = None
    if ctx.trace:
        extra = {"clips_per_step": w["clips"],
                 **common.outside(w["win"], w["elapsed_s"])}
    return {"attempted": w["steps"], "failed": 0, "peak": peak,
            "e2e": {"fed_train_clips_per_s": w["train_clips_per_s"],
                    "setup_s": w["setup_s"]},
            "numbers": numbers, "window": w, "trace_extra": extra,
            "info": {"percentiles": w["percentiles"],
                     "checked_losses": s.checked["loss"],
                     "loader_epochs": s.epoch + 1, **s.store_info}}


def calibrate(ctx: common.Ctx, control: bool) -> dict:
    """As ``triplet_step.calibrate``, with the decode's readings: the
    program's, and with ``control`` each clip held to the next clip's
    reference (a fault)."""
    s = Setup(ctx, warm=False)
    s.close()
    s.release()
    out = triplet_step.readings(s, control)
    out["program"]["decode_gap"] = s.decode_gap()
    if control:
        out["other_clip"] = {"decode_gap": s.decode_gap(shift=1)}
    return out
