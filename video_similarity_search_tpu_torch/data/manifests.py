"""Dataset manifests: annotation parsing -> sample records (the port's
copy of the JAX package's ``data/manifests.py``, which imports no JAX).

Covers the reference annotation parsers (SURVEY §2.2): UCF101/HMDB51
kenshohara-format JSON (datasets/ucf101.py:27-190, datasets/hmdb51.py:9-124)
and the Kinetics frame-path listing (datasets/kinetics.py:54-135), with:
group-aware validation sampling, the ``num_frames = segment[1] - 2``
convention, skipping of videos shorter than ``2 * sample_duration``,
per-channel extension paths (keypoint / salient / optical_u / optical_v,
including the HandStandPushups case fix, datasets/ucf101.py:64-68), and
cluster labels read from ``vid_clusters.txt``.

Divergence note: the reference attaches ``cluster_labels[len(dataset)-1]``
— the label of the *previous* sample (off-by-one, SURVEY §7.4). We attach
the label at the sample's own position; round-trips through our own
``vid_clusters.txt`` are self-consistent either way, and NMI/AMI now
measure the true assignment.
"""

from __future__ import annotations

import itertools
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def kp_img_name_formatter(x: int) -> str:
    return f"image_{x:05d}_kp.jpg"


def salient_img_name_formatter(x: int) -> str:
    return f"image_{x:05d}_sal_fuse.png"


def optical_img_name_formatter(x: int) -> str:
    return f"frame{x:06d}.jpg"


def default_image_name_formatter(x: int) -> str:
    return f"image_{x:05d}.jpg"


def read_cluster_labels(cluster_path: Optional[str]) -> Optional[List[int]]:
    """vid_clusters.txt: one integer per line, unshuffled dataset order
    (written by the iterative-cluster step, reference online_train.py:654-658)."""
    if not cluster_path or not os.path.exists(cluster_path):
        return None
    with open(cluster_path) as f:
        return [int(line.strip()) for line in f if line.strip()]


def write_cluster_labels(cluster_path: str, labels: Sequence[int]) -> None:
    with open(cluster_path, "w") as f:
        for lbl in labels:
            f.write(f"{int(lbl)}\n")


def _fix_handstand(video_id: str) -> str:
    """UCF101 flow dirs use 'HandstandPushups' (lowercase s) while RGB uses
    'HandStandPushups' (reference datasets/ucf101.py:64-67)."""
    parts = video_id.split("_")
    if len(parts) >= 4 and parts[1] == "HandStandPushups":
        return parts[0] + "_HandstandPushups_" + parts[2] + "_" + parts[3]
    return video_id


def _select_video_ids(database: dict, subset: str, split: str,
                      val_sample: Optional[int],
                      rng: np.random.Generator) -> List[str]:
    """Group-aware id selection (reference datasets/ucf101.py:32-48)."""
    groups: Dict[str, List[str]] = {}
    for key, value in database.items():
        if value["subset"] == subset:
            group = "_".join(key.split("_")[:-1])
            groups.setdefault(group, []).append(key)
    if subset == "training" or val_sample is None:
        return list(itertools.chain(*groups.values()))
    ids: List[str] = []
    for name in groups:
        # without replacement, capped at the group size — the reference's
        # np.random.choice default (replace=True, ucf101.py:46) can pick
        # the same video twice per group at val_sample > 1, duplicating
        # val entries (harmless at its default val_sample=1)
        k = min(val_sample, len(groups[name]))
        ids.extend(rng.choice(groups[name], size=k, replace=False).tolist())
    return ids


def load_video_manifest(
    annotation_path: str,
    root_path: str,
    split: str,
    sample_duration: int,
    channel_ext: Optional[Dict[str, str]] = None,
    cluster_path: Optional[str] = None,
    cluster_labels: Optional[Sequence[int]] = None,
    val_sample: Optional[int] = 1,
    seed: int = 0,
    verbose: bool = True,
) -> Tuple[List[dict], Dict[int, str]]:
    """UCF101/HMDB51 JSON -> (samples, idx_to_class).

    ``cluster_labels`` (in-memory, dataset order) overrides the
    ``cluster_path`` file read — on multi-host runs every host computes
    identical labels but only the master writes the file, so the rebuild
    must not depend on reading it back.

    Each sample: {'video', 'num_frames', 'label', <channel keys>,
    'cluster_label'?}. ``channel_ext`` maps extension name -> root path.
    """
    subset = {"train": "training", "val": "validation"}.get(split, "test")
    rng = np.random.default_rng(seed)
    with open(annotation_path) as f:
        data = json.load(f)

    class_to_idx = {label: i for i, label in enumerate(data["labels"])}
    idx_to_class = {i: label for label, i in class_to_idx.items()}

    video_ids = _select_video_ids(data["database"], subset, split, val_sample,
                                  rng)
    if cluster_labels is None:
        cluster_labels = read_cluster_labels(cluster_path)
    channel_ext = channel_ext or {}

    samples: List[dict] = []
    skipped = 0
    for vid in video_ids:
        ann = data["database"][vid]["annotations"]
        label = ann.get("label", "test")
        label_id = class_to_idx.get(label, -1)
        # segment[1] - 2: the kenshohara annotation convention
        # (reference datasets/ucf101.py:164)
        num_frames = ann["segment"][1] - 2
        if num_frames <= 0:
            skipped += 1
            continue
        if num_frames < 2 * sample_duration:
            skipped += 1
            continue
        sample = {
            "video": os.path.join(root_path, label, vid),
            "num_frames": int(num_frames),
            "label": int(label_id),
        }
        for key, ext_root in channel_ext.items():
            if key in ("optical_u", "optical_v"):
                sample[key] = os.path.join(ext_root, _fix_handstand(vid))
            else:
                sample[key] = os.path.join(ext_root, label, vid)
        if cluster_labels is not None:
            sample["cluster_label"] = int(cluster_labels[len(samples)])
        samples.append(sample)

    if verbose:
        print(f"manifest[{split}]: {len(samples)} videos "
              f"({skipped} skipped as too short/empty)")
    return samples, idx_to_class


def load_kinetics_manifest(
    annotation_path: str,
    root_path: str,
    split: str,
    sample_duration: int,
    cluster_path: Optional[str] = None,
    cluster_labels: Optional[Sequence[int]] = None,
    verbose: bool = True,
) -> Tuple[List[dict], Dict[int, str]]:
    """Kinetics frame-path listing -> (samples, idx_to_class).

    The reference (datasets/kinetics.py:54-135) reads per-split csv/txt
    listings of ``<relative frame dir> <num_frames> <label>`` rows; this
    parser accepts that layout (whitespace- or comma-separated), resolving
    paths against ``root_path``.
    """
    path = annotation_path
    cand = os.path.join(annotation_path, f"{split}.csv")
    if os.path.isdir(annotation_path) and os.path.exists(cand):
        path = cand
    if cluster_labels is None:
        cluster_labels = read_cluster_labels(cluster_path)

    def rows(p):
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                parts = line.split(",") if "," in line else line.split()
                if len(parts) >= 3:
                    yield parts[0], int(parts[1]), parts[2]

    # One class list SHARED across splits so train/val agree on label ids
    # (the reference derives labels from a shared annotation,
    # datasets/kinetics.py:98-135; round-1 assigned ids in per-split-file
    # encounter order — unstable when category order differs between
    # splits). Priority: classes.txt next to the listing, else the sorted
    # union of labels over every split file in the directory, else the
    # sorted labels of this file.
    classes: Dict[str, int] = {}
    ann_dir = annotation_path if os.path.isdir(annotation_path) \
        else os.path.dirname(path)
    classes_file = os.path.join(ann_dir, "classes.txt") if ann_dir else ""
    if classes_file and os.path.exists(classes_file):
        with open(classes_file) as f:
            classes = {c.strip(): i
                       for i, c in enumerate(f) if c.strip()}
    else:
        label_set = set()
        split_files = [os.path.join(ann_dir, fn)
                       for fn in sorted(os.listdir(ann_dir))
                       if fn.endswith((".csv", ".txt"))] \
            if ann_dir and os.path.isdir(ann_dir) else [path]
        for sf in split_files or [path]:
            for _, _, label in rows(sf):
                label_set.add(label)
        classes = {c: i for i, c in enumerate(sorted(label_set))}

    samples: List[dict] = []
    skipped = 0
    unknown_labels: Dict[str, int] = {}
    for rel, n_frames, label in rows(path):
        if n_frames < 2 * sample_duration or n_frames <= 0:
            skipped += 1
            continue
        if label not in classes:
            # a stale classes.txt / mismatched split file would otherwise
            # silently poison targets (-1), NMI/AMI, and retrieval top-k
            unknown_labels[label] = unknown_labels.get(label, 0) + 1
        sample = {
            "video": os.path.join(root_path, rel),
            "num_frames": n_frames,
            "label": classes.get(label, -1),
        }
        if cluster_labels is not None:
            sample["cluster_label"] = int(cluster_labels[len(samples)])
        samples.append(sample)
    idx_to_class = {i: c for c, i in classes.items()}
    if unknown_labels:
        print(f"WARNING: kinetics manifest[{split}]: "
              f"{sum(unknown_labels.values())} rows across "
              f"{len(unknown_labels)} labels are ABSENT from the shared "
              f"class index and got label=-1 (stale classes.txt?): "
              f"{sorted(unknown_labels)[:5]}")
    if verbose:
        print(f"kinetics manifest[{split}]: {len(samples)} videos "
              f"({skipped} skipped)")
    return samples, idx_to_class


def get_manifest(dataset: str, **kwargs):
    """Dataset-name dispatch (reference datasets/dataset.py get_data)."""
    if dataset in ("ucf101", "hmdb51"):
        return load_video_manifest(**kwargs)
    if dataset == "kinetics":
        kwargs.pop("channel_ext", None)
        kwargs.pop("val_sample", None)
        kwargs.pop("seed", None)
        return load_kinetics_manifest(**kwargs)
    raise ValueError(f"unknown dataset {dataset!r}")
