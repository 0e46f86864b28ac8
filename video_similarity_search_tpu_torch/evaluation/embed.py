"""Embedding extraction over a dataset (port of the JAX package's
``evaluation/embed.py``; reference ``evaluate.evaluate``, evaluate.py:146-205,
and ``test_evaluate``, the sliding-window mean, evaluate.py:89-143).

``loader`` is any iterable of ``collate_videos``-shaped batches: ``clip``
uint8 (B, T, H, W, C) as numpy or a tensor, ``target``, ``index``,
``window_counts`` and, on a padded ragged batch, ``__size__`` (the real
item count). Batches are moved to the device, normalized there and run
through the embed step; multi-window test videos are averaged into one
embedding per video and padded rows are dropped on the host. A clip
tensor already on the device (the loader's pinned upload) is used where it
is, without a second copy.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..data.augment import normalize_only
from ..train.steps import make_embed_step
from ..utils.device import resolve_device
from ..utils.profiling import span


def _pad_clips(arr, quantum: int) -> Tuple[object, int]:
    """Pad the leading (clip) axis up to a multiple of ``quantum`` by
    repeating the last clip, so the step sees a bounded set of shapes
    (multi-window test batches flatten a variable number of windows)."""
    n = arr.shape[0]
    target = max(quantum, -(-n // quantum) * quantum)
    if n == target:
        return arr, n
    if isinstance(arr, torch.Tensor):
        return torch.cat([arr, arr[-1:].expand(target - n, *arr.shape[1:])]), n
    return np.concatenate([arr, np.repeat(arr[-1:], target - n, axis=0)]), n


def get_embeddings_and_labels(model, cfg, loader, *, split: str = "train",
                              batch_pad: Optional[int] = None,
                              verbose: bool = True, device="cuda"):
    """-> (embeddings (N, D) np, labels (N,), indices (N,)).

    For 'test' splits each video contributes the mean of its window
    embeddings (reference evaluate.py:120-130). ``model`` is the encoder
    module (moved to ``device``)."""
    dev = resolve_device(device)
    embed = make_embed_step(cfg, model, device=dev)
    dataset = cfg.TRAIN.DATASET
    all_emb, all_labels, all_idx = [], [], []
    start = time.time()
    quantum = batch_pad
    for batch in loader:
        clips = batch["clip"]
        counts = np.asarray(batch["window_counts"])
        n_items = int(batch.get("__size__", len(counts)))
        n_clips = int(np.sum(counts[:n_items]))
        if quantum is None:
            quantum = clips.shape[0]  # first batch is full: its clip count
        clips, _ = _pad_clips(clips, quantum)
        with span("embed.upload"):
            x = torch.as_tensor(clips).to(dev)
        with span("embed.forward"):
            x = normalize_only(x, dataset=dataset)
            emb = embed(x)
        with span("embed.readback"):
            emb = emb[:n_clips].cpu().numpy()

        # collapse windows back to one embedding per video
        if np.any(counts[:n_items] > 1):
            off = 0
            for i in range(n_items):
                cnt = counts[i]
                all_emb.append(emb[off:off + cnt].mean(0))
                all_labels.append(batch["target"][off])
                all_idx.append(batch["index"][off])
                off += cnt
        else:
            all_emb.extend(emb)
            all_labels.extend(batch["target"][:n_clips])
            all_idx.extend(batch["index"][:n_clips])
    if verbose:
        print(f"embedded {len(all_emb)} videos [{split}] "
              f"in {time.time() - start:.1f}s")
    return (np.asarray(all_emb, np.float32),
            np.asarray(all_labels, np.int64),
            np.asarray(all_idx, np.int64))


def cache_embeddings(path: str, embeddings, labels, indices) -> None:
    """pkl cache (reference evaluate.py:310-345)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"embeddings": embeddings, "labels": labels,
                     "indices": indices}, f)


def load_cached_embeddings(path: str):
    """Read a cache this program wrote (pickle: trusted files only)."""
    with open(path, "rb") as f:
        d = pickle.load(f)
    return d["embeddings"], d["labels"], d["indices"]
