"""k-nearest-embedding retrieval report (port of the JAX package's
``evaluation/knn.py::k_nearest_embeddings``; reference evaluate.py:353-399).

Embeds the test split (sliding-window averaged) and the train split, runs
top-k retrieval, and appends ``global_retrieval_acc.txt``; and renders
exemplar retrieval figures with ``plotting.py``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
from PIL import Image

from ..ops.pdist import topk_neighbors
from ..utils.device import resolve_device
from ..utils.meters import append_metric_line
from .embed import (cache_embeddings, get_embeddings_and_labels,
                    load_cached_embeddings)
from .plotting import figure_size, image_grid
from .retrieval import TOPK_DEFAULT, topk_retrieval_acc


def k_nearest_embeddings(model, cfg, train_loader, test_loader, *,
                         epoch: Optional[int] = None,
                         cache_dir: Optional[str] = None,
                         is_master_proc: bool = True,
                         device="cuda") -> Dict[int, float]:
    """Full retrieval eval; returns {k: acc} and logs to
    global_retrieval_acc.txt (all four of top-1/5/10/20; the reference's
    line drops top-10/20 to a format-string bug, SURVEY §7.4)."""
    dev = resolve_device(device)
    # cache keyed by split AND epoch: any explicit epoch, including 0, is
    # suffixed; epoch=None keeps the reference's split-only pkl names
    suffix = f"_ep{epoch}" if epoch is not None else ""
    test_cache = os.path.join(cache_dir, f"test_embeddings{suffix}.pkl") \
        if cache_dir else None
    train_cache = os.path.join(cache_dir, f"train_embeddings{suffix}.pkl") \
        if cache_dir else None

    if test_cache and os.path.exists(test_cache):
        test_emb, test_labels, _ = load_cached_embeddings(test_cache)
    else:
        test_emb, test_labels, test_idx = get_embeddings_and_labels(
            model, cfg, test_loader, split="test", verbose=is_master_proc,
            device=dev)
        if test_cache:
            cache_embeddings(test_cache, test_emb, test_labels, test_idx)

    if train_cache and os.path.exists(train_cache):
        train_emb, train_labels, _ = load_cached_embeddings(train_cache)
    else:
        train_emb, train_labels, train_idx = get_embeddings_and_labels(
            model, cfg, train_loader, split="train", verbose=is_master_proc,
            device=dev)
        if train_cache:
            cache_embeddings(train_cache, train_emb, train_labels, train_idx)

    topk = topk_retrieval_acc(test_emb, test_labels, train_emb, train_labels,
                              ks=TOPK_DEFAULT, metric=cfg.LOSS.DIST_METRIC,
                              approx=bool(cfg.TPU.APPROX_TOPK), device=dev)
    if is_master_proc:
        ep = 0 if epoch is None else epoch  # one-shot CLI logs as epoch 0
        line = " ".join(f"top{k}:{v:.4f}" for k, v in sorted(topk.items()))
        print(f"Retrieval epoch {ep}: {line}")
        append_metric_line(cfg.OUTPUT_PATH, "global_retrieval_acc.txt",
                           f"epoch:{ep} {line}")
    return topk


def plot_exemplar_retrievals(test_emb, train_emb, test_samples, train_samples,
                             out_png: str, n_examples: int = 4, k: int = 5,
                             device="cuda") -> Optional[str]:
    """First frames of the top-k retrieved train videos for a few test
    queries (reference evaluate.py:241-275, 376-394), as the JAX function
    draws them: one row a query, the query first, in a grid of
    2 (k + 1) x 2 n_examples inches at 120 dpi."""
    dev = resolve_device(device)
    n_examples = min(n_examples, len(test_samples), len(test_emb))
    k = min(k, len(train_samples))
    if n_examples == 0 or k == 0:
        return None
    idx, _ = topk_neighbors(
        torch.as_tensor(np.asarray(test_emb[:n_examples])).to(dev),
        torch.as_tensor(np.asarray(train_emb)).to(dev), k=k)
    idx = idx.cpu().numpy()

    def first_frame(sample):
        path = os.path.join(sample["video"], "image_00001.jpg")
        if os.path.exists(path):
            with Image.open(path) as im:
                return np.asarray(im.convert("RGB"))
        return np.zeros((64, 64, 3), np.uint8)

    rows = [[first_frame(test_samples[r])]
            + [first_frame(train_samples[idx[r, c]]) for c in range(k)]
            for r in range(n_examples)]
    return image_grid(rows, figure_size(2 * (k + 1), 2 * n_examples, 120),
                      out_png, titles=["query"])
