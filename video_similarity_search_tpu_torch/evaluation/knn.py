"""k-nearest-embedding retrieval report (port of the JAX package's
``evaluation/knn.py::k_nearest_embeddings``; reference evaluate.py:353-399).

Embeds the test split (sliding-window averaged) and the train split, runs
top-k retrieval, and appends ``global_retrieval_acc.txt``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from ..utils.device import resolve_device
from ..utils.meters import append_metric_line
from .embed import (cache_embeddings, get_embeddings_and_labels,
                    load_cached_embeddings)
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
