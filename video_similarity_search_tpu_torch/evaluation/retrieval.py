"""Cosine-kNN retrieval protocols (port of the JAX package's
``evaluation/retrieval.py``), all on ``ops/pdist.topk_neighbors``:

  * native protocol: top-k label hit for k in {1,5,10,20}
    (reference evaluate.py:208-307, get_distance_matrix/get_topk_acc);
  * CoCLR protocol: center + L2-normalize, then top-k with
    k in {1,5,10,20,50} (reference coclr_classify.py:784-810);
  * IIC protocol: mean of the clip features, then cosine top-k
    (reference iic_retrieve_clips.py:275-314).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..ops.pdist import pairwise_distance, topk_neighbors
from ..utils.device import resolve_device

TOPK_DEFAULT = (1, 5, 10, 20)  # reference evaluate.py:287-307
TOPK_EXTENDED = (1, 5, 10, 20, 50)  # coclr / iic protocols


def _to(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32)).to(dev)


def get_distance_matrix(test_emb: np.ndarray, train_emb: np.ndarray,
                        metric: str = "cosine", same_set: bool = False,
                        device="cuda") -> np.ndarray:
    """Full distance matrix with self-query exclusion when ``same_set``
    (reference evaluate.py:208-223)."""
    dev = resolve_device(device)
    return pairwise_distance(_to(test_emb, dev), _to(train_emb, dev),
                             metric=metric, self_mask=same_set).cpu().numpy()


def topk_retrieval_acc(query_emb: np.ndarray, query_labels: np.ndarray,
                       bank_emb: np.ndarray, bank_labels: np.ndarray, *,
                       ks: Sequence[int] = TOPK_DEFAULT,
                       metric: str = "cosine",
                       exclude_self: bool = False,
                       approx: bool = False,
                       device="cuda") -> Dict[int, float]:
    """Top-k label-hit accuracy: a video counts as correct at k if ANY of
    its k nearest bank entries shares its label
    (reference get_topk_acc, evaluate.py:287-307)."""
    dev = resolve_device(device)
    idx, _ = topk_neighbors(_to(query_emb, dev), _to(bank_emb, dev),
                            k=max(ks), metric=metric,
                            exclude_self=exclude_self, approx=approx)
    neighbor_labels = np.asarray(bank_labels)[idx.cpu().numpy()]  # (N, kmax)
    hit = neighbor_labels == np.asarray(query_labels)[:, None]
    return {k: float(np.mean(np.any(hit[:, :k], axis=1))) for k in ks}


def coclr_retrieval_acc(test_emb: np.ndarray, test_labels: np.ndarray,
                        train_emb: np.ndarray, train_labels: np.ndarray, *,
                        ks: Sequence[int] = TOPK_EXTENDED,
                        device="cuda") -> Dict[int, float]:
    """CoCLR-style: center both sets by the train mean, L2-normalize, then
    similarity top-k (reference coclr_classify.py:784-810)."""
    center = train_emb.mean(0, keepdims=True)
    te = test_emb - center
    tr = train_emb - center
    te = te / np.maximum(np.linalg.norm(te, axis=1, keepdims=True), 1e-12)
    tr = tr / np.maximum(np.linalg.norm(tr, axis=1, keepdims=True), 1e-12)
    return topk_retrieval_acc(te, test_labels, tr, train_labels, ks=ks,
                              device=device)


def iic_retrieval_acc(test_feats: np.ndarray, test_labels: np.ndarray,
                      train_feats: np.ndarray, train_labels: np.ndarray, *,
                      ks: Sequence[int] = TOPK_EXTENDED,
                      device="cuda") -> Dict[int, float]:
    """IIC protocol: features are (N, n_clips, D); mean over clips then
    cosine top-k (reference iic_retrieve_clips.py:275-314)."""
    if test_feats.ndim == 3:
        test_feats = test_feats.mean(1)
    if train_feats.ndim == 3:
        train_feats = train_feats.mean(1)
    return topk_retrieval_acc(test_feats, test_labels, train_feats,
                              train_labels, ks=ks, device=device)


def local_batch_retrieval_acc(emb: np.ndarray, labels: np.ndarray, *,
                              ks: Sequence[int] = (1, 5),
                              metric: str = "cosine",
                              device="cuda") -> Dict[int, float]:
    """Within-batch retrieval (VAL.METRIC='local_batch',
    reference validation.py:96-130): each embedding queries the rest of
    its own batch."""
    return topk_retrieval_acc(emb, labels, emb, labels, ks=ks, metric=metric,
                              exclude_self=True, device=device)
