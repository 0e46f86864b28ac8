"""FINCH: parameter-free hierarchical clustering by first-neighbor relations
(port of the JAX package's ``cluster/finch.py``; reference
clustering/finch.py:108-178, Sarfraz et al., CVPR 2019).

  * level 0 over more than ``DENSE_THRESHOLD`` points: exact 1-NN through
    ``ops/fused_knn.py`` (the CUDA kernel on the card) and the sparse
    connected components of ``ops/cc.py``;
  * every other level: the dense clustering equation A = (A+I)(A+I)^T on a
    (C, C) distance matrix, as direct + reverse + shared-first-neighbor
    edges, with min-label propagation and pointer jumping;
  * group means: ``ops/segment.segment_mean``.

The JAX ``lax.while_loop``s become host loops. As in the JAX package, the
``ensure_early_exit`` min_sim of a sparse level 0 is taken over direct
edges only.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.cc import connected_components
from ..ops.fused_knn import nearest_neighbor_fused
from ..ops.pdist import pairwise_distance
from ..ops.segment import segment_mean
from ..utils.device import resolve_device

DENSE_THRESHOLD = 20000

_INT32_MAX = torch.iinfo(torch.int32).max


def _dense_level(mat: torch.Tensor, min_sim: float, metric: str = "cosine",
                 use_min_sim: bool = False):
    """One FINCH level on a dense (C, C) distance matrix.

    Returns (labels, nn_idx, max_adj_edge_dist)."""
    d = pairwise_distance(mat, metric=metric)
    c = d.shape[0]
    eye = torch.eye(c, dtype=torch.bool, device=d.device)
    nn = d.masked_fill(eye, 1e12).argmin(dim=1)  # ref clust_rank fills 1e12

    cols = torch.arange(c, device=d.device)
    direct = cols[None, :] == nn[:, None]
    adj = (direct | direct.T | (nn[:, None] == nn[None, :])) & ~eye
    max_edge = torch.where(adj, d, float("-inf")).max()
    if use_min_sim:
        adj &= d <= min_sim

    # int32 labels halve the (C, C) temporaries of the propagation
    labels = torch.arange(c, dtype=torch.int32, device=d.device)
    while True:
        neigh = torch.where(adj, labels[None, :], _INT32_MAX).amin(dim=1)
        new = torch.minimum(labels, neigh)
        new = torch.minimum(new, new[new.long()])
        if torch.equal(new, labels):
            break
        labels = new
    return labels.long(), nn, max_edge


def _sparse_level0(data: torch.Tensor, metric: str):
    """Large-N first level: 1-NN + sparse CC (no min_sim at level 0)."""
    nn, dist = nearest_neighbor_fused(data, metric=metric)
    labels = connected_components(nn)
    return labels, nn, dist.max()  # direct edges only (module docstring)


def _compact(labels: np.ndarray) -> Tuple[np.ndarray, int]:
    uniq, dense = np.unique(labels, return_inverse=True)
    return dense.astype(np.int64), len(uniq)


def _as_device_f32(data, dev: torch.device) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        return data.to(dev, torch.float32)
    return torch.from_numpy(np.asarray(data, np.float32)).to(dev)


def FINCH(data, initial_rank=None, req_clust: Optional[int] = None,
          distance: str = "cosine", ensure_early_exit: bool = True,
          verbose: bool = True, device="cuda",
          ) -> Tuple[np.ndarray, List[int], Optional[np.ndarray]]:
    """Same signature/returns as the reference FINCH (clustering/finch.py:108):
    ``c`` (N, P) partition labels, ``num_clust`` per partition, ``req_c``.

    ``initial_rank`` (precomputed first neighbors) is honored for level 0.
    """
    dev = resolve_device(device)
    data = _as_device_f32(data, dev)
    n = data.shape[0]

    # ---- level 0 over raw points -------------------------------------
    if initial_rank is not None:
        nn0 = torch.as_tensor(np.asarray(initial_rank, np.int64), device=dev)
        labels0 = connected_components(nn0)
        min_sim_val = None  # no distances available (ref sets orig_dist=[])
    elif n <= DENSE_THRESHOLD:
        labels0, _, max_edge = _dense_level(data, 0.0, metric=distance,
                                            use_min_sim=False)
        min_sim_val = float(max_edge)
    else:
        labels0, _, max_edge = _sparse_level0(data, distance)
        min_sim_val = float(max_edge)
    if not ensure_early_exit:
        min_sim_val = None

    c_, num0 = _compact(labels0.cpu().numpy())
    mat = segment_mean(data, torch.from_numpy(c_).to(dev), num0)

    if verbose:
        print(f"Partition 0: {num0} clusters")

    c = c_[:, None]
    num_clust = [num0]
    k = 1
    while True:
        use_ms = min_sim_val is not None
        labels, _, _ = _dense_level(
            mat, float(np.float32(min_sim_val if use_ms else 0.0)),
            metric=distance, use_min_sim=use_ms)
        u, num_curr = _compact(labels.cpu().numpy())
        c_ = u[c_]
        mat = segment_mean(data, torch.from_numpy(c_).to(dev), num_curr)

        exit_clust = num_clust[-1] - num_curr
        if num_curr == 1 or exit_clust < 1:
            break
        num_clust.append(num_curr)
        c = np.column_stack((c, c_))
        if verbose:
            print(f"Partition {k}: {num_curr} clusters")
        k += 1

    req_c = None
    if req_clust is not None:
        if req_clust in num_clust:
            req_c = c[:, num_clust.index(req_clust)]
        elif req_clust > num_clust[0]:
            # more clusters requested than the finest partition has: the
            # reference crashes here (clustering/finch.py:170 indexes an
            # empty candidate list); return the finest partition with a
            # warning instead
            print(f"FINCH: req_clust={req_clust} exceeds the finest "
                  f"partition ({num_clust[0]} clusters); returning it")
            req_c = c[:, 0]
        else:
            candidates = [i for i, v in enumerate(num_clust) if v >= req_clust]
            req_c = _req_numclust(c[:, candidates[-1]], data, req_clust,
                                  distance)
    return c, num_clust, req_c


def _req_numclust(base: np.ndarray, data: torch.Tensor, req_clust: int,
                  distance: str):
    """Merge the closest cluster pair one at a time down to ``req_clust``
    (reference clustering/finch.py:85-105)."""
    c_, num = _compact(base)
    while num > req_clust:
        mat = segment_mean(data, torch.from_numpy(c_).to(data.device), num)
        d = pairwise_distance(mat, metric=distance).cpu().numpy()
        np.fill_diagonal(d, np.inf)
        nn = d.argmin(1)
        # adjacency of the level; merge only the single closest edge
        i = int(np.argmin(d.min(1)))
        j = int(nn[i])
        merged = np.where(c_ == max(i, j), min(i, j), c_)
        c_, num = _compact(merged)
    return c_
