"""DBSCAN and OPTICS (``cluster_method="dbscan"``) with the cosine metric,
on the device and without scikit-learn (the JAX package's ``fit_cluster``
calls ``sklearn.cluster.DBSCAN`` / ``OPTICS``, clustering/cluster_masks.py
of the reference).

Both share one part:

* The radius graph, built in row blocks so that the N x N matrix never
  stands whole: the cosine distance ``1 - a.b`` of L2-normalized float32
  rows, clipped to [0, 2] as ``sklearn.metrics.pairwise.cosine_distances``
  does, and each pair with ``d <= radius`` kept as an edge (a point is its
  own neighbour). TF32 stays off, so the products are IEEE float32.
* A point is core when it has at least ``min_samples`` neighbours, itself
  included. For OPTICS that is its core distance (the ``min_samples``-th
  smallest distance, self included) being at most ``max_eps``.
* The components of the core points over core-core edges, by min-label
  propagation over the edge list (``scatter_reduce("amin")``) and pointer
  jumping, as ``ops/cc.py`` does for its one out-edge per node. A component
  is named by its lowest index; clusters are numbered in the order of
  those indices, which is the order both scikit-learn loops start them in.

The two label rules differ only for a non-core point with a core
neighbour:

* DBSCAN (``dbscan_inner``'s stack expansion, which visits cores in index
  order): it takes the lowest cluster id among its core neighbours.
* OPTICS with ``cluster_optics_dbscan`` amounts to a scan in index order:
  the lowest unprocessed point, if core, starts the next cluster, which
  takes its core component and every still-unprocessed neighbour of it;
  if not core, it is noise. So a non-core point takes the lowest cluster
  id among its core neighbours only if that cluster's lowest index is
  below its own; else its reachability was still infinite when the scan
  reached it, and it is noise (-1) even though a core reaches it later.

Where a pair's distance lies within float32 rounding of the radius, the
two libraries' distance arithmetic may put it on either side; away from
the radius the labels are scikit-learn's, array for array.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.pdist import l2_normalize
from ..utils.device import resolve_device

_BLOCK_ELEMENTS = 1 << 26  # distances a row block holds (256 MiB in fp32)


def radius_graph(x: torch.Tensor, radius: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (src, dst) int64 edges with cosine distance <= ``radius``, both
    directions and the self pairs included, grouped by ``src``."""
    if x.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    xn = l2_normalize(x.float())
    n = xn.shape[0]
    block = max(1, min(n, _BLOCK_ELEMENTS // max(n, 1)))
    src, dst = [], []
    for start in range(0, n, block):
        rows = xn[start:start + block]
        d = (1.0 - rows @ xn.T).clamp_(0.0, 2.0)
        own = torch.arange(rows.shape[0], device=xn.device)
        d[own, own + start] = 0.0
        r, c = (d <= radius).nonzero(as_tuple=True)
        src.append(r + start)
        dst.append(c)
    return torch.cat(src), torch.cat(dst)


def _core_clusters(n: int, src: torch.Tensor, dst: torch.Tensor,
                   min_samples: int):
    """-> (core (N,) bool, cluster id of each core point (N,) int64, -1
    elsewhere, lowest index of each cluster (C,))."""
    counts = torch.bincount(src, minlength=n)
    core = counts >= min_samples
    both = core[src] & core[dst]
    cs, cd = src[both], dst[both]
    lab = torch.arange(n, device=src.device)
    while True:
        new = lab.scatter_reduce(0, cs, lab[cd], "amin")
        new = new.scatter_reduce(0, cd, new[cs], "amin")
        new = torch.minimum(new, new[new])  # pointer jumping
        if torch.equal(new, lab):
            break
        lab = new
    first, cid = torch.unique(lab[core], sorted=True, return_inverse=True)
    cluster = torch.full((n,), -1, dtype=torch.int64, device=src.device)
    cluster[core] = cid
    return core, cluster, first


def _border_min_cluster(core, cluster, src, dst) -> torch.Tensor:
    """Lowest cluster id among each non-core point's core neighbours (from
    the core's row, as both loops read a core's neighbourhood), -1 for
    none."""
    n = core.shape[0]
    edge = core[src] & ~core[dst]
    big = torch.iinfo(torch.int64).max
    best = torch.full((n,), big, dtype=torch.int64, device=src.device)
    best = best.scatter_reduce(0, dst[edge], cluster[src[edge]], "amin")
    return torch.where(best == big, torch.full_like(best, -1), best)


def dbscan(x, eps: float = 0.14, min_samples: int = 2,
           device="cuda") -> torch.Tensor:
    """Labels (N,) int64 of ``sklearn.cluster.DBSCAN(eps, min_samples,
    metric="cosine")``; -1 marks noise."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    src, dst = radius_graph(x, eps)
    core, cluster, _ = _core_clusters(x.shape[0], src, dst, min_samples)
    return torch.where(core, cluster,
                       _border_min_cluster(core, cluster, src, dst))


def optics_dbscan(x, min_samples: int = 3, max_eps: float = 0.2,
                  device="cuda") -> torch.Tensor:
    """Labels (N,) int64 of ``sklearn.cluster.OPTICS(min_samples, max_eps,
    cluster_method="dbscan", metric="cosine")`` (its ``eps`` defaults to
    ``max_eps``); -1 marks noise."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    src, dst = radius_graph(x, max_eps)
    core, cluster, first = _core_clusters(x.shape[0], src, dst, min_samples)
    border = _border_min_cluster(core, cluster, src, dst)
    index = torch.arange(x.shape[0], device=dev)
    # border -1 reads the sentinel past the last cluster: never reached
    lowest = torch.cat([first, first.new_full((1,), x.shape[0])])
    reached = lowest[border] < index
    return torch.where(core, cluster, torch.where(reached, border, -1))
