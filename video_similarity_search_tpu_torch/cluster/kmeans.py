"""k-means and spherical k-means as Lloyd iterations in PyTorch (port of
the JAX package's ``cluster/kmeans.py``; the reference's sklearn
``KMeans(n_init=10)`` and spherecluster ``SphericalKMeans``,
clustering/cluster_masks.py:66-76).

Each iteration assigns every point to its nearest centre through the
squared-euclidean expansion ``(|x|^2 + |c|^2) - 2 x.c`` (one (N, K)
product, the terms summed in the JAX function's order), ``argmin`` with the
first index winning ties, and moves each centre to the mean of its points;
a centre that got no point stays where it was. The ``n_init`` restarts run
one after another and the lowest inertia wins (the first on a tie): a
batch of restarts would hold ``n_init`` (N, K) matrices at once, ~10 GB at
240,000 x 1,000 x 10.

The initial centres are ``k`` distinct points drawn per restart
(``jax.random.choice`` in the JAX package). Its draws cannot be reproduced
from a seed (ROADMAP hazard H2), so ``init_idx`` takes them, and otherwise
they come from a ``torch.Generator`` seeded from ``seed``. The product is
IEEE float32: TF32 stays off (hazard H3).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.pdist import l2_normalize
from ..ops.segment import segment_count, segment_mean
from ..utils.device import resolve_device


def _sq_dist(data: torch.Tensor, x_sq: torch.Tensor,
             centers: torch.Tensor) -> torch.Tensor:
    """(N, K) squared distances, summed as the JAX function sums them."""
    c_sq = (centers * centers).sum(1)
    return (x_sq[:, None] + c_sq[None, :]).sub_(data @ centers.T, alpha=2.0)


def _lloyd(data: torch.Tensor, centers: torch.Tensor, iters: int,
           spherical: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (labels (N,), inertia) after ``iters`` Lloyd updates."""
    x_sq = (data * data).sum(1)
    k = centers.shape[0]
    for _ in range(iters):
        assign = torch.argmin(_sq_dist(data, x_sq, centers), dim=1)
        moved = segment_mean(data, assign, k)
        kept = segment_count(assign, k) > 0
        centers = torch.where(kept[:, None], moved, centers)
        if spherical:
            centers = l2_normalize(centers)
    d = _sq_dist(data, x_sq, centers)
    assign = torch.argmin(d, dim=1)
    return assign, d.gather(1, assign[:, None]).sum()


def _init_indices(n: int, k: int, generator: torch.Generator) -> torch.Tensor:
    """``k`` distinct points (with repeats only when ``n < k``)."""
    if n < k:
        return torch.randint(0, n, (k,), generator=generator,
                             device=generator.device)
    return torch.randperm(n, generator=generator,
                          device=generator.device)[:k]


def kmeans(data, k: int, n_init: int = 10, max_iter: int = 50,
           spherical: bool = False, l2normalize: bool = False, seed: int = 0,
           init_idx=None, device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (labels (N,) int64, inertia) on ``device``. ``l2normalize`` is the
    reference's k-means preprocessing (cluster_masks.py:30-34);
    ``spherical`` normalizes the data and renormalizes the centres every
    iteration. ``init_idx`` (n_init, k): each restart's initial points."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    if not isinstance(data, torch.Tensor):
        data = torch.from_numpy(np.asarray(data, np.float32))
    data = data.to(dev, torch.float32)
    if l2normalize or spherical:
        data = l2_normalize(data)
    n = data.shape[0]
    generator = None
    if init_idx is None:
        generator = torch.Generator(device=dev).manual_seed(int(seed))
    else:
        init_idx = torch.as_tensor(np.asarray(init_idx), device=dev).long()
        if tuple(init_idx.shape) != (n_init, k):
            raise ValueError(f"init_idx {tuple(init_idx.shape)} != (n_init, "
                             f"k) = {(n_init, k)}")
    best_labels = best_inertia = None
    for r in range(n_init):
        idx = (init_idx[r] if generator is None
               else _init_indices(n, k, generator))
        centers = data[idx]
        if spherical:
            centers = l2_normalize(centers)
        labels, inertia = _lloyd(data, centers, max_iter, spherical)
        if best_inertia is None:
            best_labels, best_inertia = labels, inertia
        else:  # on the device: the host does not wait for each restart
            better = inertia < best_inertia
            best_labels = torch.where(better, labels, best_labels)
            best_inertia = torch.where(better, inertia, best_inertia)
    return best_labels, best_inertia


def spherical_kmeans(data, k: int, n_init: int = 10, max_iter: int = 50,
                     seed: int = 0, init_idx=None, device="cuda"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``kmeans(spherical=True)``: cosine k-means on the unit sphere."""
    return kmeans(data, k, n_init=n_init, max_iter=max_iter, spherical=True,
                  seed=seed, init_idx=init_idx, device=device)
