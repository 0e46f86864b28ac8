"""Pairwise-distance ops (port of the JAX package's ``ops/pdist.py``).

Plain PyTorch on whatever device the inputs lie on. Large banks are
processed in row tiles so the full N x M matrix never materializes. These
are also the plain versions the CUDA 1-NN kernel (``ops/fused_knn.py``) is
held against: float32 matmuls, which cuBLAS runs in IEEE float32 while
``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's default,
and what ``train/steps.py::make_embed_step`` sets; ROADMAP hazard H3).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_EPS = 1e-12
_INF = float("inf")


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(_EPS)


def pairwise_distance(x: torch.Tensor, y: Optional[torch.Tensor] = None,
                      metric: str = "cosine",
                      self_mask: bool = False) -> torch.Tensor:
    """Full (N, M) distance matrix; ``self_mask=True`` sets the diagonal to
    +inf for self-query exclusion (reference evaluate.py:215-222)."""
    xp, yp, y_sq = _prep(x, x if y is None else y, metric)
    d = _tile_dist(xp, yp, y_sq, metric)
    return _mask_own(d, 0) if self_mask else d


def _prep(x: torch.Tensor, y: torch.Tensor, metric: str):
    x = x.float()
    y = y.float()
    if metric == "cosine":
        return l2_normalize(x), l2_normalize(y), None
    if metric != "euclidean":
        raise ValueError(f"unknown metric {metric!r}")
    return x, y, (y * y).sum(1)


def _tile_dist(xt: torch.Tensor, y: torch.Tensor, y_sq,
               metric: str) -> torch.Tensor:
    if metric == "cosine":
        return 1.0 - xt @ y.T
    sq = (xt * xt).sum(1)[:, None] + y_sq[None, :] - 2.0 * (xt @ y.T)
    return sq.clamp_min(0.0).sqrt()


def _mask_own(d: torch.Tensor, off: int) -> torch.Tensor:
    """Set d[r, off + r] = inf (a query tile's own rows in the bank)."""
    rows = torch.arange(d.shape[0], device=d.device)
    cols = rows + off
    keep = cols < d.shape[1]
    d[rows[keep], cols[keep]] = _INF
    return d


def nearest_neighbor(x: torch.Tensor, y: Optional[torch.Tensor] = None,
                     metric: str = "cosine", exclude_self: bool = True,
                     tile: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN of each row of x in y (default: in x itself, excluding self).
    Ties go to the lowest index (``torch.argmin`` returns the first
    minimum, as ``jnp.argmin`` does). Returns (indices int64, distances)."""
    self_query = y is None
    xn, yn, y_sq = _prep(x, x if y is None else y, metric)
    idxs, dists = [], []
    for off in range(0, xn.shape[0], tile):
        d = _tile_dist(xn[off:off + tile], yn, y_sq, metric)
        if self_query and exclude_self:
            d = _mask_own(d, off)
        dv, idx = d.min(dim=1)
        idxs.append(idx)
        dists.append(dv)
    if not idxs:
        return (torch.zeros(0, dtype=torch.int64, device=xn.device),
                torch.zeros(0, device=xn.device))
    return torch.cat(idxs), torch.cat(dists)


def _topk_smallest_rows(d: torch.Tensor, k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest entries per row -> (values, indices), ordered by
    (value, index): ties go to the lower index, as ``lax.top_k`` promises
    and ``torch.topk`` does not. ``torch.topk`` finds each row's k-th
    value; every entry below it is taken, then the lowest-index entries
    equal to it fill the row up to k."""
    kth = torch.topk(d, k, dim=1, largest=False, sorted=True).values[:, -1:]
    below = d < kth
    equal = d == kth
    need = k - below.sum(1, keepdim=True)
    take = below | (equal & (equal.cumsum(1) <= need))
    idx = take.nonzero()[:, 1].view(d.shape[0], k)  # ascending index
    vals = d.gather(1, idx)
    vals, order = torch.sort(vals, dim=1, stable=True)
    return vals, idx.gather(1, order)


def topk_neighbors(queries: torch.Tensor, bank: torch.Tensor, k: int,
                   metric: str = "cosine", exclude_self: bool = False,
                   tile: int = 512, approx: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k nearest rows of ``bank`` for each query (tiled over queries);
    exact, with ties to the lower index. Returns (indices (N,k) int64,
    values (N,k)). A bank smaller than k returns every bank row, padded by
    repeating the farthest neighbor (JAX ``ops/pdist.py:156-173``)."""
    if approx:
        raise NotImplementedError(
            "approx top-k (TPU approx_min_k) has no exact counterpart here: "
            "not ported yet (ROADMAP.md, queue 1, 'approximate top-k')")
    qn, bn, b_sq = _prep(queries, bank, metric)
    k_eff = min(k, bn.shape[0])
    idxs, vals = [], []
    for off in range(0, qn.shape[0], tile):
        d = _tile_dist(qn[off:off + tile], bn, b_sq, metric)
        if exclude_self:
            d = _mask_own(d, off)
        dv, idx = _topk_smallest_rows(d, k_eff)
        if k_eff < k:
            idx = torch.cat([idx, idx[:, -1:].expand(-1, k - k_eff)], 1)
            dv = torch.cat([dv, dv[:, -1:].expand(-1, k - k_eff)], 1)
        idxs.append(idx)
        vals.append(dv)
    if not idxs:
        return (torch.zeros(0, k, dtype=torch.int64, device=qn.device),
                torch.zeros(0, k, device=qn.device))
    return torch.cat(idxs), torch.cat(vals)
