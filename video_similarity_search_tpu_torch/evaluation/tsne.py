"""t-SNE embedding visualization on the device (port of the JAX package's
``evaluation/tsne.py``; reference tsne.py:24-220).

The JAX function takes scikit-learn's PCA and Barnes-Hut t-SNE and draws
with matplotlib; the port has neither. It runs

* the JAX function's class choice (``default_rng(seed).choice``);
* PCA to ``pca_dim`` when the rows are wider: an SVD of the centred rows
  in float64, signs by scikit-learn's ``svd_flip`` (the largest entry of
  each component positive);
* t-SNE in torch with scikit-learn's schedule for ``TSNE(n_components=2,
  perplexity, init="pca")`` (sklearn/manifold/_t_sne.py): P from the
  ``3 * perplexity + 1`` nearest neighbours by euclidean distance (each
  row's precision found by ``_binary_search_perplexity``'s bisection to
  the perplexity, then P + P^T normalized), the PCA init scaled to a first
  column std of 1e-4, ``learning_rate="auto"`` (max(N / 48, 50)), early
  exaggeration 12 for 250 iterations at momentum 0.5, then 750 at 0.8,
  each phase with fresh gains (+0.2 / x0.8, at least 0.01) and a progress
  check every 50 iterations;
* a scatter coloured by class (``plotting.py``, 10 x 8 inches at 150 dpi).

The one deliberate difference: the repulsive term of the gradient and the
normalization Z are exact (dense, in row blocks), where Barnes-Hut
approximates them at angle 0.5. With float rounding, the map is therefore
not element-equal to scikit-learn's; the tests hold it by its final KL
divergence and its trustworthiness instead.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.pdist import topk_neighbors
from ..utils.device import resolve_device
from .plotting import figure_size, scatter_classes

EXAGGERATION = 12.0
EXPLORATION_ITERS = 250  # sklearn TSNE._EXPLORATION_MAX_ITER
MAX_ITER = 1000
CHECK_EVERY = 50  # sklearn TSNE._N_ITER_CHECK
ITERS_WITHOUT_PROGRESS = 300
MIN_GAIN = 0.01
MIN_GRAD_NORM = 1e-7
PERPLEXITY_STEPS = 100  # sklearn _utils._binary_search_perplexity
PERPLEXITY_TOL = 1e-5
_F32_TINY = float(np.finfo(np.float32).tiny)
_DBL_EPS = float(np.finfo(np.float64).eps)
_BLOCK_ELEMENTS = 1 << 24  # pair terms a row block of the gradient holds


def choose_classes(labels: np.ndarray, n_classes: int, seed: int
                   ) -> np.ndarray:
    """The JAX function's draw of the classes to plot."""
    rng = np.random.default_rng(seed)
    uniq = np.unique(labels)
    return rng.choice(uniq, size=min(n_classes, len(uniq)), replace=False)


def pca(x: torch.Tensor, n_components: int) -> torch.Tensor:
    """Projection of the centred rows on their first ``n_components``
    principal axes, in float64, scikit-learn's ``PCA.fit_transform`` up to
    its solver's rounding."""
    xc = x.double() - x.double().mean(0)
    _, _, vt = torch.linalg.svd(xc, full_matrices=False)
    vt = vt[:n_components]
    pick = vt.abs().argmax(1)
    signs = torch.sign(vt[torch.arange(vt.shape[0], device=vt.device), pick])
    return xc @ (vt * signs[:, None]).T


def conditional_p(d2: torch.Tensor, perplexity: float) -> torch.Tensor:
    """Each row's conditional P over its neighbours (float64), by
    ``_binary_search_perplexity``'s bisection of the precision beta."""
    d2 = d2.double()
    n = d2.shape[0]
    dev = d2.device
    beta = torch.ones(n, dtype=torch.float64, device=dev)
    lo = torch.full_like(beta, -math.inf)
    hi = torch.full_like(beta, math.inf)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    p_out = torch.zeros_like(d2)
    desired = math.log(perplexity)
    for _ in range(PERPLEXITY_STEPS):
        p = torch.exp(-d2 * beta[:, None])
        s = p.sum(1)
        s = torch.where(s == 0.0, torch.full_like(s, 1e-8), s)
        p = p / s[:, None]
        diff = torch.log(s) + beta * (d2 * p).sum(1) - desired
        p_out = torch.where(active[:, None], p, p_out)
        move = active & (diff.abs() > PERPLEXITY_TOL)
        up = diff > 0.0
        lo = torch.where(move & up, beta, lo)
        hi = torch.where(move & ~up, beta, hi)
        stepped = torch.where(
            up, torch.where(hi == math.inf, beta * 2.0, (beta + hi) / 2.0),
            torch.where(lo == -math.inf, beta / 2.0, (beta + lo) / 2.0))
        beta = torch.where(move, stepped, beta)
        active = move
    return p_out


def joint_p(x: torch.Tensor, perplexity: float
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Symmetric joint P over the kNN graph -> (rows, cols, values
    float32), as ``_joint_probabilities_nn`` builds it."""
    n = x.shape[0]
    k = min(n - 1, int(3.0 * perplexity + 1))
    idx, dist = topk_neighbors(x, x, k, metric="euclidean",
                               exclude_self=True)
    cond = conditional_p(dist * dist, perplexity)  # squared, as sklearn
    rows = torch.arange(n, device=x.device).repeat_interleave(k)
    cols = idx.reshape(-1)
    key = torch.cat([rows * n + cols, cols * n + rows])  # P + P^T
    key, slot = torch.unique(key, sorted=True, return_inverse=True)
    vals = torch.zeros(key.shape[0], dtype=torch.float64, device=x.device)
    vals.index_add_(0, slot, cond.reshape(-1).repeat(2))
    vals = vals / vals.sum().clamp_min(_DBL_EPS)
    return key // n, key % n, vals.float()


def kl_gradient(y: torch.Tensor, rows, cols, p, compute_error: bool
                ) -> Tuple[Optional[float], torch.Tensor]:
    """KL(P || Q) of the map ``y`` (N, 2) and its gradient, with the exact
    repulsive term: grad_i = 4 sum_j (p_ij - q_ij) w_ij (y_i - y_j),
    w_ij = 1 / (1 + |y_i - y_j|^2), q_ij = w_ij / Z."""
    n = y.shape[0]
    block = max(1, min(n, _BLOCK_ELEMENTS // max(n, 1)))
    rep = torch.empty_like(y)
    z = y.new_zeros(())
    for start in range(0, n, block):
        yb = y[start:start + block]
        dx = yb[:, 0:1] - y[None, :, 0]
        dy = yb[:, 1:2] - y[None, :, 1]
        w = 1.0 / (1.0 + dx * dx + dy * dy)
        own = torch.arange(yb.shape[0], device=y.device)
        w[own, own + start] = 0.0
        z = z + w.sum()
        w2 = w * w
        rep[start:start + block, 0] = (w2 * dx).sum(1)
        rep[start:start + block, 1] = (w2 * dy).sum(1)
    diff = y[rows] - y[cols]
    wij = 1.0 / (1.0 + (diff * diff).sum(1))
    att = torch.zeros_like(y).index_add_(0, rows, (p * wij)[:, None] * diff)
    grad = 4.0 * (att - rep / z)
    error = None
    if compute_error:
        q = (wij / z).clamp_min(_F32_TINY)
        error = float((p * torch.log(p.clamp_min(_F32_TINY) / q)).sum())
    return error, grad


def _gradient_descent(y, rows, cols, p, it: int, max_iter: int,
                      momentum: float, learning_rate: float,
                      n_iter_without_progress: int):
    """sklearn ``_gradient_descent``: momentum and per-parameter gains,
    the error every ``CHECK_EVERY`` iterations and at the last."""
    update = torch.zeros_like(y)
    gains = torch.ones_like(y)
    error = best_error = math.inf
    best_iter = i = it
    for i in range(it, max_iter):
        check = (i + 1) % CHECK_EVERY == 0
        err, grad = kl_gradient(y, rows, cols, p,
                                check or i == max_iter - 1)
        if err is not None:
            error = err
        inc = update * grad < 0.0
        gains = torch.where(inc, gains + 0.2, gains * 0.8).clamp_min_(MIN_GAIN)
        grad = grad * gains
        update = momentum * update - learning_rate * grad
        y = y + update
        if check:
            grad_norm = float(torch.linalg.vector_norm(grad))
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > n_iter_without_progress:
                break
            if grad_norm <= MIN_GRAD_NORM:
                break
    return y, error, i


def tsne(x, perplexity: float = 30.0, device="cuda"
         ) -> Tuple[torch.Tensor, float, int]:
    """2-D t-SNE of the rows of ``x`` -> (map (N, 2) float32, final KL
    divergence, last iteration), as ``TSNE(n_components=2, perplexity,
    init="pca")`` runs it, with the exact gradient."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32).to(dev)
    n = x.shape[0]
    if perplexity >= n:
        raise ValueError(f"perplexity ({perplexity}) must be less than "
                         f"n_samples ({n})")
    rows, cols, p = joint_p(x, perplexity)
    y = pca(x, 2).float()
    y = y / y[:, 0].std(unbiased=False) * 1e-4
    lr = max(n / EXAGGERATION / 4.0, 50.0)
    y, kl, it = _gradient_descent(y, rows, cols, p * EXAGGERATION, 0,
                                  EXPLORATION_ITERS, 0.5, lr,
                                  EXPLORATION_ITERS)
    y, kl, it = _gradient_descent(y, rows, cols, p, it + 1, MAX_ITER, 0.8,
                                  lr, ITERS_WITHOUT_PROGRESS)
    return y, kl, it


def tsne_plot(embeddings: np.ndarray, labels: np.ndarray,
              out_path: str = "tsne.png", n_classes: int = 20,
              pca_dim: int = 50, perplexity: float = 30.0, seed: int = 0,
              idx_to_class: Optional[dict] = None, device="cuda") -> str:
    """PCA -> t-SNE-2D of a random subset of classes, scatter saved to
    ``out_path`` (the JAX function's arguments, and ``device``)."""
    dev = resolve_device(device)
    embeddings, labels = np.asarray(embeddings), np.asarray(labels)
    chosen = choose_classes(labels, n_classes, seed)
    mask = np.isin(labels, chosen)
    emb, lab = embeddings[mask], labels[mask]
    x = torch.as_tensor(emb, dtype=torch.float32).to(dev)
    if emb.shape[1] > pca_dim:
        x = pca(x, min(pca_dim, emb.shape[0])).float()
    pts, _, _ = tsne(x, perplexity=min(perplexity, len(emb) - 1), device=dev)
    names = [idx_to_class.get(int(c), str(c)) if idx_to_class else str(c)
             for c in chosen]
    return scatter_classes(pts.cpu().numpy(), lab, chosen, names,
                           figure_size(10, 8, 150), out_path,
                           title="t-SNE of clip embeddings")
