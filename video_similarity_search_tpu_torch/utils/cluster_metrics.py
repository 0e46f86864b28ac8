"""NMI and AMI of two labelings, without scikit-learn.

The card's machine has no scikit-learn, and the iterative-cluster step logs
both scores every time it clusters. These follow ``sklearn.metrics``'
``normalized_mutual_info_score`` and ``adjusted_mutual_info_score`` with
``average_method="arithmetic"`` (their defaults) step for step: natural
logs, the same special cases, and the expected mutual information of the
hypergeometric model in log space through ``scipy.special.gammaln``.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
from scipy.special import gammaln


def _entropy(counts: np.ndarray) -> float:
    if counts.size <= 1:
        return 0.0
    pi = counts.astype(np.float64)
    total = pi.sum()
    return float(-np.sum((pi / total) * (np.log(pi) - math.log(total))))


def _mutual_info(a, b) -> Tuple[float, np.ndarray, np.ndarray, int]:
    """MI in nats (sklearn's ``mutual_info_score``) and the marginals."""
    _, ai = np.unique(np.asarray(a), return_inverse=True)
    _, bi = np.unique(np.asarray(b), return_inverse=True)
    ai, bi = ai.ravel().astype(np.int64), bi.ravel().astype(np.int64)
    n = int(ai.size)
    pi, pj = np.bincount(ai), np.bincount(bi)
    if pi.size <= 1 or pj.size <= 1:  # one cluster (or none): MI = 0
        return 0.0, pi, pj, n
    nb = pj.size
    keys, nz = np.unique(ai * nb + bi, return_counts=True)
    nzx, nzy = keys // nb, keys % nb
    nz = nz.astype(np.float64)
    contingency_nm = nz / n
    outer = pi[nzx].astype(np.int64) * pj[nzy].astype(np.int64)
    log_outer = -np.log(outer) + math.log(pi.sum()) + math.log(pj.sum())
    mi = (contingency_nm * (np.log(nz) - math.log(n))
          + contingency_nm * log_outer)
    mi = np.where(np.abs(mi) < np.finfo(mi.dtype).eps, 0.0, mi)
    return float(max(mi.sum(), 0.0)), pi, pj, n


def expected_mutual_info(a_sums: np.ndarray, b_sums: np.ndarray,
                         n: int) -> float:
    """E[MI] over labelings with these marginals (hypergeometric model;
    sklearn's ``expected_mutual_information``). Pairs of rows and columns
    with equal sums contribute alike, so the sum runs over distinct sums
    weighted by their multiplicities, one vectorized pass per n_ij."""
    if a_sums.size == 1 or b_sums.size == 1:
        return 0.0
    ua, ca = np.unique(a_sums, return_counts=True)
    ub, cb = np.unique(b_sums, return_counts=True)
    a = ua[:, None].astype(np.float64)
    b = ub[None, :].astype(np.float64)
    mult = ca[:, None].astype(np.float64) * cb[None, :]
    start = np.maximum(1, ua[:, None] - n + ub[None, :])
    stop = np.minimum(ua[:, None], ub[None, :])  # inclusive
    gln_fixed = (gammaln(a + 1) + gammaln(b + 1) + gammaln(n - a + 1)
                 + gammaln(n - b + 1) - gammaln(n + 1))
    log_ab = np.log(a) + np.log(b)
    emi = 0.0
    for nij in range(1, int(stop.max()) + 1):
        on = (start <= nij) & (nij <= stop)
        if not on.any():
            continue
        term2 = math.log(n) + math.log(nij) - log_ab
        gln = (gln_fixed - gammaln(nij + 1.0) - gammaln(a - nij + 1)
               - gammaln(b - nij + 1) - gammaln(n - a - b + nij + 1))
        terms = (nij / n) * term2 * np.exp(np.where(on, gln, -np.inf))
        emi += float(np.sum(np.where(on, terms, 0.0) * mult))
    return emi


def _trivial(pi: np.ndarray, pj: np.ndarray) -> bool:
    """Both labelings one cluster (or empty): a perfect match."""
    return (pi.size == pj.size == 1) or (pi.size == pj.size == 0)


def normalized_mutual_info(labels_true, labels_pred) -> float:
    """NMI with the arithmetic mean of the two entropies."""
    mi, pi, pj, _ = _mutual_info(labels_true, labels_pred)
    if _trivial(pi, pj):
        return 1.0
    if mi == 0:
        return 0.0
    normalizer = (_entropy(pi) + _entropy(pj)) / 2
    return float(mi / normalizer)


def adjusted_mutual_info(labels_true, labels_pred) -> float:
    """AMI = (MI - E[MI]) / (mean(H_true, H_pred) - E[MI])."""
    mi, pi, pj, n = _mutual_info(labels_true, labels_pred)
    if _trivial(pi, pj):
        return 1.0
    emi = expected_mutual_info(pi, pj, n)
    normalizer = (_entropy(pi) + _entropy(pj)) / 2
    denominator = normalizer - emi
    eps = np.finfo("float64").eps
    if denominator < 0:
        denominator = min(denominator, -eps)
    else:
        denominator = max(denominator, eps)
    return float((mi - emi) / denominator)
