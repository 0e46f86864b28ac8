"""fit_cluster's Agglomerative, DBSCAN and OPTICS in the port (scipy's
linkage and the port's own density rules, no scikit-learn) against the JAX
package's fit_cluster, which calls scikit-learn, on the CPU.

Every input is a seeded planted mixture (numpy ``default_rng``, the seed
in each case) whose clusters straddle the radii: unit centres, each
cluster's spread drawn so its mean cosine distance is 0.06-0.25, and 5%
of the rows uniform noise. The rows that lie in a pair whose float64
cosine distance is within ``MARGIN`` = 1e-5 of a radius (0.14, 0.2 or the
``min_samples`` cases' radius) are then dropped, and each test asserts
that none is left: there float32 rounding may put the pair on either side
of the radius in either library. The labels must be equal array for array
(tolerance 0).

With scikit-learn's ``min_samples`` (2 for DBSCAN, 3 for OPTICS) no point
can border two clusters: its two core neighbours would make it core and
join them. So the border rules are also held at ``min_samples`` 4 and 5
against the scikit-learn estimators, on inputs that hold points bordering
two clusters and (OPTICS) border points whose index precedes every core of
their cluster.

scikit-learn runs under joblib's sequential backend here: the JAX
package's ``n_jobs=-1`` starts a pool for every OPTICS point (13 s for 300
rows against 0.7 s), and the backend changes no label.
"""

import joblib
import numpy as np
import pytest
import torch
from sklearn.cluster import DBSCAN, OPTICS

from video_similarity_search_tpu.cluster.fit import fit_cluster as j_fit
from video_similarity_search_tpu_torch.cluster import density
from video_similarity_search_tpu_torch.cluster.agglomerative import \
    agglomerative_cosine
from video_similarity_search_tpu_torch.cluster.fit import fit_cluster as t_fit

MARGIN = 1e-5
RADII = (0.14, 0.2)


@pytest.fixture(autouse=True)
def _sequential_joblib():
    with joblib.parallel_config(backend="sequential"):
        yield


def _cosine(x):
    xn = x.astype(np.float64)
    xn /= np.linalg.norm(xn, axis=1, keepdims=True)
    return 1.0 - xn @ xn.T


def _near_radius_rows(x, radii=RADII):
    d = _cosine(x)
    near = np.zeros(len(x), bool)
    for r in radii:
        hit = np.abs(d - r) < MARGIN
        np.fill_diagonal(hit, False)
        near |= hit.any(1)
    return near


def planted(n, d, seed, radii=RADII):
    """The module docstring's mixture, rows near a radius dropped."""
    rng = np.random.default_rng(seed)
    k = max(n // 25, 2)
    c = rng.normal(size=(k, d))
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    lbl = rng.integers(0, k, n)
    spread = rng.uniform(0.06, 0.25, k)
    sigma = np.sqrt(spread / (1 - spread) / d)
    x = c[lbl] + sigma[lbl, None] * rng.normal(size=(n, d))
    noise = rng.random(n) < 0.05
    x[noise] = rng.normal(size=(int(noise.sum()), d))
    x = x.astype(np.float32)
    x = x[~_near_radius_rows(x, radii)]
    assert not _near_radius_rows(x, radii).any()
    return x


def _border_cases(x, radius, min_samples):
    """(non-core points with a core neighbour, those whose index precedes
    their lowest cluster's first core, those bordering two clusters)."""
    src, dst = density.radius_graph(torch.from_numpy(x), radius)
    core, cluster, first = density._core_clusters(len(x), src, dst,
                                                  min_samples)
    core, cluster, first = core.numpy(), cluster.numpy(), first.numpy()
    src, dst = src.numpy(), dst.numpy()
    edge = core[src] & ~core[dst]
    border = np.unique(dst[edge])
    before = two = 0
    for p in border:
        ids = np.unique(cluster[src[edge][dst[edge] == p]])
        before += int(first[ids.min()] > p)
        two += int(len(ids) > 1)
    return len(border), before, two


@pytest.mark.parametrize("method,n,d,seed", [
    ("DBSCAN", 300, 16, 0), ("DBSCAN", 1000, 64, 1), ("DBSCAN", 2000, 128, 2),
    ("OPTICS", 300, 32, 12), ("OPTICS", 600, 128, 4), ("OPTICS", 1000, 64, 5),
    ("Agglomerative", 300, 16, 6), ("Agglomerative", 1000, 128, 7),
    ("Agglomerative", 2000, 32, 8),
])
def test_fit_cluster_matches_jax(method, n, d, seed):
    """Seeded mixture (seed in the case id), no pair within 1e-5 of 0.14 or
    0.2; labels equal to the JAX package's (scikit-learn's). The OPTICS
    inputs hold a border point scanned before its cluster (seed 12: the
    first from 3 up at 300 x 32 that does)."""
    x = planted(n, d, seed)
    want = j_fit(x, method=method, verbose=False)
    got = t_fit(x, method=method, verbose=False, device="cpu")
    assert got.dtype == np.int64 and got.shape == (len(x),)
    assert len(set(want.tolist())) > 5
    np.testing.assert_array_equal(got, want)
    if method == "OPTICS":
        assert _border_cases(x, 0.2, 3)[1] > 0


@pytest.mark.parametrize("rule,min_samples,seed,d", [
    ("dbscan", 4, 12, 16), ("dbscan", 5, 15, 32),
    ("optics", 4, 42, 128), ("optics", 5, 47, 128),
])
def test_border_rules_match_sklearn(rule, min_samples, seed, d):
    """Seeded mixture of 300 rows (seed in the case id: the first from 10
    up whose input holds both border cases), no pair within 1e-5 of the
    radius; labels equal to scikit-learn's at ``min_samples`` 4 and 5, with
    points on the border of two clusters and border points whose index
    precedes their cluster's cores among the inputs."""
    radius = 0.14 if rule == "dbscan" else 0.2
    x = planted(300, d, seed, radii=(radius,))
    _, before, two = _border_cases(x, radius, min_samples)
    assert before > 0 and two > 0
    if rule == "dbscan":
        want = DBSCAN(eps=radius, min_samples=min_samples,
                      metric="cosine").fit(x).labels_
        got = density.dbscan(x, eps=radius, min_samples=min_samples,
                             device="cpu")
    else:
        want = OPTICS(min_samples=min_samples, max_eps=radius,
                      cluster_method="dbscan", metric="cosine").fit(x).labels_
        got = density.optics_dbscan(x, min_samples=min_samples,
                                    max_eps=radius, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_optics_border_before_core_is_noise():
    """Hand-made, on one great circle: point 0 lies 0.18 from core 1 of a
    tight triple (1, 2, 3) and more than 0.2 from the rest. DBSCAN
    (min_samples 3) gives it cluster 0; OPTICS scans it first, with
    infinite reachability, and calls it noise, as scikit-learn does."""
    rng = np.random.default_rng(20)
    base = rng.normal(size=16)
    base /= np.linalg.norm(base)
    off = rng.normal(size=16)
    off -= off @ base * base
    off /= np.linalg.norm(off)
    tilt = lambda a: np.cos(a) * base + np.sin(a) * off  # noqa: E731
    x = np.stack([tilt(np.arccos(1 - 0.18)), tilt(0.0), tilt(-0.1),
                  tilt(-0.2), -base]).astype(np.float32)
    assert not _near_radius_rows(x).any()
    want_o = OPTICS(min_samples=3, max_eps=0.2, cluster_method="dbscan",
                    metric="cosine").fit(x).labels_
    want_d = DBSCAN(eps=0.2, min_samples=3, metric="cosine").fit(x).labels_
    np.testing.assert_array_equal(want_o, [-1, 0, 0, 0, -1])
    np.testing.assert_array_equal(want_d, [0, 0, 0, 0, -1])
    np.testing.assert_array_equal(
        density.optics_dbscan(x, device="cpu").numpy(), want_o)
    np.testing.assert_array_equal(
        density.dbscan(x, eps=0.2, min_samples=3, device="cpu").numpy(),
        want_d)


def test_agglomerative_rejects_zero_rows():
    x = np.ones((4, 8), np.float32)
    x[2] = 0
    with pytest.raises(ValueError, match="zero vectors"):
        agglomerative_cosine(x)


def test_fit_cluster_needs_no_sklearn(monkeypatch):
    """The three methods run where scikit-learn cannot be imported (a
    seeded mixture of 200 x 16, seed 30, no pair within 1e-5 of 0.14 or
    0.2, as ``planted`` asserts)."""
    import sys

    for name in [m for m in sys.modules if m.split(".")[0] == "sklearn"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    x = planted(200, 16, 30)
    for method in ("Agglomerative", "DBSCAN", "OPTICS"):
        labels = t_fit(x, method=method, verbose=False, device="cpu")
        assert labels.shape == (len(x),)
