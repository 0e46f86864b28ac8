"""The port's iterative-cluster step against the JAX package's, on the CPU.

* NMI and AMI without scikit-learn equal ``sklearn.metrics`` within
  1e-10: random partitions, one cluster, all singletons;
* ``iterative_cluster_step`` writes the same ``vid_clusters.txt``,
  ``NMIs.txt`` and ``AMIs.txt`` as the JAX one from the same embeddings
  (the embedding pass is stubbed in both packages with the same arrays),
  and ``ITERCLUSTER.ADAPTIVEP`` sets the same positive-sampling p.
"""

import os

import numpy as np
import pytest
from sklearn.metrics import (adjusted_mutual_info_score,
                             normalized_mutual_info_score)

from video_similarity_search_tpu.config import get_cfg as j_get_cfg
from video_similarity_search_tpu.train import driver as j_driver
from video_similarity_search_tpu_torch.config import get_cfg as t_get_cfg
from video_similarity_search_tpu_torch.train import driver as t_driver
from video_similarity_search_tpu_torch.utils.cluster_metrics import (
    adjusted_mutual_info, expected_mutual_info, normalized_mutual_info)


def _partitions():
    rng = np.random.default_rng(0)
    cases = []
    for n, ka, kb in [(50, 3, 5), (200, 10, 40), (300, 2, 2), (97, 7, 1),
                      (1000, 20, 150), (12, 12, 12)]:
        cases.append((rng.integers(0, ka, n), rng.integers(0, kb, n)))
    x = rng.integers(0, 5, 60)
    cases += [(x, x), (x, np.zeros(60, int)), (np.zeros(60, int), x),
              (np.zeros(60, int), np.zeros(60, int)),  # one cluster each
              (x, np.arange(60)), (np.arange(60), np.arange(60)),
              (x * 7 - 3, (x + 1) % 5)]  # a relabelling
    return cases


@pytest.mark.parametrize("case", range(len(_partitions())))
def test_nmi_ami_match_sklearn(case):
    a, b = _partitions()[case]
    assert abs(normalized_mutual_info(a, b)
               - normalized_mutual_info_score(a, b)) <= 1e-10
    assert abs(adjusted_mutual_info(a, b)
               - adjusted_mutual_info_score(a, b)) <= 1e-10


def test_ami_at_ucf_scale_matches_sklearn():
    rng = np.random.default_rng(1)
    a, b = rng.integers(0, 101, 9537), rng.integers(0, 1000, 9537)
    assert abs(adjusted_mutual_info(a, b)
               - adjusted_mutual_info_score(a, b)) <= 1e-10
    assert expected_mutual_info(np.array([9537]), np.bincount(b), 9537) == 0


def _embeddings(n=90, d=16, classes=6, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, d))
    true = rng.integers(0, classes, n)
    emb = (centers[true] + 0.6 * rng.normal(size=(n, d))).astype(np.float32)
    # the loader's order need not be the dataset's: shuffle it
    perm = rng.permutation(n)
    return emb[perm], true[perm].astype(np.int64), perm.astype(np.int64)


@pytest.mark.parametrize("adaptive", [False, True])
def test_iterative_cluster_step_writes_what_jax_writes(tmp_path, monkeypatch,
                                                       adaptive):
    emb, true, idx = _embeddings()
    stub = lambda *a, **k: (emb.copy(), true.copy(), idx.copy())  # noqa: E731
    monkeypatch.setattr(j_driver, "get_embeddings_and_labels", stub)
    monkeypatch.setattr(t_driver, "get_embeddings_and_labels", stub)
    files, labels, p = {}, {}, {}
    for pkg in ("jax", "torch"):
        cfg = (j_get_cfg if pkg == "jax" else t_get_cfg)()
        cfg.merge_from_list(["ITERCLUSTER.METHOD", "finch",
                             "ITERCLUSTER.ADAPTIVEP", adaptive,
                             "OUTPUT_PATH", str(tmp_path / pkg)])
        if pkg == "jax":
            labels[pkg] = j_driver.iterative_cluster_step(None, None, cfg,
                                                          [], is_master=True)
        else:
            labels[pkg] = t_driver.iterative_cluster_step(None, cfg, [],
                                                          device="cpu")
        out = tmp_path / pkg
        files[pkg] = {name: (out / name).read_text() for name in (
            "vid_clusters.txt", os.path.join("tnet_checkpoints", "NMIs.txt"),
            os.path.join("tnet_checkpoints", "AMIs.txt"))}
        p[pkg] = cfg.DATASET.POSITIVE_SAMPLING_P
    assert files["torch"] == files["jax"]
    np.testing.assert_array_equal(labels["torch"], labels["jax"])
    assert len(files["torch"]["vid_clusters.txt"].split()) == len(emb)
    assert p["torch"] == p["jax"]
    nmi = normalized_mutual_info_score(true[np.argsort(idx)],
                                       labels["torch"])
    assert p["torch"] == (1.0 - nmi if adaptive else 0.8)
    assert files["torch"]["tnet_checkpoints/NMIs.txt"] == f"{nmi:.6f}\n"
