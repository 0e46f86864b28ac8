"""The port's serving slice as a whole against the JAX package, on the CPU:
embed (R3D) -> FINCH -> kNN retrieval.

The same flax weights (carried into the port by ``flax_resnet3d_to_torch``)
and the same uint8 batches, shaped by the JAX ``collate_videos`` with
multi-window test videos and a padded ragged last batch, give the same
embeddings (atol 2e-4, float32). On identical embeddings both packages
give the same FINCH labels up to relabelling and the same retrieval
accuracies; ``k_nearest_embeddings`` writes the same cache files and the
same ``global_retrieval_acc.txt`` line.
"""

import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_similarity_search_tpu.cluster.fit import fit_cluster as j_fit
from video_similarity_search_tpu.config import get_cfg as j_get_cfg
from video_similarity_search_tpu.data.pipeline import collate_videos
from video_similarity_search_tpu.evaluation import embed as jembed
from video_similarity_search_tpu.evaluation import knn as jknn
from video_similarity_search_tpu.evaluation import retrieval as jret
from video_similarity_search_tpu.models.registry import \
    model_selector as j_selector
from video_similarity_search_tpu_torch.cluster.fit import fit_cluster as t_fit
from video_similarity_search_tpu_torch.config import get_cfg as t_get_cfg
from video_similarity_search_tpu_torch.evaluation import embed as tembed
from video_similarity_search_tpu_torch.evaluation import knn as tknn
from video_similarity_search_tpu_torch.evaluation import retrieval as tret
from video_similarity_search_tpu_torch.models import \
    model_selector as t_selector
from video_similarity_search_tpu_torch.train.checkpoint import \
    flax_resnet3d_to_torch

T, S = 4, 32
OPTS = ["MODEL.ARCH", "3dresnet", "RESNET.MODEL_DEPTH", 10,
        "RESNET.WIDEN_FACTOR", 0.25, "RESNET.HIDDEN_LAYER", 32,
        "RESNET.OUT_DIM", 16, "DATA.SAMPLE_SIZE", S,
        "DATA.SAMPLE_DURATION", T, "TRAIN.DATASET", "kinetics",
        "TPU.COMPUTE_DTYPE", "float32"]


def _cfgs(out_dir):
    jcfg, tcfg = j_get_cfg(), t_get_cfg()
    for cfg in (jcfg, tcfg):
        cfg.merge_from_list(OPTS + ["OUTPUT_PATH", str(out_dir)])
    return jcfg, tcfg


def _batches(items, bs):
    """Loader-shaped batches: a ragged tail is padded by repeating its last
    item, with ``__size__`` the real count (data/pipeline.py)."""
    out = []
    for i in range(0, len(items), bs):
        chunk = items[i:i + bs]
        real = len(chunk)
        batch = collate_videos(chunk + [chunk[-1]] * (bs - real))
        batch["__size__"] = real
        out.append(batch)
    return out


def _splits(seed=0):
    rng = np.random.default_rng(seed)
    n_cls = 3
    train = [{"clip": rng.integers(0, 256, (T, S, S, 3), np.uint8),
              "target": int(i % n_cls), "index": i} for i in range(10)]
    test = []
    for i, w in enumerate([2, 1, 3, 4, 1]):
        test.append({"clip": rng.integers(0, 256, (w, T, S, S, 3), np.uint8),
                     "target": int(i % n_cls), "index": i})
    # train: 4 + 4 + 2 padded; test: window counts (2,1) (3,4) (1, pad)
    return _batches(train, 4), _batches(test, 2)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs(".")
    fmodel = j_selector(jcfg)
    variables = fmodel.init(jax.random.key(0), jnp.zeros((1, T, S, S, 3)),
                            train=False)
    rng = np.random.default_rng(1)
    stats = jax.tree.map(
        lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32),
        variables["batch_stats"])
    params = jax.tree.map(np.asarray, variables["params"])
    state = types.SimpleNamespace(params=params, batch_stats=stats)
    tmodel = t_selector(tcfg)
    tmodel.load_state_dict(flax_resnet3d_to_torch(params, stats))
    return fmodel, state, tmodel


def test_embeddings_match_jax(models, tmp_path):
    fmodel, state, tmodel = models
    jcfg, tcfg = _cfgs(tmp_path)
    for split, batches in zip(("train", "test"), _splits()):
        je, jl, ji = jembed.get_embeddings_and_labels(
            state, fmodel, jcfg, batches, split=split, verbose=False)
        if split == "test":  # the port also takes clips as tensors
            batches = [{**b, "clip": torch.from_numpy(b["clip"])}
                       for b in batches]
        te, tl, ti = tembed.get_embeddings_and_labels(
            tmodel, tcfg, batches, split=split, verbose=False, device="cpu")
        assert te.shape == je.shape == (10 if split == "train" else 5, 16)
        np.testing.assert_allclose(te, je, atol=2e-4, rtol=1e-3)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(ti, ji)


def test_cluster_and_retrieval_match_jax_on_same_embeddings():
    rng = np.random.default_rng(2)
    centers = rng.normal(size=(5, 16))
    lbl = rng.integers(0, 5, 200)
    emb = (centers[lbl] + 0.7 * rng.normal(size=(200, 16))).astype(np.float32)
    lj = j_fit(emb, method="finch", verbose=False)
    lt = t_fit(emb, method="finch", verbose=False, device="cpu")
    assert len(np.unique(lt)) == len(np.unique(lj))
    # same partition: a bijection between label sets
    pairs = set(zip(lj.tolist(), lt.tolist()))
    assert len(pairs) == len(np.unique(lj))
    q, ql = emb[:60], lbl[:60]
    bank, bl = emb[60:], lbl[60:]
    aj = jret.topk_retrieval_acc(q, ql, bank, bl)
    at = tret.topk_retrieval_acc(q, ql, bank, bl, device="cpu")
    assert at == aj
    aj = jret.local_batch_retrieval_acc(emb, lbl)
    at = tret.local_batch_retrieval_acc(emb, lbl, device="cpu")
    assert at == aj
    aj = jret.coclr_retrieval_acc(q, ql, bank, bl)
    at = tret.coclr_retrieval_acc(q, ql, bank, bl, device="cpu")
    assert at == aj
    clips = emb.reshape(40, 5, 16)  # IIC: (videos, clips, D)
    aj = jret.iic_retrieval_acc(clips[:10], lbl[:10], clips[10:], lbl[10:40])
    at = tret.iic_retrieval_acc(clips[:10], lbl[:10], clips[10:], lbl[10:40],
                                device="cpu")
    assert at == aj
    for same_set in (False, True):
        np.testing.assert_allclose(
            tret.get_distance_matrix(q, q if same_set else bank,
                                     same_set=same_set, device="cpu"),
            jret.get_distance_matrix(q, q if same_set else bank,
                                     same_set=same_set), atol=1e-5)


def test_k_nearest_embeddings_writes_what_jax_writes(models, tmp_path):
    fmodel, state, tmodel = models
    train, test = _splits(seed=3)
    lines, names = {}, {}
    for pkg in ("jax", "torch"):
        out = tmp_path / pkg
        jcfg, tcfg = _cfgs(out)
        cache = str(out / "cache")
        if pkg == "jax":
            acc = jknn.k_nearest_embeddings(state, fmodel, jcfg, train, test,
                                            epoch=0, cache_dir=cache)
        else:
            acc = tknn.k_nearest_embeddings(tmodel, tcfg, train, test,
                                            epoch=0, cache_dir=cache,
                                            device="cpu")
        assert sorted(acc) == [1, 5, 10, 20]
        names[pkg] = sorted(os.listdir(cache))
        with open(out / "tnet_checkpoints" / "global_retrieval_acc.txt") as f:
            lines[pkg] = f.read()
    assert names["torch"] == names["jax"] == [
        "test_embeddings_ep0.pkl", "train_embeddings_ep0.pkl"]
    assert lines["torch"] == lines["jax"]
    assert lines["torch"].startswith("epoch:0 top1:")
