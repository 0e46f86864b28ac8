"""Rules the PyTorch port keeps: no JAX anywhere in it or in chip_smoke.py,
no silent fall back to the CPU, and (on a CUDA machine only) the CUDA 1-NN
kernel agrees with its plain version."""

import ast
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "video_similarity_search_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "video_similarity_search_tpu")


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_and_chip_smoke_import_no_jax():
    files = _port_sources()
    assert len(files) > 20
    bad = [(os.path.relpath(f, ROOT), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN]
    assert not bad, f"JAX-side imports in the port: {bad}"


def test_entry_points_without_device_raise_on_a_box_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    from video_similarity_search_tpu_torch.cluster import FINCH, fit_cluster
    from video_similarity_search_tpu_torch.evaluation import (
        get_embeddings_and_labels, topk_retrieval_acc)
    x = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
    y = np.zeros(8, np.int64)
    calls = [lambda: FINCH(x, verbose=False),
             lambda: fit_cluster(x, method="finch", verbose=False),
             lambda: topk_retrieval_acc(x, y, x, y),
             lambda: get_embeddings_and_labels(None, None, [])]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.gpu
def test_nn1_cosine_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from video_similarity_search_tpu_torch.ops import fused_knn
    from video_similarity_search_tpu_torch.ops.pdist import (l2_normalize,
                                                              nearest_neighbor)
    rng = np.random.default_rng(0)
    for m, n, d, self_q in [(37, 37, 16, True), (37, 53, 16, False),
                            (1000, 1000, 128, True)]:
        x = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).cuda()
        y = x if self_q else torch.from_numpy(
            rng.normal(size=(n, d)).astype(np.float32)).cuda()
        xn, yn = l2_normalize(x), l2_normalize(y)
        ki, kd = fused_knn.nn1_cosine_cuda(xn, yn, self_q)
        pi, pd = nearest_neighbor(x, None if self_q else y,
                                  exclude_self=self_q)
        torch.cuda.synchronize()
        np.testing.assert_allclose(kd.cpu().numpy(), pd.cpu().numpy(),
                                   atol=1e-5)
        # indices equal, except on a tie under another summation order
        diff = ki != pi
        d_pick = 1.0 - (xn[diff] * yn[ki[diff]]).sum(1)
        assert bool(((d_pick - pd[diff]).abs() <= 1e-6).all())
