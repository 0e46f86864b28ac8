"""The 3xTF32 arithmetic of the port's CUDA 1-NN kernel, checked on the CPU.

The kernel (``csrc/nn1_cosine.cu``) runs only on the card. What surrounds
it is plain PyTorch and is checked here: the hi/lo split onto exact TF32
values (``ops/fused_knn.split_tf32``), the zero padding of D to the
kernel's 32-wide chunk, and the build's content hash. A test-local
emulation of the kernel's arithmetic -- per 32-wide chunk of D, lo.hi +
hi.lo + hi.hi in fp32, the chunk sums added in order, then the masked
first-index argmin of 1 - s -- is held against the JAX
Pallas kernel run by the Pallas interpreter, as tests/test_ops.py runs it.
Tolerance: indices equal on tie-free inputs, distances within 1e-6 (the
dropped lo.lo term and the split cost at most about 3 * 2^-22 = 7.2e-7 on a
unit-row dot product; the rest is fp32 rounding in another order).
"""

import os

import numpy as np
import pytest
import torch

from video_similarity_search_tpu.ops.pallas_knn import \
    nearest_neighbor_fused as j_fused
from video_similarity_search_tpu_torch.ops import cuda_build
from video_similarity_search_tpu_torch.ops.fused_knn import (
    K_CHUNK, nn1_cosine_cuda, pad_to_k_chunk, prepare_operand, split_tf32)
from video_similarity_search_tpu_torch.ops.pdist import (l2_normalize,
                                                          nearest_neighbor)

DIST_ATOL = 1e-6
BIG = 3.4e38
LOW13 = (1 << 13) - 1
# below 2^-126 TF32 keeps the fp32 exponent but only multiples of 2^-136,
# so the split's error there is at most half of that
DENORMAL_FLOOR = 2.0 ** -137


def _rand(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _values(kind):
    v = _rand(0, 4096).astype(np.float64)
    return {"normal": v, "tiny": v * 1e-30, "denormal": v * 1e-40,
            "zero": np.zeros(64), "negative": -np.abs(v)}[kind]


@pytest.mark.parametrize("kind", ["normal", "tiny", "denormal", "zero",
                                  "negative"])
def test_split_tf32_properties(kind):
    x = torch.from_numpy(_values(kind).astype(np.float32))
    if kind == "denormal":
        assert bool((x.abs() < 2.0 ** -126).all() & (x != 0).any())
    hi, lo = split_tf32(x)
    assert hi.dtype == lo.dtype == torch.float32
    for part in (hi, lo):
        assert not bool(torch.isnan(part).any())
        assert bool(((part.view(torch.int32) & LOW13) == 0).all())
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs() + DENORMAL_FLOOR).all())
    if kind != "denormal":
        assert bool((err <= 2.0 ** -22 * x.double().abs()).all())


def test_tf32_hi_is_round_to_nearest_even():
    x = _rand(1, 20000)
    # exact ties of the 13 dropped bits, both parities of the kept bit
    ties = (np.arange(1, 65, dtype=np.int64) << 13 | 1 << 12) | 0x3F800000
    x = np.concatenate([x, ties.astype(np.int32).view(np.float32)])
    hi, _ = split_tf32(torch.from_numpy(x))
    frac, exp = np.frexp(x.astype(np.float64))
    ref = np.ldexp(np.round(frac * 2.0 ** 11), exp - 11)  # half to even
    np.testing.assert_array_equal(hi.numpy(), ref.astype(np.float32))


@pytest.mark.parametrize("d", [16, 20, 32, 33, 256])
def test_padding_to_the_k_chunk_keeps_the_plain_1nn(d):
    x = torch.from_numpy(_rand(2, 41, d))
    xp = pad_to_k_chunk(x)
    assert xp.shape == (41, -(-d // K_CHUNK) * K_CHUNK)
    assert bool((xp[:, d:] == 0).all()) and torch.equal(xp[:, :d], x)
    i0, d0 = nearest_neighbor(x)
    i1, d1 = nearest_neighbor(xp)
    np.testing.assert_array_equal(i1.numpy(), i0.numpy())
    np.testing.assert_allclose(d1.numpy(), d0.numpy(), atol=DIST_ATOL)


def _emulate_kernel(x, y, exclude_self):
    """The kernel's arithmetic in fp32 on the CPU: split, three products
    per chunk of D, chunk sums added in order, 1 - s, masked argmin with
    the first index winning."""
    xn = l2_normalize(torch.from_numpy(x))
    yn = xn if y is None else l2_normalize(torch.from_numpy(y))
    x_hi, x_lo = prepare_operand(xn)
    y_hi, y_lo = prepare_operand(yn)
    s = torch.zeros(xn.shape[0], yn.shape[0])
    for c in range(0, x_hi.shape[1], K_CHUNK):
        k = slice(c, c + K_CHUNK)
        s += (x_lo[:, k] @ y_hi[:, k].T + x_hi[:, k] @ y_lo[:, k].T
              + x_hi[:, k] @ y_hi[:, k].T)
    d = 1.0 - s
    if exclude_self and y is None:
        d.fill_diagonal_(BIG)
    dist, idx = d.min(dim=1)  # the first minimum, as the kernel's strict <
    return idx.numpy(), dist.numpy()


@pytest.mark.parametrize("m,n,d,tile", [(37, None, 16, (8, 16)),
                                        (37, 53, 16, (8, 16)),
                                        (512, None, 128, (128, 128)),
                                        (300, None, 256, (128, 128))])
def test_kernel_arithmetic_matches_pallas_interpret(m, n, d, tile):
    x = _rand(3 + m, m, d)
    y = None if n is None else _rand(4 + n, n, d)
    ji, jd = j_fused(x, y, exclude_self=True, tile_m=tile[0],
                     tile_n=tile[1], interpret=True)
    ei, ed = _emulate_kernel(x, y, exclude_self=True)
    np.testing.assert_array_equal(ei, np.asarray(ji))
    np.testing.assert_allclose(ed, np.asarray(jd), atol=DIST_ATOL)


def test_kernel_arithmetic_first_index_wins_a_tie():
    # bank rows 5 and 30 are the same vector; queries sit next to it
    x = _rand(8, 37, 16)
    y = _rand(10, 53, 16)
    y[30] = y[5]
    x[:4] = y[5] + 0.001 * _rand(11, 4, 16)
    ji, jd = j_fused(x, y, exclude_self=True, tile_m=8, tile_n=16,
                     interpret=True)
    ei, ed = _emulate_kernel(x, y, exclude_self=True)
    assert (ei[:4] == 5).all()
    np.testing.assert_array_equal(ei, np.asarray(ji))
    np.testing.assert_allclose(ed, np.asarray(jd), atol=DIST_ATOL)


def test_wrapper_takes_only_cuda_tensors():
    x = l2_normalize(torch.from_numpy(_rand(12, 8, 16)))
    with pytest.raises(ValueError, match="CUDA"):
        nn1_cosine_cuda(x, x, True)


def test_build_hash_covers_the_headers(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    header = tmp_path / "common.cuh"
    header.write_text("// v1\n")
    monkeypatch.setattr(cuda_build, "CSRC", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    src, first = cuda_build.library_path("k")
    assert src == os.path.join(str(tmp_path), "k.cu")
    assert cuda_build.library_path("k")[1] == first
    header.write_text("// v2\n")
    assert cuda_build.library_path("k")[1] != first


def test_one_accumulator_form_derives_from_the_kernel_source():
    """utils/nn1_accumulation.py rewrites the kernel's chunk sums into one
    tensor-core accumulator; the code it rewrites must be there once."""
    from video_similarity_search_tpu_torch.utils import nn1_accumulation as acc
    with open(os.path.join(cuda_build.CSRC, "nn1_cosine.cu")) as f:
        src = f.read()
    out = acc.one_accumulator_source(src)
    assert "wgmma_m64n128k8_tf32(part" not in out
    assert out.count("wgmma_m64n128k8_tf32(acc") == 3
    assert "acc[i] + part[i]" not in out
    with pytest.raises(RuntimeError, match="no longer has"):
        acc.one_accumulator_source(out)


def test_fp64_referee_matches_plain_1nn_on_tie_free_rows():
    from video_similarity_search_tpu_torch.utils.nn1_accumulation import \
        fp64_nearest
    xn = l2_normalize(torch.from_numpy(_rand(13, 300, 24)))
    ti, td = fp64_nearest(xn, tile=64)
    pi, pd = nearest_neighbor(xn)
    np.testing.assert_array_equal(ti.numpy(), pi.numpy())
    np.testing.assert_allclose(td.numpy(), pd.numpy(), atol=DIST_ATOL)
