"""How ``csrc/nn1_cosine.cu`` sums its 3xTF32 products, measured on the card.

The kernel sums each 32-wide D chunk's products on the tensor cores into a
chunk sum that starts at zero, then adds that to an fp32 running sum on the
CUDA cores. The other way is to let the tensor cores sum all of D into one
accumulator. That skips the adds, but every wgmma then truncates against
the whole running sum. This script derives that one-accumulator form from the
kernel's own source, builds both with the same flags, and compares them at
FINCH's Kinetics shape: the 240,000 x 128 planted mixture of
``chip_smoke.py`` (self-query) and its 4,096-row near-tie case. The referee
is an fp64 1-NN. It prints one JSON line per form and input: ms (median of
5, CUDA events, the hi/lo split included), the largest |dist - fp64 dist|,
and the rows whose pick differs from the fp64 pick.

Usage (one CUDA card, from the repository root):
    python3 -m video_similarity_search_tpu_torch.utils.nn1_accumulation
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from ..ops import cuda_build, fused_knn
from ..ops.pdist import l2_normalize, nearest_neighbor

# the chunk-sum form, as csrc/nn1_cosine.cu has it -> the one-accumulator form
_CHUNK_SUM = (
    "          wgmma_m64n128k8_tf32(part, da_lo + k, db_hi + k, kk != 0);\n"
    "          wgmma_m64n128k8_tf32(part, da_hi + k, db_lo + k, 1);\n"
    "        }\n"
    "#pragma unroll\n"
    "        for (int kk = 0; kk < BK / 8; ++kk) {\n"
    "          const uint64_t k = 2 * kk;\n"
    "          wgmma_m64n128k8_tf32(part, da_hi + k, db_hi + k, 1);\n"
    "        }\n")
_ONE_ACC = (
    "          wgmma_m64n128k8_tf32(acc, da_lo + k, db_hi + k, (c | kk) != 0);\n"
    "          wgmma_m64n128k8_tf32(acc, da_hi + k, db_lo + k, 1);\n"
    "          wgmma_m64n128k8_tf32(acc, da_hi + k, db_hi + k, 1);\n"
    "        }\n")
_PROMOTE = ("#pragma unroll\n"
            "        for (int i = 0; i < 64; ++i) "
            "acc[i] = c ? acc[i] + part[i] : part[i];\n")
_EDITS = ((_CHUNK_SUM, _ONE_ACC),
          ("        fence_acc(part);\n", "        fence_acc(acc);\n"),
          (_PROMOTE, ""))


def one_accumulator_source(src: str) -> str:
    """The kernel's source with every chunk's products summed into the
    running accumulator by the tensor cores, and no promotion."""
    for old, new in _EDITS:
        if src.count(old) != 1:
            raise RuntimeError("csrc/nn1_cosine.cu no longer has the chunk-sum "
                               f"code this script rewrites:\n{old}")
        src = src.replace(old, new)
    return src


def build_one_accumulator() -> str:
    """Writes and builds the one-accumulator form; -> .so path."""
    with open(os.path.join(cuda_build.CSRC, "nn1_cosine.cu")) as f:
        src = one_accumulator_source(f.read())
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(cuda_build.BUILD_DIR, "nn1_one_accumulator.cu")
    with open(path, "w") as f:
        f.write(src)
    out = path[:-3] + ".so"
    proc = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS,
                           "-I", cuda_build.CSRC, "-o", out, path],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    return out


def _entry(lib_path: str):
    fn = ctypes.CDLL(lib_path).nn1_cosine
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _run(fn, xn: torch.Tensor):
    """Self-query 1-NN of L2-normalized rows through the library ``fn``."""
    x_hi, x_lo = fused_knn.prepare_operand(xn)
    m = xn.shape[0]
    idx = torch.empty(m, dtype=torch.int64, device=xn.device)
    dist = torch.empty(m, dtype=torch.float32, device=xn.device)
    rc = fn(x_hi.data_ptr(), x_lo.data_ptr(), x_hi.data_ptr(),
            x_lo.data_ptr(), idx.data_ptr(), dist.data_ptr(), m, m,
            x_hi.shape[1], 1, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: code {rc}")
    return idx, dist


def fp64_nearest(xn: torch.Tensor, tile: int = 512):
    """Self-query 1-NN in fp64 -> (idx, dist)."""
    x64 = xn.double()
    idx, dist = [], []
    for off in range(0, x64.shape[0], tile):
        d = 1.0 - x64[off:off + tile] @ x64.T
        r = torch.arange(d.shape[0], device=d.device)
        d[r, r + off] = float("inf")
        v, i = d.min(dim=1)
        idx.append(i)
        dist.append(v)
    return torch.cat(idx), torch.cat(dist)


def time_ms(fn, reps: int = 5) -> float:
    """Median of ``reps`` CUDA-event timings after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def mixture(n: int, d: int = 128, classes: int = 400, noise: float = 0.8,
            seed: int = 0) -> np.ndarray:
    """chip_smoke.py's planted mixture (perf_experiments/cluster_240k_r4.py)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, d)).astype(np.float32)
    lbl = rng.integers(0, classes, n)
    return centers[lbl] + noise * rng.normal(size=(n, d)).astype(np.float32)


def main() -> int:
    if not torch.cuda.is_available():
        print("nn1_accumulation: needs one CUDA card", file=sys.stderr)
        return 2
    forms = {"chunk sums (shipped)": _entry(cuda_build.build("nn1_cosine")),
             "one accumulator": _entry(build_one_accumulator())}
    rng = np.random.default_rng(0)  # chip_smoke.py's near-tie rows
    dup = rng.normal(size=(1366, 128)).astype(np.float32)
    near = np.concatenate([dup] + [
        dup * (1 + 1e-6 * rng.normal(size=dup.shape)) for _ in range(2)])
    inputs = {"self 4096x128 near ties": near[:4096],
              "self 240000x128": mixture(240_000)}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    for label, x_np in inputs.items():
        xn = l2_normalize(torch.from_numpy(x_np.astype(np.float32)).cuda())
        ti, td = fp64_nearest(xn)
        calls = {name: (lambda f=fn: _run(f, xn)) for name, fn in forms.items()}
        calls["plain (IEEE fp32 torch.mm)"] = lambda: nearest_neighbor(xn)
        for name, call in calls.items():
            idx, dist = call()
            torch.cuda.synchronize()
            print(json.dumps({
                "input": label, "form": name, "ms": time_ms(call),
                "max_abs_err_vs_fp64": float((dist.double() - td).abs().max()),
                "rows_differ_from_fp64": int((idx != ti).sum()),
                "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
