#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Drives the port's serving path (video_similarity_search_tpu_torch) at the
full width of the Kinetics config (configs/resnet_kin_itercluster_flow.yaml:
R3D-18, 16x128x128 clips, 128-d embeddings) with random seeded weights and
data, in phases that each print one JSON line:

  device     card name and power limit, torch/CUDA versions, kernel builds
             (nvcc, sm_90a, all sources at once)
  kernel     each hand-written kernel against its plain PyTorch version on
             the card, at the path's shapes (ties and ragged edges included)
  embed      get_embeddings_and_labels over 4096 train clips (batches of
             256) and a multi-window test split; clips/s, peak memory, and
             the bf16 embeddings against the fp32 forward
  cluster    FINCH / fit_cluster("finch") over the 240,000 x 128 planted
             mixture of perf_experiments/cluster_240k_r4.py (sparse level 0
             through the CUDA 1-NN kernel), sparse-vs-dense level-0 parity on
             20k points, and FINCH on the 4096 embeddings (dense path)
  retrieval  k_nearest_embeddings over the embed phase's embeddings, and
             top-50 of 9,537 queries over the 240k bank

then the ``kernels`` summary line, the ``nvidia-smi`` name/power-limit line
and ``{"ok": true, "device": {...}}`` as the last line. Each kernel's launch
counter is set to 0 just before a path runs and read just after; a path that
did not launch its kernel fails the run, as does any failed check.

Usage: python3 chip_smoke.py     (needs one CUDA card; exits non-zero
without one, and outside a checkout of the repository)
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "runs", "chip_smoke")  # git-ignored
SEED = 0

# kernels of the path: name -> (source, TPU kernel it replaces)
KERNELS = {
    "nn1_cosine": ("video_similarity_search_tpu_torch/csrc/nn1_cosine.cu",
                   "video_similarity_search_tpu/ops/pallas_knn.py:37"),
}

# (fp32 CUDA-core FLOP/s, HBM bytes/s) from NVIDIA's data sheets (dense)
PEAKS = {"PCIe": (51e12, 2.0e12), "NVL": (60e12, 3.9e12),
         "SXM": (67e12, 3.35e12)}

KIN_OPTS = ["MODEL.ARCH", "3dresnet", "RESNET.MODEL_DEPTH", 18,
            "RESNET.SHORTCUT", "B", "RESNET.CONV1_T_SIZE", 7,
            "RESNET.CONV1_T_STRIDE", 1, "RESNET.NO_MAX_POOl", True,
            "RESNET.WIDEN_FACTOR", 1, "RESNET.HIDDEN_LAYER", 2048,
            "RESNET.OUT_DIM", 128, "DATA.SAMPLE_SIZE", 128,
            "DATA.SAMPLE_DURATION", 16, "DATA.INPUT_CHANNEL_NUM", 3,
            "TRAIN.DATASET", "kinetics"]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peaks_for(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    return "SXM", PEAKS["SXM"]


def time_ms(fn, reps: int = 5) -> float:
    """Median of ``reps`` CUDA-event timings after one warm-up call."""
    import torch

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


def mixture(n, d=128, classes=400, noise=0.8, seed=0):
    """perf_experiments/cluster_240k_r4.py::make_embeddings."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, d)).astype(np.float32)
    lbl = rng.integers(0, classes, n)
    x = centers[lbl] + noise * rng.normal(size=(n, d)).astype(np.float32)
    return x.astype(np.float32), lbl


def nmi(a: np.ndarray, b: np.ndarray) -> float:
    """Normalized mutual information, arithmetic mean (sklearn's default)."""
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    n, nb = len(a), int(bi.max()) + 1
    pair, nij = np.unique(ai.astype(np.int64) * nb + bi, return_counts=True)
    pa = np.bincount(ai) / n
    pb = np.bincount(bi) / n
    pij = nij / n
    mi = np.sum(pij * np.log(pij / (pa[pair // nb] * pb[pair % nb])))
    ha = -np.sum(pa * np.log(pa))
    hb = -np.sum(pb * np.log(pb))
    return float(2 * mi / (ha + hb)) if ha + hb > 0 else 1.0


def same_partition(a: np.ndarray, b: np.ndarray) -> bool:
    pairs = np.unique(np.stack([a, b], 1), axis=0)
    return len(pairs) == len(np.unique(a)) == len(np.unique(b))


# --------------------------------------------------------------------------

def phase_device():
    import torch

    from video_similarity_search_tpu_torch.ops import cuda_build

    check(torch.cuda.is_available(), "torch.cuda.is_available()")
    smi = nvidia_smi()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        libs = dict(zip(KERNELS, pool.map(cuda_build.build, KERNELS)))
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in cuda_build.BUILD_LOGS.get(name, "")
                    .splitlines() if "registers" in ln or "spill" in ln]
             for name in KERNELS}
    check(not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls in IEEE float32 (allow_tf32 off)")
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), build_s=build_s,
         libraries={k: os.path.relpath(v, ROOT) for k, v in libs.items()},
         ptxas=ptxas)
    return smi


def phase_kernel_nn1(smi: str, bank: np.ndarray):
    """nn1_cosine against ops/pdist.nearest_neighbor (tiled torch.mm +
    masked argmin, IEEE fp32) on the same inputs."""
    import torch

    from video_similarity_search_tpu_torch.ops import fused_knn
    from video_similarity_search_tpu_torch.ops.pdist import (l2_normalize,
                                                              nearest_neighbor)

    variant, (flops_peak, bw_peak) = peaks_for(smi)
    rng = np.random.default_rng(SEED)
    dup = rng.normal(size=(1366, 128)).astype(np.float32)
    cases = [
        ("self 37x16", rng.normal(size=(37, 16)), None),
        ("cross 37x53x16", rng.normal(size=(37, 16)),
         rng.normal(size=(53, 16))),
        ("self 4096x128 ties", np.concatenate([dup, dup, dup])[:4096], None),
        ("self 240000x128", bank, None),
    ]
    shapes = []
    for label, x_np, y_np in cases:
        x = torch.from_numpy(np.asarray(x_np, np.float32)).cuda()
        y = None if y_np is None else torch.from_numpy(
            np.asarray(y_np, np.float32)).cuda()
        self_q = y is None
        xn = l2_normalize(x)
        yn = xn if self_q else l2_normalize(y)
        ki, kd = fused_knn.nn1_cosine_cuda(xn, yn, self_q)
        pi, pd = nearest_neighbor(xn, None if self_q else yn,
                                  exclude_self=self_q)
        torch.cuda.synchronize()
        err = (kd - pd).abs().max().item()
        diff = ki != pi
        n_diff = int(diff.sum())
        tie_gap = 0.0
        if n_diff:
            d_pick = 1.0 - (xn[diff] * yn[ki[diff]]).sum(1)
            tie_gap = (d_pick - pd[diff]).abs().max().item()
        check(err <= 1e-5, f"nn1_cosine {label}: distance error {err}")
        check(tie_gap <= 1e-6, f"nn1_cosine {label}: index differs beyond "
              f"a tie ({n_diff} rows, gap {tie_gap})")
        check(bool(torch.isfinite(kd).all()), f"nn1_cosine {label}: finite")
        m, n, d = xn.shape[0], yn.shape[0], xn.shape[1]
        flops = 2.0 * m * n * d
        nbytes = (m + (0 if self_q else n)) * d * 4 + m * (8 + 4)
        bound_ms = max(flops / flops_peak, nbytes / bw_peak) * 1e3
        reps = 5
        k_ms = time_ms(lambda: fused_knn.nn1_cosine_cuda(xn, yn, self_q),
                       reps)
        p_ms = time_ms(lambda: nearest_neighbor(
            xn, None if self_q else yn, exclude_self=self_q), reps)
        row = {"shape": label, "m": m, "n": n, "d": d, "max_abs_err": err,
               "index_mismatches_on_ties": n_diff, "ms": k_ms,
               "plain_ms": p_ms, "bound_ms": bound_ms,
               "bound_by": "operations" if flops / flops_peak
               >= nbytes / bw_peak else "bytes",
               "peak_variant": variant, "reps": reps}
        shapes.append(row)
        emit("kernel", name="nn1_cosine", **row)
    return shapes


def make_cfg():
    from video_similarity_search_tpu_torch.config import get_cfg

    cfg = get_cfg()
    try:
        import yaml  # noqa: F401

        cfg.merge_from_file(os.path.join(
            ROOT, "configs", "resnet_kin_itercluster_flow.yaml"))
        source = "configs/resnet_kin_itercluster_flow.yaml"
    except ImportError:
        source = "merge_from_list (no pyyaml)"
    cfg.merge_from_list(list(KIN_OPTS) + ["OUTPUT_PATH", OUT])
    return cfg, source


def make_batches(rng, n_items, items_per_batch, windows, t, s, n_cls):
    """collate_videos-shaped uint8 batches (data/pipeline.py:363-384); a
    ragged tail is padded by repeating its last item, ``__size__`` real."""
    batches = []
    for start in range(0, n_items, items_per_batch):
        real = min(items_per_batch, n_items - start)
        w = windows[start:start + real]
        w = np.concatenate([w, np.repeat(w[-1:], items_per_batch - real)])
        idx = np.arange(start, start + real)
        idx = np.concatenate([idx, np.repeat(idx[-1:], items_per_batch - real)])
        clips = rng.integers(0, 256, (int(w.sum()), t, s, s, 3), np.uint8)
        batches.append({
            "clip": clips,
            "target": np.repeat((idx % n_cls).astype(np.int32), w),
            "index": np.repeat(idx.astype(np.int32), w),
            "window_counts": w.astype(np.int32),
            "__size__": real,
        })
    return batches


class Timed:
    """Iterable over batches that stamps when each batch is asked for; the
    consumer has finished the previous batch by then (it copies the
    embeddings to the host)."""

    def __init__(self, batches):
        self.batches, self.stamps = batches, []

    def __iter__(self):
        for b in self.batches:
            self.stamps.append(time.perf_counter())
            yield b


def phase_embed():
    import torch

    from video_similarity_search_tpu_torch.evaluation.embed import (
        cache_embeddings, get_embeddings_and_labels)
    from video_similarity_search_tpu_torch.models import model_selector
    from video_similarity_search_tpu_torch.train.steps import make_embed_step
    from video_similarity_search_tpu_torch.data.augment import normalize_only

    cfg, source = make_cfg()
    t, s = cfg.DATA.SAMPLE_DURATION, cfg.DATA.SAMPLE_SIZE
    torch.manual_seed(SEED)
    model = model_selector(cfg)
    rng = np.random.default_rng(SEED)
    n_cls = 40
    train = make_batches(rng, 4096, 256, np.ones(4096, np.int64), t, s, n_cls)
    n_test = 300
    test = make_batches(rng, n_test, 96, rng.integers(1, 5, n_test), t, s,
                        n_cls)

    torch.cuda.reset_peak_memory_stats()
    timed = Timed(train)
    t0 = time.perf_counter()
    tr_emb, tr_lbl, tr_idx = get_embeddings_and_labels(
        model, cfg, timed, split="train", verbose=False, device="cuda")
    t_end = time.perf_counter()
    steady_clips = sum(len(b["clip"]) for b in train[1:])
    clips_per_s = steady_clips / (t_end - timed.stamps[1])
    first_batch_s = timed.stamps[1] - t0
    te_emb, te_lbl, te_idx = get_embeddings_and_labels(
        model, cfg, test, split="test", batch_pad=256, verbose=False,
        device="cuda")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    check(tr_emb.shape == (4096, 128), f"train embeddings {tr_emb.shape}")
    check(te_emb.shape == (n_test, 128), f"test embeddings {te_emb.shape}")
    check(bool(np.isfinite(tr_emb).all() and np.isfinite(te_emb).all()),
          "finite embeddings")
    check(np.array_equal(te_idx, np.arange(n_test)), "test video order")

    # the same model's fp32 forward (TF32 off) on the first batch
    cfg32 = cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    step32 = make_embed_step(cfg32, model, device="cuda")
    x = normalize_only(torch.from_numpy(train[0]["clip"]).cuda(), "kinetics")
    ref = step32(x).cpu().numpy()
    a = tr_emb[:256] / np.linalg.norm(tr_emb[:256], axis=1, keepdims=True)
    b = ref / np.linalg.norm(ref, axis=1, keepdims=True)
    max_cos = float(np.max(1.0 - np.sum(a * b, axis=1)))
    check(max_cos < 0.05, f"bf16 vs fp32 embeddings: cosine distance {max_cos}")

    cache = os.path.join(OUT, "cache")
    cache_embeddings(os.path.join(cache, "train_embeddings_ep0.pkl"),
                     tr_emb, tr_lbl, tr_idx)
    cache_embeddings(os.path.join(cache, "test_embeddings_ep0.pkl"),
                     te_emb, te_lbl, te_idx)
    emit("embed", config=source, arch="R3D-18", clip=[t, s, s, 3],
         batch=256, dtype=str(cfg.TPU.COMPUTE_DTYPE),
         train_clips=4096, test_videos=n_test,
         test_clips=int(sum(b["window_counts"][:b["__size__"]].sum()
                            for b in test)),
         clips_per_s_steady=clips_per_s, first_batch_s=first_batch_s,
         peak_mem_gib=peak_gib, max_cos_dist_vs_fp32=max_cos)
    return model, cfg, tr_emb, cache


def phase_cluster(bank: np.ndarray, bank_lbl: np.ndarray, emb4096):
    import torch

    from video_similarity_search_tpu_torch.cluster import finch as finch_mod
    from video_similarity_search_tpu_torch.cluster.fit import fit_cluster
    from video_similarity_search_tpu_torch.ops import fused_knn

    launches = {}
    fused_knn.LAUNCHES = 0
    t0 = time.perf_counter()
    c, num_clust, _ = finch_mod.FINCH(bank, verbose=False, device="cuda")
    finch_s = time.perf_counter() - t0
    launches["FINCH"] = fused_knn.LAUNCHES
    check(launches["FINCH"] == 1, f"FINCH launched nn1_cosine "
          f"{launches['FINCH']} times, expected 1")

    fused_knn.LAUNCHES = 0
    t0 = time.perf_counter()
    labels = fit_cluster(bank, method="finch", verbose=False, device="cuda")
    fit_s = time.perf_counter() - t0
    launches["fit_cluster"] = fused_knn.LAUNCHES
    check(launches["fit_cluster"] == 1, "fit_cluster launched nn1_cosine "
          f"{launches['fit_cluster']} times, expected 1")
    check(np.array_equal(labels, c[:, 0]), "fit_cluster = FINCH partition 0")
    nmis = [nmi(bank_lbl, c[:, p]) for p in range(c.shape[1])]

    # level 0 on a 20k subsample, sparse (kernel) against dense
    sub = torch.from_numpy(bank[:20000]).cuda()
    ls = finch_mod._sparse_level0(sub, "cosine")[0].cpu().numpy()
    ld = finch_mod._dense_level(sub, 0.0)[0].cpu().numpy()
    check(same_partition(ls, ld), "sparse level 0 = dense level 0 on 20k")

    fused_knn.LAUNCHES = 0
    c2, num2, _ = finch_mod.FINCH(emb4096, verbose=False, device="cuda")
    check(fused_knn.LAUNCHES == 0, "4096 points take the dense path")
    emit("cluster", n=int(bank.shape[0]), d=int(bank.shape[1]),
         partitions=num_clust, finch_s=finch_s, fit_cluster_s=fit_s,
         nmi_vs_planted=nmis, launches=launches,
         parity_20k_sparse_vs_dense=True, dense_4096_partitions=num2)
    return launches["FINCH"]


def phase_retrieval(model, cfg, cache, bank):
    import torch

    from video_similarity_search_tpu_torch.evaluation.knn import \
        k_nearest_embeddings
    from video_similarity_search_tpu_torch.ops.pdist import (l2_normalize,
                                                              topk_neighbors)

    acc = k_nearest_embeddings(model, cfg, None, None, epoch=0,
                               cache_dir=cache, device="cuda")
    check(sorted(acc) == [1, 5, 10, 20], f"retrieval keys {sorted(acc)}")
    check(all(0.0 <= v <= 1.0 for v in acc.values()), "accuracies in [0,1]")

    q_np, _ = mixture(9537, seed=7)
    q = torch.from_numpy(q_np).cuda()
    b = torch.from_numpy(bank).cuda()
    k = 50
    idx, val = topk_neighbors(q, b, k)
    torch.cuda.synchronize()
    check(idx.shape == (q.shape[0], k) and bool(torch.isfinite(val).all()),
          "top-k shape and finite values")
    # a reference on 16 queries: a stable full sort of the distance rows
    d = 1.0 - l2_normalize(q[:16]) @ l2_normalize(b).T
    ref = torch.sort(d, dim=1, stable=True).indices[:, :k]
    check(bool((ref == idx[:16]).all()), "top-k equals a full stable sort")
    ms = time_ms(lambda: topk_neighbors(q, b, k), reps=3)
    emit("retrieval", topk_acc={f"top{k_}": v for k_, v in acc.items()},
         topk_queries=int(q.shape[0]), topk_bank=int(bank.shape[0]), k=k,
         topk_ms=ms)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "video_similarity_search_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    os.makedirs(OUT, exist_ok=True)

    from video_similarity_search_tpu_torch.ops import fused_knn

    smi = phase_device()
    bank, bank_lbl = mixture(240_000, seed=0)
    shapes = phase_kernel_nn1(smi, bank)
    model, cfg, emb4096, cache = phase_embed()
    finch_launches = phase_cluster(bank, bank_lbl, emb4096)
    phase_retrieval(model, cfg, cache, bank)
    check(fused_knn.LAUNCHES == 0, "retrieval launches no 1-NN kernel")

    main_shape = shapes[-1]
    src, replaces = KERNELS["nn1_cosine"]
    print(json.dumps({"kernels": [{
        "name": "nn1_cosine", "route": "cuda", "source": src,
        "replaces": replaces, "launches": finch_launches,
        "max_abs_err": max(r["max_abs_err"] for r in shapes),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"], "library_ms": None,
        "shape": main_shape["shape"], "shapes": shapes}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
