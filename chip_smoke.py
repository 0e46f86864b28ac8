#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Drives the port's serving path (video_similarity_search_tpu_torch) at the
full width of the Kinetics config (configs/resnet_kin_itercluster_flow.yaml:
R3D-18, 16x128x128 clips, 128-d embeddings) with random seeded weights and
data, in phases that each print one JSON line:

  device     card name and power limit, torch/CUDA versions, kernel builds
             (nvcc, sm_90a, all sources at once) with ptxas' registers,
             spills and shared memory, and the SASS opcode counts
             (cuobjdump; nn1_cosine must hold HGMMA and UTMALDG)
  kernel     each hand-written kernel against its plain PyTorch version on
             the card, at the path's shapes (ties, near ties, padding of D,
             D > 128 and ragged edges included), with its time beside the
             3xTF32 tensor-core bound and the fp32 CUDA-core bound; at 240k
             the kernel's picks and level-0 partition are held to an fp64
             1-NN (the plain version's are reported beside them)
  embed      get_embeddings_and_labels over 4096 train clips (batches of
             256) and a multi-window test split; clips/s, peak memory, and
             the bf16 embeddings against the fp32 forward
  cluster    FINCH / fit_cluster("finch") over the 240,000 x 128 planted
             mixture of perf_experiments/cluster_240k_r4.py (sparse level 0
             through the CUDA 1-NN kernel), sparse-vs-dense level-0 parity on
             20k points, and FINCH on the 4096 embeddings (dense path)
  retrieval  k_nearest_embeddings over the embed phase's embeddings, and
             top-50 of 9,537 queries over the 240k bank

and the host data path, on the UCF config
(configs/resnet_ucf_itercluster_flow.yaml, with only the data paths set):

  host       the host's compiler, libjpeg header and library, OpenCV and
             PIL, core count, and the port's native JPEG decoder build (the
             decode backend, ``native`` or ``pil``, is printed loudly)
  data       a seeded synthetic UCF-layout JPEG dataset (40 classes x 12
             videos at 320x240, optical_u frames) under runs/chip_smoke/,
             reused when present; loader-only clips/s of the eval train
             loader (batch 256, >= 2048 clips) and the test loader, clips per
             decode path, and one item of each held byte-equal to a direct
             ClipReader.load
  embed_loader  get_embeddings_and_labels fed by that loader with the
             pinned side-stream upload on, then off (pageable copy in the
             consumer): clips/s, the consumer's wait per batch, copy ms
  cluster_step  iterative_cluster_step over the eval train loader, its files
             held to this script's own NMI, then the triplet loader rebuilt
             from the labels (host RandomResizedCrop); NMI/AMI timed at UCF
             scale
  cli        python -m video_similarity_search_tpu_torch.cli.evaluate on the
             dataset from a .pth.tar of the smoke's model

and the triplet pretrain, on the UCF config at full width:

  train_step  R3D-18 from seed 0 on 32 anchors + 32 positives + 32 anchor2
             = 96 pre-cropped uint8 clips from seed 0: (a) one fp32 step on
             the card held to the CPU (2 anchors; loss, negatives,
             augmentation) and to an fp64 CPU run (update, BN statistics);
             (b) bf16 against fp32 and fp64 at full width (loss, gradient
             cosine, n_triplets); (c) ms a bf16 step, split by CUDA events
             into augment / forward+loss / backward / optimizer, clips/s,
             peak GiB, ACCUM_STEPS 2 beside 1; (d) 30 steps on one fixed
             batch lower the triplet loss
  train_cli  python -m video_similarity_search_tpu_torch.cli.online_train
             --iterative_cluster for 2 epochs on 20 classes of the synthetic
             set (220 train, 20 validation videos), the
             evaluate CLI on its checkpoint, a third epoch resumed from it;
             the loader-fed clips/s beside train_step's

then a ``timing`` line of each phase's seconds, the ``kernels`` summary line, the ``nvidia-smi`` name/power-limit line
and ``{"ok": true, "device": {...}}`` as the last line. Each kernel's launch
counter is set to 0 just before a path runs and read just after; a path that
did not launch its kernel fails the run, as does any failed check.

Usage: python3 chip_smoke.py     (needs one CUDA card; exits non-zero
without one, and outside a checkout of the repository)
"""

from __future__ import annotations

import collections
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
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

# (fp32 CUDA-core FLOP/s, TF32 tensor-core FLOP/s, HBM bytes/s) from
# NVIDIA's data sheets, dense (the TF32 rate is half the sparse figure)
PEAKS = {"PCIe": (51e12, 378e12, 2.0e12), "NVL": (60e12, 417.5e12, 3.9e12),
         "SXM": (67e12, 495e12, 3.35e12)}
# nn1_cosine's fp32-accurate products take three TF32 passes (3xTF32)
TF32_PASSES = 3

KIN_OPTS = ["MODEL.ARCH", "3dresnet", "RESNET.MODEL_DEPTH", 18,
            "RESNET.SHORTCUT", "B", "RESNET.CONV1_T_SIZE", 7,
            "RESNET.CONV1_T_STRIDE", 1, "RESNET.NO_MAX_POOl", True,
            "RESNET.WIDEN_FACTOR", 1, "RESNET.HIDDEN_LAYER", 2048,
            "RESNET.OUT_DIM", 128, "DATA.SAMPLE_SIZE", 128,
            "DATA.SAMPLE_DURATION", 16, "DATA.INPUT_CHANNEL_NUM", 3,
            "TRAIN.DATASET", "kinetics"]

UCF_YAML = os.path.join(ROOT, "configs", "resnet_ucf_itercluster_flow.yaml")
# the synthetic UCF-layout dataset: UCF-101's 320x240 frames; train videos
# are 2 x SAMPLE_DURATION frames long, the shortest the manifest keeps
SYN = {"classes": 40, "videos_per_class": 12, "height": 240, "width": 320,
       "train_frames": 32, "test_frames": 64, "seed": SEED}
LOADER_EPOCHS = 3  # 3 x 440 train clips (5 before the train phases)
EMBED_EPOCHS = 2  # each embed pass, upload on and off
MIN_LOADER_CLIPS = 1280
EVAL_BATCH = 256  # the UCF config's automatic eval batch at 440 videos


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

def sass_opcodes(lib: str) -> dict:
    """Opcode counts of a built library's SASS (``cuobjdump -sass``)."""
    from video_similarity_search_tpu_torch.ops.cuda_build import find_nvcc

    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                     sass)
    return dict(collections.Counter(ops).most_common())


def key_opcodes(counts: dict) -> dict:
    """The opcodes that show the route: tensor-core products (HGMMA), TMA
    loads (UTMALDG), and fp32 FMAs on the CUDA cores (FFMA)."""
    return {op: counts.get(op, 0) for op in ("HGMMA", "UTMALDG", "FFMA")}


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
                    .splitlines() if "registers" in ln or "spill" in ln
                    or "smem" in ln]
             for name in KERNELS}
    sass = {name: sass_opcodes(lib) for name, lib in libs.items()}
    smem = cuda_build.load("nn1_cosine").nn1_cosine_smem_bytes
    smem_bytes = {f"nn1_cosine d_pad={d}": smem(d) for d in (128, 256)}
    for op in ("HGMMA", "UTMALDG"):
        check(sass["nn1_cosine"].get(op, 0) > 0,
              f"nn1_cosine's SASS has {op} (tensor cores fed by TMA)")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls in IEEE float32 (allow_tf32 off)")
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), build_s=build_s,
         libraries={k: os.path.relpath(v, ROOT) for k, v in libs.items()},
         ptxas=ptxas, dynamic_smem_bytes=smem_bytes, sass=sass)
    return smi, sass


def phase_kernel_nn1(smi: str, sass: dict, bank: np.ndarray):
    """nn1_cosine against ops/pdist.nearest_neighbor (tiled torch.mm +
    masked argmin, IEEE fp32) on the same inputs. Distances within 1e-5;
    an index may differ only where its distance is within 1e-6 of the
    plain minimum (a tie under another summation order)."""
    import torch

    from video_similarity_search_tpu_torch.ops import fused_knn
    from video_similarity_search_tpu_torch.ops.pdist import (l2_normalize,
                                                              nearest_neighbor)

    variant, (fp32_peak, tf32_peak, bw_peak) = peaks_for(smi)
    rng = np.random.default_rng(SEED)
    dup = rng.normal(size=(1366, 128)).astype(np.float32)
    near = np.concatenate([dup] + [
        dup * (1 + 1e-6 * rng.normal(size=dup.shape)) for _ in range(2)])
    queries, _ = mixture(9537, seed=7)
    wave = 128 * torch.cuda.get_device_properties(0).multi_processor_count
    cases = [
        ("self 37x16", rng.normal(size=(37, 16)), None),
        ("cross 37x53x16", rng.normal(size=(37, 16)),
         rng.normal(size=(53, 16))),
        ("cross 37x53x20 (D padded to 32)", rng.normal(size=(37, 20)),
         rng.normal(size=(53, 20))),
        ("self 3000x256 (A streamed)", rng.normal(size=(3000, 256)), None),
        ("self 4096x128 ties", np.concatenate([dup, dup, dup])[:4096], None),
        ("self 4096x128 near ties", near[:4096], None),
        ("cross 9537x240000x128", queries, bank),
        # L2 probes: one CTA per SM sweeping a bank that stays in L2 (24.6
        # MB in hi + lo) or the 240k bank; then the 240k bank with half the
        # SMs pulling from L2. Equal per-SM rates: L2 does not set the pace
        (f"cross {wave}x24000x128 (one wave, bank in L2)", bank[:wave],
         bank[:24000]),
        (f"cross {wave}x240000x128 (one wave)", bank[:wave], bank),
        (f"cross {wave // 2}x240000x128 (half the SMs)", bank[:wave // 2],
         bank),
        ("self 240000x128", bank, None),
    ]
    sass_key = key_opcodes(sass["nn1_cosine"])
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
        extra = {}
        if label == "self 240000x128":
            extra = fp64_referee(xn, ki, kd, pi, pd)
        m, n, d = xn.shape[0], yn.shape[0], xn.shape[1]
        flops = 2.0 * m * n * d
        nbytes = (m + (0 if self_q else n)) * d * 4 + m * (8 + 4)
        tc_s, mem_s = TF32_PASSES * flops / tf32_peak, nbytes / bw_peak
        reps = 5
        k_ms = time_ms(lambda: fused_knn.nn1_cosine_cuda(xn, yn, self_q),
                       reps)
        p_ms = time_ms(lambda: nearest_neighbor(
            xn, None if self_q else yn, exclude_self=self_q), reps)
        row = {"shape": label, "m": m, "n": n, "d": d, "max_abs_err": err,
               "index_mismatches_on_ties": n_diff, "max_tie_gap": tie_gap,
               "ms": k_ms, "plain_ms": p_ms,
               "bound_ms": max(tc_s, mem_s) * 1e3,
               "bound_by": "operations" if tc_s >= mem_s else "bytes",
               "fp32_simt_bound_ms": max(flops / fp32_peak, mem_s) * 1e3,
               "tflops_fp32_accurate": flops / (k_ms * 1e-3) / 1e12,
               "peak_variant": variant, "reps": reps, "sass": sass_key,
               **extra}
        shapes.append(row)
        emit("kernel", name="nn1_cosine", **row)
    return shapes


def fp64_referee(xn, ki, kd, pi, pd, tile: int = 512) -> dict:
    """Holds the kernel's 240k self-query result (``ki``, ``kd``) to an
    fp64 1-NN: a pick may differ from it only where the two lie within 1e-6
    in exact distance, and the level-0 partition (connected components of
    the picks) must be the fp64 one. The plain version's (``pi``, ``pd``) is
    reported beside it: on a near tie, IEEE fp32 in cuBLAS's order may pick
    otherwise."""
    from video_similarity_search_tpu_torch.ops.cc import connected_components
    from video_similarity_search_tpu_torch.utils.nn1_accumulation import \
        fp64_nearest

    ti, td = fp64_nearest(xn, tile)
    x64 = xn.double()

    def wrong(picks):
        bad = picks != ti
        gap = 1.0 - (x64[bad] * x64[picks[bad]]).sum(1) - td[bad]
        return int(bad.sum()), float(gap.max()) if bad.any() else 0.0

    parts = {k: connected_components(v).cpu().numpy()
             for k, v in (("fp64", ti), ("kernel", ki), ("plain", pi))}
    k_wrong, k_gap = wrong(ki)
    p_wrong, p_gap = wrong(pi)
    same = same_partition(parts["kernel"], parts["fp64"])
    check(k_gap <= 1e-6, f"240k: the kernel's pick differs from fp64 by "
          f"{k_gap} in exact distance")
    check(same, "240k level-0 partition: kernel = fp64 referee")
    return {"max_abs_err_vs_fp64_kernel": float((kd.double() - td).abs().max()),
            "max_abs_err_vs_fp64_plain": float((pd.double() - td).abs().max()),
            "fp64_rows_differ_kernel": k_wrong, "fp64_gap_kernel": k_gap,
            "fp64_rows_differ_plain": p_wrong, "fp64_gap_plain": p_gap,
            "level0_partition_kernel_eq_fp64": same,
            "level0_partition_plain_eq_fp64": same_partition(
                parts["plain"], parts["fp64"]),
            "level0_partition_kernel_eq_plain": same_partition(
                parts["kernel"], parts["plain"])}


def load_cfg(yaml_path: str, opts) -> object:
    """A config through the port's own CLI parser: defaults -> YAML ->
    opts."""
    from video_similarity_search_tpu_torch.config import (arg_parser,
                                                          load_config)

    return load_config(arg_parser().parse_args(
        ["--cfg", yaml_path] + [str(v) for v in opts]))


def make_cfg():
    cfg = load_cfg(os.path.join(ROOT, "configs",
                                "resnet_kin_itercluster_flow.yaml"),
                   list(KIN_OPTS) + ["OUTPUT_PATH", OUT])
    return cfg, "configs/resnet_kin_itercluster_flow.yaml"


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
    timed = Epochs(train, 1)
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


# --------------------------------------------------------------------------
# host data path: UCF config, synthetic JPEGs, loaders, clustering step, CLI

def _compiles(gxx: str, source: str, args) -> bool:
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cpp")
        with open(src, "w") as f:
            f.write(source)
        proc = subprocess.run([gxx, src, *args, "-o",
                               os.path.join(tmp, "probe")],
                              capture_output=True, text=True, timeout=120)
        return proc.returncode == 0


def phase_host():
    """Host libraries the data path could use, and the native decoder's
    build. -> the decode backend, "native" or "pil"."""
    import PIL
    from PIL import features

    from video_similarity_search_tpu_torch.data import native_loader

    gxx = shutil.which("g++")
    header = link = False
    if gxx:
        header = _compiles(gxx, "#include <cstdio>\n#include <jpeglib.h>\n"
                           "int main() { return 0; }\n", [])
        # the library alone, declared by hand: no header needed
        link = _compiles(gxx, 'extern "C" void* jpeg_std_error(void*);\n'
                         "int main() { return jpeg_std_error(0) != 0; }\n",
                         ["-ljpeg"])
    cv2 = subprocess.run([sys.executable, "-c",
                          "import cv2; print(cv2.__version__)"],
                         capture_output=True, text=True, timeout=120)
    t0 = time.perf_counter()
    built = native_loader.available()
    build_s = time.perf_counter() - t0
    backend = "native" if built else "pil"
    emit("host", cpu_count=os.cpu_count(), gxx=gxx,
         jpeglib_h=header, ljpeg_link=link,
         cv2=cv2.stdout.strip() if cv2.returncode == 0 else None,
         pil=PIL.__version__,
         pil_libjpeg_turbo=features.check_feature("libjpeg_turbo"),
         native_decoder_built=built, native_build_s=build_s,
         native_library=(os.path.relpath(native_loader.LIB_PATH, ROOT)
                         if built else None),
         native_build_log=None if built else native_loader.BUILD_LOG[-400:],
         decoder=backend)
    if built:
        print("decoder: native", flush=True)
    else:
        msg = ("decoder: pil  <<< the native JPEG decoder did not build on "
               "this host (libjpeg header or library missing); every RGB "
               "clip is decoded by PIL and resized in torch >>>")
        print(msg, flush=True)
        print(msg, file=sys.stderr, flush=True)
    return backend


def _write_video(job) -> None:
    """Frames of one synthetic video: a smooth class-coloured pattern that
    drifts sideways ``speed`` pixels a frame (small JPEGs, real motion)."""
    from PIL import Image

    vdir, n, color, freq, phase, speed, gray = job
    h, w = SYN["height"], SYN["width"]
    yy, xx = np.mgrid[0:h, 0:w + speed * n].astype(np.float32)
    wave = np.sin(xx * freq + phase) + 0.5 * np.cos(yy * freq * 1.7 + phase)
    os.makedirs(vdir, exist_ok=True)
    if gray:  # optical_u: one channel, TVL1 layout frame%06d.jpg
        canvas = np.clip(128 + 60 * wave, 0, 255).astype(np.uint8)
        name = "frame{:06d}.jpg"
    else:
        canvas = np.clip(128 + 80 * wave[..., None] * color, 0,
                         255).astype(np.uint8)
        name = "image_{:05d}.jpg"
    for f in range(n):
        frame = np.ascontiguousarray(canvas[:, speed * f:speed * f + w])
        Image.fromarray(frame).save(os.path.join(vdir, name.format(f + 1)))


def make_ucf_dataset(root: str):
    """Seeded UCF-101-layout dataset (kenshohara JSON, <label>/<vid>/
    image_%05d.jpg, optical_u/<vid>/frame%06d.jpg for the train videos);
    reused when ``root`` holds one made from the same ``SYN``. -> (jpg
    root, annotation path, optical_u root, seconds spent writing)."""
    jpg, flow = os.path.join(root, "jpg"), os.path.join(root, "optical_u")
    ann_path = os.path.join(root, "annotation.json")
    marker = os.path.join(root, "done.json")
    spec = json.dumps(SYN, sort_keys=True)
    if os.path.exists(marker):
        with open(marker) as f:
            if f.read() == spec:
                return jpg, ann_path, flow, 0.0
    t0 = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(SYN["seed"])
    labels = [f"class{c:02d}" for c in range(SYN["classes"])]
    database, jobs = {}, []
    for label in labels:
        color = rng.uniform(0.2, 1.0, 3).astype(np.float32)
        freq = float(rng.uniform(0.01, 0.05))
        for v in range(SYN["videos_per_class"]):
            test = v == SYN["videos_per_class"] - 1
            n = SYN["test_frames"] if test else SYN["train_frames"]
            vid = f"v_{label}_g{v:02d}_c01"
            phase, speed = float(rng.uniform(0, 6.28)), int(rng.integers(1, 5))
            jobs.append((os.path.join(jpg, label, vid), n, color, freq, phase,
                         speed, False))
            if not test:
                jobs.append((os.path.join(flow, vid), n, color, freq * 1.3,
                             phase, speed, True))
            database[vid] = {"subset": "test" if test else "training",
                             "annotations": {"label": label,
                                             "segment": [1, n + 2]}}
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        list(pool.map(_write_video, jobs))
    with open(ann_path, "w") as f:
        json.dump({"labels": labels, "database": database}, f)
    with open(marker, "w") as f:
        f.write(spec)
    return jpg, ann_path, flow, time.perf_counter() - t0


def ucf_cfg(jpg: str, ann: str, flow: str, output: str):
    """configs/resnet_ucf_itercluster_flow.yaml with the data paths of the
    synthetic dataset (and OUTPUT_PATH)."""
    return load_cfg(UCF_YAML, ["DATASET.VID_PATH", jpg,
                               "DATASET.ANNOTATION_PATH", ann,
                               "DATASET.OPTICAL_U_PATH", flow,
                               "OUTPUT_PATH", output])


def real_clips(batch) -> int:
    counts = np.asarray(batch["window_counts"])
    return int(counts[:int(batch["__size__"])].sum())


class Epochs:
    """``n`` passes over a loader (a PrefetchLoader or a list of batches)
    as one iterable. Stamps when each batch is asked for (the consumer
    has finished the previous one by then: it copies the embeddings to
    the host), and gathers a PrefetchLoader's per-batch consumer waits and
    copy events of every pass."""

    def __init__(self, loader, n: int):
        self.loader, self.n = loader, n
        self.stamps, self.clips, self.waits, self.copies = [], [], [], []

    def __iter__(self):
        for _ in range(self.n):
            it = iter(self.loader)
            while True:
                self.stamps.append(time.perf_counter())
                try:
                    batch = next(it)
                except StopIteration:
                    break
                self.clips.append(real_clips(batch))
                yield batch
            self.stamps.pop()
            self.waits += getattr(self.loader, "wait_s", [])
            self.copies += getattr(self.loader, "copy_events", [])

    def copy_ms(self) -> float | None:
        if not self.copies:
            return None
        self.copies[-1][1].synchronize()
        return float(np.mean([a.elapsed_time(b) for a, b in self.copies]))


def decoded(*datasets) -> dict:
    out = collections.Counter()
    for ds in datasets:
        out.update(ds.reader.decoded)
    return dict(out)


def check_backend(backend: str, counts: dict, what: str) -> None:
    """No RGB clip goes through PIL while the native decoder is built."""
    pil = {k: v for k, v in counts.items() if k.startswith("pil") and v}
    if backend == "native":
        check(not pil, f"{what}: RGB clips decoded by PIL although the "
              f"native decoder is built: {pil}")
    else:
        check(sum(pil.values()) == sum(counts.values()),
              f"{what}: PIL backend, yet {counts}")


def host_breakdown(ds, backend: str) -> dict:
    """Per-clip host costs of the eval decode, one thread, median of 5:
    PIL decode (with its DCT draft) and the torch resize, or the native
    call; and PIL's frames/s over 640 frames at 1, 4 and 8 threads."""
    from video_similarity_search_tpu_torch.data import native_loader
    from video_similarity_search_tpu_torch.data.datasets import \
        _resize_frames
    from video_similarity_search_tpu_torch.data.loaders import (
        ImageLoaderPIL, VideoLoader)

    reader = ds.reader
    size = reader.buffer_size
    s0 = ds.samples[0]
    idx = ds.tt(list(range(1, s0["num_frames"] + 1)))
    fmt = reader.loader.image_name_formatter
    pil = VideoLoader(fmt, ImageLoaderPIL(min_dim=size))

    def median_ms(fn):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    frames = pil(s0["video"], idx)
    out = {"frames_per_clip": len(idx),
           "pil_decode_ms_per_clip": median_ms(lambda: pil(s0["video"], idx)),
           "torch_resize_ms_per_clip": median_ms(lambda: _resize_frames(
               frames, (size, size), keep_aspect_short_edge=size))}
    if backend == "native":
        paths = [os.path.join(s0["video"], fmt(i)) for i in idx]
        out["native_decode_ms_per_clip"] = median_ms(
            lambda: native_loader.decode_frames(paths, size, True))
    paths = [os.path.join(s["video"], fmt(i)) for s in ds.samples[:40]
             for i in idx]
    one = ImageLoaderPIL(min_dim=size)
    for threads in (1, 4, 8):
        t0 = time.perf_counter()
        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(one, paths))
        out[f"pil_frames_per_s_{threads}_threads"] = (
            len(paths) / (time.perf_counter() - t0))
    return out


def phase_data(backend: str):
    """Synthetic dataset, loader-only throughput and byte-equality."""
    import torch

    from video_similarity_search_tpu_torch.data import build_data_loader
    from video_similarity_search_tpu_torch.data.temporal import \
        get_test_video_frame_indices

    jpg, ann, flow, gen_s = make_ucf_dataset(os.path.join(OUT, "ucf_synth"))
    cfg = ucf_cfg(jpg, ann, flow, os.path.join(OUT, "ucf"))
    train_loader, (train_ds, _) = build_data_loader(
        "train", cfg, triplets=False, req_train_shuffle=False,
        drop_last=False, device="cuda")
    test_loader, (test_ds, _) = build_data_loader(
        "test", cfg, triplets=False, drop_last=False, batch_size=1,
        device="cuda")
    n_train, n_test = len(train_ds), len(test_ds)
    check(n_train == SYN["classes"] * (SYN["videos_per_class"] - 1)
          and n_test == SYN["classes"], f"manifests {n_train}, {n_test}")
    check(train_loader.batch_size == EVAL_BATCH,
          f"eval batch {train_loader.batch_size}")
    check(train_loader.device_upload, "upload on")

    rates = {}
    for name, loader, epochs in (("train", train_loader, LOADER_EPOCHS),
                                 ("test", test_loader, 1)):
        passes = Epochs(loader, epochs)
        t0 = time.perf_counter()
        for _ in passes:
            pass
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rates[name] = {"clips": sum(passes.clips), "seconds": secs,
                       "clips_per_s": sum(passes.clips) / secs,
                       "batches": len(passes.clips),
                       "copy_ms_mean": passes.copy_ms()}
    check(rates["train"]["clips"] >= MIN_LOADER_CLIPS,
          f"loader-only run >= {MIN_LOADER_CLIPS} clips")
    counts = {"train": decoded(train_ds), "test": decoded(test_ds)}
    check_backend(backend, counts["train"], "eval train loader")
    check_backend(backend, counts["test"], "test loader")
    breakdown = host_breakdown(train_ds, backend)  # no producer running

    # one item of each loader against a direct ClipReader.load
    batch = next(iter(train_loader))
    clip = batch["clip"][0].cpu().numpy()
    s0 = train_ds.samples[0]
    direct = train_ds.reader.load(s0, train_ds.tt(
        list(range(1, s0["num_frames"] + 1))))
    check(np.array_equal(clip, direct), "eval train item = ClipReader.load")
    batch = next(iter(test_loader))
    clips = batch["clip"].cpu().numpy()
    t0s = test_ds.samples[0]
    wins = get_test_video_frame_indices(t0s["num_frames"],
                                        cfg.DATA.SAMPLE_DURATION)
    direct = np.stack([test_ds.reader.load(t0s, w) for w in wins])
    check(int(batch["window_counts"][0]) == len(wins) == 4
          and np.array_equal(clips[:len(wins)], direct),
          "test item (4 windows) = ClipReader.load")
    emit("data", dataset={**SYN, "train_videos": n_train,
                          "test_videos": n_test},
         written_s=gen_s, reused=gen_s == 0.0, decoder=backend,
         loader_only=rates, decoded_clips=counts, host_breakdown=breakdown,
         num_workers=cfg.TRAIN.NUM_DATA_WORKERS,
         prefetch_depth=cfg.TPU.PREFETCH_DEPTH, byte_equal_items=True)
    return cfg, (jpg, ann, flow), train_loader, train_ds


def phase_embed_loader(cfg, train_loader, backend: str):
    """The embedding pass fed by the JPEG loader, upload on, then off."""
    import torch

    from video_similarity_search_tpu_torch.data import build_data_loader
    from video_similarity_search_tpu_torch.evaluation.embed import \
        get_embeddings_and_labels
    from video_similarity_search_tpu_torch.models import model_selector

    torch.manual_seed(SEED)
    model = model_selector(cfg)
    off_loader, (off_ds, _) = build_data_loader(
        "train", cfg, triplets=False, req_train_shuffle=False,
        drop_last=False, device="cpu")  # batches stay on the host
    check(not off_loader.device_upload, "upload off")
    runs, embs = {}, {}
    for name, loader in (("upload_on", train_loader),
                         ("upload_off", off_loader)):
        passes = Epochs(loader, EMBED_EPOCHS)
        emb, _, idx = get_embeddings_and_labels(
            model, cfg, passes, split="train", verbose=False, device="cuda")
        t_end = time.perf_counter()
        steady = sum(passes.clips[1:]) / (t_end - passes.stamps[1])
        n = len(loader.dataset)
        check(emb.shape == (EMBED_EPOCHS * n, cfg.RESNET.OUT_DIM)
              and bool(np.isfinite(emb).all()), f"{name} embeddings")
        check(np.array_equal(idx[:n], np.arange(n)), f"{name} order")
        embs[name] = emb[:n]
        runs[name] = {"clips": sum(passes.clips),
                      "clips_per_s_steady": steady,
                      "wait_ms_mean": 1e3 * float(np.mean(passes.waits)),
                      "wait_ms_max": 1e3 * float(np.max(passes.waits)),
                      "copy_ms_mean": passes.copy_ms(),
                      "batches": len(passes.clips)}
    a, b = (embs[k] / np.linalg.norm(embs[k], axis=1, keepdims=True)
            for k in ("upload_on", "upload_off"))
    max_cos = float(np.max(1.0 - np.sum(a * b, axis=1)))
    check(max_cos < 1e-3, f"upload on vs off: cosine distance {max_cos}")
    check_backend(backend, decoded(off_ds), "upload-off loader")
    emit("embed_loader", arch="R3D-18", config="configs/resnet_ucf_itercluster_flow.yaml",
         batch=train_loader.batch_size, epochs=EMBED_EPOCHS, **runs,
         max_cos_dist_on_vs_off=max_cos)
    return model, embs["upload_on"]


def phase_cluster_step(cfg, model, train_loader, train_ds, backend: str):
    import torch

    from video_similarity_search_tpu_torch.data import build_data_loader
    from video_similarity_search_tpu_torch.ops import fused_knn
    from video_similarity_search_tpu_torch.train.driver import \
        iterative_cluster_step
    from video_similarity_search_tpu_torch.utils.cluster_metrics import (
        adjusted_mutual_info, normalized_mutual_info)

    cfg = cfg.clone()
    cfg.OUTPUT_PATH = os.path.join(OUT, "cluster_step")
    shutil.rmtree(cfg.OUTPUT_PATH, ignore_errors=True)
    fused_knn.LAUNCHES = 0
    t0 = time.perf_counter()
    labels = iterative_cluster_step(model, cfg, train_loader, device="cuda")
    step_s = time.perf_counter() - t0
    launches = fused_knn.LAUNCHES
    check(launches == 0, f"{len(train_ds)} embeddings take FINCH's dense "
          f"level 0, yet nn1_cosine launched {launches} times")
    with open(os.path.join(cfg.OUTPUT_PATH, "vid_clusters.txt")) as f:
        lines = [ln for ln in f.read().splitlines() if ln]
    check(len(lines) == len(train_ds), "vid_clusters.txt: one line a video")
    check(np.array_equal(np.array(lines, np.int64), labels),
          "vid_clusters.txt holds the returned labels in dataset order")
    true = np.array([s["label"] for s in train_ds.samples])
    own = nmi(true, labels)
    check(abs(normalized_mutual_info(true, labels) - own) <= 1e-9,
          "port NMI = this script's nmi() within 1e-9")
    logs = os.path.join(cfg.OUTPUT_PATH, "tnet_checkpoints")
    with open(os.path.join(logs, "NMIs.txt")) as f:
        file_nmi = float(f.read().split()[-1])
    check(abs(file_nmi - own) <= 5e-7, "NMIs.txt = nmi() to its 6 decimals")
    with open(os.path.join(logs, "AMIs.txt")) as f:
        file_ami = float(f.read().split()[-1])

    # the triplet loader rebuilt from the pseudo-labels (host RRC on)
    trip_loader, (trip_ds, _) = build_data_loader(
        "train", cfg, triplets=True, cluster_labels=labels, device="cuda")
    check(trip_ds.target_type == "cluster_label", "targets: cluster labels")
    check(trip_ds.reader.rrc_size == cfg.DATA.SAMPLE_SIZE, "host RRC on")
    t0 = time.perf_counter()
    it, shapes = iter(trip_loader), None
    for _ in range(2):
        b = next(it)
        bsz = int(b["__size__"])
        idx = np.asarray(b["index"])
        check(np.array_equal(np.asarray(b["targets"])[:bsz], labels[idx]),
              "anchor targets = cluster labels of the anchor indices")
        shapes = {k: list(b[k].shape) for k in ("anchor", "positive", "extra")
                  if k in b}
        for k in shapes:
            check(shapes[k][1:] == [cfg.DATA.SAMPLE_DURATION,
                                    cfg.DATA.SAMPLE_SIZE,
                                    cfg.DATA.SAMPLE_SIZE, 3],
                  f"triplet {k} clip shape {shapes[k]}")
            check(isinstance(b[k], torch.Tensor) and b[k].is_cuda,
                  f"triplet {k} uploaded")
    del it
    trip_s = time.perf_counter() - t0
    counts = decoded(trip_ds)
    check_backend(backend, counts, "triplet loader")
    check(counts.get("native_rrc" if backend == "native" else "pil_rrc", 0)
          > 0, f"host RRC decode ran: {counts}")

    # NMI / AMI at UCF scale: 9,537 labels, 101 classes, ~1,000 clusters
    rng = np.random.default_rng(SEED)
    t_lbl = rng.integers(0, 101, 9537)
    p_lbl = rng.integers(0, 1000, 9537)
    t0 = time.perf_counter()
    nmi_ucf = normalized_mutual_info(t_lbl, p_lbl)
    nmi_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ami_ucf = adjusted_mutual_info(t_lbl, p_lbl)
    ami_ms = (time.perf_counter() - t0) * 1e3
    check(abs(nmi_ucf - nmi(t_lbl, p_lbl)) <= 1e-9, "NMI at UCF scale")
    emit("cluster_step", videos=len(train_ds), step_s=step_s,
         clusters=int(len(np.unique(labels))), nmi=own, nmi_file=file_nmi,
         ami_file=file_ami, nn1_cosine_launches=launches,
         triplet_batches=2, triplet_batch=trip_loader.batch_size,
         triplet_shapes=shapes, triplet_s=trip_s,
         triplet_decoded_clips=counts,
         ucf_scale={"labels": 9537, "classes": 101,
                    "clusters": int(len(np.unique(p_lbl))),
                    "nmi_ms": nmi_ms, "ami_ms": ami_ms, "nmi": nmi_ucf,
                    "ami": ami_ucf})


def phase_cli(cfg, paths, model, emb_in_process):
    """The evaluate CLI, as a user runs it, on a .pth.tar of the model; its
    embeddings held against in-process passes of the same model."""
    import pickle

    import torch

    from video_similarity_search_tpu_torch.data import build_data_loader
    from video_similarity_search_tpu_torch.evaluation.embed import \
        get_embeddings_and_labels

    jpg, ann, flow = paths
    work = os.path.join(OUT, "cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ckpt = os.path.join(work, "r3d18_seed0.pth.tar")
    torch.save({"state_dict": {"module." + k: v.detach().cpu()
                               for k, v in model.state_dict().items()},
                "epoch": 0}, ckpt)
    out = os.path.join(work, "out")
    cmd = [sys.executable, "-m", "video_similarity_search_tpu_torch.cli.evaluate",
           "--cfg", UCF_YAML, "--checkpoint_path", ckpt, "--output", out,
           "--device", "cuda", "DATASET.VID_PATH", jpg,
           "DATASET.ANNOTATION_PATH", ann, "DATASET.OPTICAL_U_PATH", flow]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"evaluate CLI exit {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    with open(os.path.join(out, "tnet_checkpoints",
                           "global_retrieval_acc.txt")) as f:
        line = f.read().strip()
    check(re.fullmatch(r"epoch:0 top1:[01]\.\d{4} top5:[01]\.\d{4} "
                       r"top10:[01]\.\d{4} top20:[01]\.\d{4}", line) is not None,
          f"global_retrieval_acc.txt line {line!r}")
    embs = {}
    for split in ("train", "test"):
        with open(os.path.join(out, f"{split}_embeddings.pkl"), "rb") as f:
            embs[split] = pickle.load(f)["embeddings"]
    n_train = SYN["classes"] * (SYN["videos_per_class"] - 1)
    check(embs["train"].shape == (n_train, 128)
          and embs["test"].shape == (SYN["classes"], 128)
          and all(bool(np.isfinite(e).all()) for e in embs.values()),
          "CLI embeddings: shapes and finite values")
    # the test split in-process: sliding windows averaged, as the CLI does
    test_loader, _ = build_data_loader(
        "test", cfg, triplets=False, drop_last=False, batch_size=1,
        device="cuda")
    test_in_process, _, _ = get_embeddings_and_labels(
        model, cfg, test_loader, split="test", verbose=False, device="cuda")
    max_cos = {}
    for split, ref in (("train", emb_in_process), ("test", test_in_process)):
        a = embs[split] / np.linalg.norm(embs[split], axis=1, keepdims=True)
        b = ref / np.linalg.norm(ref, axis=1, keepdims=True)
        max_cos[split] = float(np.max(1.0 - np.sum(a * b, axis=1)))
        # same weights, inputs and path: only cuDNN's choice of algorithm
        # may differ between the two processes
        check(max_cos[split] < 1e-5,
              f"CLI {split} embeddings vs in-process: {max_cos[split]}")
    emit("cli", command=" ".join(cmd[1:4]) + " ...", wall_s=wall,
         retrieval=line, max_cos_dist_vs_in_process=max_cos,
         stdout_tail=proc.stdout.strip().splitlines()[-3:])


# --------------------------------------------------------------------------
# the triplet pretrain: the train step at full width, then the training CLI

TRAIN_VIEWS = ("anchor", "positive", "extra")
TRAIN_CLI_CLASSES = 20  # of the synthetic set's 40: 220 train videos
CPU_ANCHORS = 2  # the fp32 step held against the CPU: 6 clips
TIMED_STEPS = 5
LEARN_STEPS = 30
# bf16 against fp32 at full width. At random init the stem's weight
# gradient, ~2/3 of the gradient's norm, sums terms that mostly cancel and
# bf16 activations carry 8 mantissa bits into it: the cosine is ~0.92
# while fp32 against fp64 is ~0.99999 (PERF.md, section 6)
BF16_MIN_GRAD_COS = 0.9
BF16_MAX_LOSS_REL = 0.05
FP32_MIN_GRAD_COS = 0.9999  # fp32 (TF32 off) against fp64, both on the card
# 30 steps on one fixed batch take the mean triplet loss of the last 5 to
# at most this share of the first step's
LEARN_MAX_RATIO = 0.75


def triplet_batch(rng, b, t, s, n_cls, structured=False):
    """Pre-cropped uint8 anchor / positive / extra (anchor2) clips (B, T, S,
    S, 3) and (2B,) targets [anchor labels; positive labels].
    ``structured``: each class has its own colour under per-clip noise,
    so a clip's class can be learnt; otherwise uniform noise."""
    labels = rng.integers(0, n_cls, b)
    out = {}
    for k in TRAIN_VIEWS:
        if structured:
            colors = np.random.default_rng(SEED).integers(30, 226, (n_cls, 3))
            noise = rng.integers(-60, 61, (b, t, s, s, 3))
            out[k] = np.clip(colors[labels][:, None, None, None, :] + noise,
                             0, 255).astype(np.uint8)
        else:
            out[k] = rng.integers(0, 256, (b, t, s, s, 3), np.uint8)
    out["targets"] = np.concatenate([labels, labels]).astype(np.int64)
    return out


def fresh_trainer(cfg, init, device):
    """The seeded weights ``init`` on ``device`` with a new optimizer,
    schedule, step and loss function."""
    from video_similarity_search_tpu_torch.models import model_selector
    from video_similarity_search_tpu_torch.train.state import make_optimizer
    from video_similarity_search_tpu_torch.train.steps import (
        make_triplet_loss_fn, make_triplet_train_step)

    model = model_selector(cfg)
    model.load_state_dict(init)
    model.to(device)
    opt, sched = make_optimizer(cfg, model.parameters())
    step = make_triplet_train_step(cfg, model, opt, sched, device=device)
    return model, opt, sched, step, make_triplet_loss_fn(cfg, model, device)


def _state_keys(sd: dict, stats: bool):
    return [k for k in sd if k.endswith(("running_mean", "running_var"))
            == stats and not k.endswith("num_batches_tracked")]


def max_state_diff(a: dict, b: dict, stats: bool):
    """(largest |a - b|, its tensor's name) over the parameters (``stats``
    False) or the BatchNorm running statistics (True) of two state
    dicts."""
    return max((float((a[k].float() - b[k].float()).abs().max()), k)
               for k in _state_keys(a, stats))


def update_rel_err(after: dict, ref_after: dict, before: dict) -> float:
    """||u - u_ref|| / ||u_ref|| of the parameter update u = after -
    before, over all parameters."""
    num = den = 0.0
    for k in _state_keys(before, False):
        u = after[k].float() - before[k].float()
        r = ref_after[k].float() - before[k].float()
        num += float(((u - r) ** 2).sum())
        den += float((r ** 2).sum())
    return (num / den) ** 0.5


def step_vs_cpu(cfg, init, host):
    """(a) One fp32 step (TF32 off) on the card against the same step on
    the CPU: the same weights, batch, augmentation draws and Gumbel draws
    (drawn on the CPU, copied to both), CPU_ANCHORS anchors. The loss, the
    mined negatives and the augmented clips are held to the CPU's. The
    parameter update and the BatchNorm statistics are held to an fp64 run
    of the same step on the CPU (network in fp64, loss head in fp32): at
    random init the stem's weight gradient sums ~400k terms that mostly
    cancel, so two fp32 orders of summation differ by ~1e-3 of the update;
    the card's fp32 must be no further from fp64 than 3x the CPU's."""
    import torch

    from video_similarity_search_tpu_torch.data.augment import (
        apply_augment, draw_augment_params)
    from video_similarity_search_tpu_torch.losses.triplet import (gumbel,
                                                                   pair_masks)

    cfg32 = cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    b, s = CPU_ANCHORS, cfg.DATA.SAMPLE_SIZE
    gen = torch.Generator().manual_seed(SEED)
    draws = {k: draw_augment_params(gen, b) for k in TRAIN_VIEWS}
    noise = gumbel(gen, (2 * b,) * 3)
    labels = torch.tensor([0, 1] * (b // 2) * 2)  # two labels, a pair each
    res = {}
    for name, dev, dtype in (("cpu", "cpu", torch.float32),
                             ("cpu64", "cpu", torch.float64),
                             ("cuda", "cuda", torch.float32)):
        model, _, _, step, _ = fresh_trainer(cfg32, init, dev)
        model.to(dtype)
        batch = {k: apply_augment(
            torch.from_numpy(host[k][:b]).to(dev),
            {n: v.to(dev) for n, v in draws[k].items()}, s,
            dataset=cfg.TRAIN.DATASET, pre_cropped=True).to(dtype)
            for k in TRAIN_VIEWS}
        batch["targets"] = labels.to(dev)
        t0 = time.perf_counter()
        met = step(batch, noise=noise.to(dev))
        loss = float(met["loss"])
        res[name] = {"loss": loss, "n": int(met["n_triplets"]),
                     "neg": met["negatives"].cpu(),
                     "aug": {k: v.cpu().float() for k, v in batch.items()},
                     "sd": {k: v.detach().cpu().double()
                            for k, v in model.state_dict().items()},
                     "s": time.perf_counter() - t0}
        del model, step, batch
    c, g, ref = res["cpu"], res["cuda"], res["cpu64"]
    valid = pair_masks(labels)[0]  # the pairs whose negative counts
    init64 = {k: v.double() for k, v in init.items()}
    out = {"anchors": b, "clips": 3 * b,
           "loss_cpu": c["loss"], "loss_cuda": g["loss"],
           "loss_cpu_fp64": ref["loss"],
           "loss_rel_diff": abs(g["loss"] - c["loss"]) / abs(c["loss"]),
           "augment_max_abs_diff": max(float((g["aug"][k] - c["aug"][k])
                                             .abs().max()) for k in TRAIN_VIEWS),
           "param_max_abs_diff": max_state_diff(g["sd"], c["sd"], False),
           "update_rel_err_cuda_vs_cpu": update_rel_err(g["sd"], c["sd"],
                                                        init64),
           "update_rel_err_cuda_vs_fp64": update_rel_err(g["sd"], ref["sd"],
                                                         init64),
           "update_rel_err_cpu_vs_fp64": update_rel_err(c["sd"], ref["sd"],
                                                        init64),
           "bn_stat_max_abs_diff_cuda_vs_fp64": max_state_diff(
               g["sd"], ref["sd"], True),
           "bn_stat_max_abs_diff_cpu_vs_fp64": max_state_diff(
               c["sd"], ref["sd"], True),
           "negatives_equal": bool(torch.equal(g["neg"][valid],
                                               c["neg"][valid])),
           "n_triplets": g["n"], "cpu_step_s": c["s"]}
    check(out["augment_max_abs_diff"] <= 1e-5, "augmentation: card = CPU "
          f"within 1e-5 ({out['augment_max_abs_diff']})")
    check(out["loss_rel_diff"] <= 1e-4, f"fp32 step loss: card = CPU within "
          f"1e-4 relative ({out['loss_rel_diff']})")
    check(out["negatives_equal"] and g["n"] == c["n"] > 0,
          "fp32 step: the same mined negatives and n_triplets")
    err, err_cpu = (out["update_rel_err_cuda_vs_fp64"],
                    out["update_rel_err_cpu_vs_fp64"])
    check(err <= 3 * err_cpu + 1e-5, f"fp32 step: the card's update is within "
          f"{err} of fp64's, the CPU's within {err_cpu} (limit: 3x)")
    bn, bn_cpu = (out["bn_stat_max_abs_diff_cuda_vs_fp64"][0],
                  out["bn_stat_max_abs_diff_cpu_vs_fp64"][0])
    check(bn <= 3 * bn_cpu + 1e-6, f"fp32 step BatchNorm statistics: the "
          f"card's within {bn} of fp64's, the CPU's within {bn_cpu}")
    return out


def bf16_vs_fp32(cfg, init, host):
    """(b) The full-width bf16 forward and backward against fp32 (TF32 off)
    and fp64 on the card: the same weights, augmented batch and Gumbel
    draws. With the config's ``random_semi_hard`` mining a negative is
    valid only while d_ap + margin > d_an, so a rounding near that edge
    picks another negative; that case is reported. The precision is
    checked with ``random_negative`` mining, whose picks depend on the
    labels and the draws alone: the same negatives at every precision, fp32
    held to fp64, bf16 to fp32 (loss, and the cosine of the whole
    gradient, with the stem's share of the gradient's norm and its own
    cosine beside it)."""
    import torch

    from video_similarity_search_tpu_torch.data.augment import train_augment
    from video_similarity_search_tpu_torch.losses.triplet import gumbel

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batch = {k: train_augment(torch.from_numpy(host[k]).cuda(), gen,
                              cfg.DATA.SAMPLE_SIZE, dataset=cfg.TRAIN.DATASET,
                              pre_cropped=True) for k in TRAIN_VIEWS}
    batch["targets"] = torch.from_numpy(host["targets"]).cuda()
    noise = gumbel(gen, (batch["targets"].shape[0],) * 3)

    def cos(a, b):
        return float(torch.nn.functional.cosine_similarity(a, b, dim=0))

    out = {}
    for strategy, names in (
            (cfg.DATASET.SAMPLING_STRATEGY, ("bfloat16", "float32")),
            ("random_negative", ("bfloat16", "float32", "float64"))):
        res = {}
        for name in names:
            c = cfg.clone()
            c.TPU.COMPUTE_DTYPE = "float32" if name == "float64" else name
            c.DATASET.SAMPLING_STRATEGY = strategy
            model, _, _, _, loss_fn = fresh_trainer(c, init, "cuda")
            b = batch
            if name == "float64":  # the network in fp64, the loss in fp32
                model.double()
                b = {k: v.double() if v.is_floating_point() else v
                     for k, v in batch.items()}
            model.train()
            loss, aux = loss_fn(b, noise=noise)
            loss.backward()
            grads = [p.grad.detach().double().flatten()
                     for p in model.parameters()]
            res[name] = {"loss": float(loss.detach()),
                         "n": int(aux["n_triplets"]), "neg": aux["negatives"],
                         "stem": grads[0], "grad": torch.cat(grads)}
            del model, loss, aux, grads
        lo, hi = res["bfloat16"], res["float32"]
        row = {"loss_bf16": lo["loss"], "loss_fp32": hi["loss"],
               "loss_rel_diff": abs(lo["loss"] - hi["loss"]) / abs(hi["loss"]),
               "grad_cosine": cos(lo["grad"], hi["grad"]),
               "stem_grad_cosine": cos(lo["stem"], hi["stem"]),
               "stem_share_of_grad_norm2": float(
                   (hi["stem"].norm() / hi["grad"].norm()) ** 2),
               "n_triplets": lo["n"],
               "negatives_agree": float((lo["neg"] == hi["neg"])
                                        .float().mean())}
        if "float64" in res:
            ref = res["float64"]
            row.update({"loss_fp64": ref["loss"],
                        "fp32_vs_fp64_loss_rel_diff":
                            abs(hi["loss"] - ref["loss"]) / abs(ref["loss"]),
                        "fp32_vs_fp64_grad_cosine": cos(hi["grad"],
                                                        ref["grad"]),
                        "bf16_vs_fp64_grad_cosine": cos(lo["grad"],
                                                        ref["grad"])})
        out[strategy] = row
        check(lo["n"] == hi["n"] > 0, f"{strategy}: bf16 and fp32 count the "
              "same n_triplets")
    held = out["random_negative"]
    check(held["negatives_agree"] == 1.0, "random_negative: the same "
          "negatives in bf16 and fp32")
    check(held["fp32_vs_fp64_grad_cosine"] >= FP32_MIN_GRAD_COS
          and held["fp32_vs_fp64_loss_rel_diff"] <= 1e-5,
          f"fp32 vs fp64: gradient cosine {held['fp32_vs_fp64_grad_cosine']}"
          f" >= {FP32_MIN_GRAD_COS}, loss within 1e-5 relative")
    check(held["grad_cosine"] >= BF16_MIN_GRAD_COS, "bf16 vs fp32 gradient "
          f"cosine {held['grad_cosine']} >= {BF16_MIN_GRAD_COS}")
    check(held["loss_rel_diff"] <= BF16_MAX_LOSS_REL, "bf16 vs fp32 loss: "
          f"relative difference {held['loss_rel_diff']} <= {BF16_MAX_LOSS_REL}")
    return out


def time_steps(cfg, init, host, accum: int):
    """(c) Median ms of the bf16 step after two warm-up steps: the whole
    step (augmentation of the three views included) on the host clock, and
    its split by CUDA events into augment, forward + loss, backward and
    optimizer (the step's own body, ``make_triplet_train_step``, with
    events between its parts)."""
    import torch

    from video_similarity_search_tpu_torch.data.augment import train_augment
    from video_similarity_search_tpu_torch.train.driver import (
        _microbatch_leaf, step_seed)

    c = cfg.clone()
    c.TRAIN.ACCUM_STEPS = accum
    model, opt, sched, step, loss_fn = fresh_trainer(c, init, "cuda")
    dev_u8 = {k: torch.from_numpy(_microbatch_leaf(k, host[k], accum)
                                  if accum > 1 else host[k]).cuda()
              for k in TRAIN_VIEWS}
    targets = torch.from_numpy(_microbatch_leaf("targets", host["targets"],
                                                accum)
                               if accum > 1 else host["targets"]).cuda()
    gen = torch.Generator(device="cuda")
    size, dataset = c.DATA.SAMPLE_SIZE, c.TRAIN.DATASET

    def augment(i):
        gen.manual_seed(step_seed(0, i))
        views = {}
        for k, v in dev_u8.items():
            parts = [train_augment(x, gen, size, dataset=dataset,
                                   pre_cropped=True)
                     for x in (v if accum > 1 else [v])]
            views[k] = torch.stack(parts) if accum > 1 else parts[0]
        views["targets"] = targets
        return views

    for i in range(2):
        step(augment(i), gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    whole = []
    for i in range(TIMED_STEPS):
        t0 = time.perf_counter()
        step(augment(10 + i), gen)
        torch.cuda.synchronize()
        whole.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    split = collections.defaultdict(list)
    for i in range(TIMED_STEPS if accum == 1 else 0):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        model.train()
        opt.zero_grad(set_to_none=True)
        ev[0].record()
        batch = augment(20 + i)
        ev[1].record()
        loss, _ = loss_fn(batch, generator=gen)
        ev[2].record()
        loss.backward()
        ev[3].record()
        opt.step()
        sched.step()
        ev[4].record()
        ev[4].synchronize()
        for name, a, b in (("augment", 0, 1), ("forward_loss", 1, 2),
                           ("backward", 2, 3), ("optimizer", 3, 4)):
            split[name].append(ev[a].elapsed_time(ev[b]))
    clips = 3 * host["targets"].shape[0] // 2
    out = {"accum_steps": accum, "step_ms": float(np.median(whole)),
           "step_ms_all": whole, "clips": clips,
           "clips_per_s": clips / (float(np.median(whole)) / 1e3),
           "peak_mem_gib": peak}
    if split:
        out["split_ms"] = {k: float(np.median(v)) for k, v in split.items()}
    del model, opt, step
    return out


def learning_check(cfg, init, rng):
    """(d) LEARN_STEPS bf16 steps on one fixed, augmented batch of
    class-coloured clips with their true labels lower the triplet loss."""
    import torch

    from video_similarity_search_tpu_torch.data.augment import train_augment

    b, t, s = cfg.TRAIN.BATCH_SIZE, cfg.DATA.SAMPLE_DURATION, cfg.DATA.SAMPLE_SIZE
    host = triplet_batch(rng, b, t, s, n_cls=8, structured=True)
    _, _, _, step, _ = fresh_trainer(cfg, init, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batch = {k: train_augment(torch.from_numpy(host[k]).cuda(), gen, s,
                              dataset=cfg.TRAIN.DATASET, pre_cropped=True)
             for k in TRAIN_VIEWS}
    batch["targets"] = torch.from_numpy(host["targets"]).cuda()
    losses = []
    for i in range(LEARN_STEPS):
        gen.manual_seed(SEED + 1 + i)
        losses.append(step(batch, gen)["triplet_loss"])
    losses = [float(v) for v in losses]
    ratio = float(np.mean(losses[-5:])) / losses[0]
    check(all(np.isfinite(losses)), "learning check: finite losses")
    check(ratio <= LEARN_MAX_RATIO, f"learning check: the last 5 steps' mean "
          f"triplet loss is {ratio:.3f} of the first's (<= {LEARN_MAX_RATIO})")
    return {"steps": LEARN_STEPS, "first": losses[0],
            "last5_mean": float(np.mean(losses[-5:])), "ratio": ratio,
            "losses": losses}


def phase_train_step():
    """The triplet step at the UCF config's full width: R3D-18 from seed
    0, 32 anchors + 32 positives + 32 anchor2 = 96 pre-cropped clips of
    16x128x128x3 from seed 0."""
    import torch

    from video_similarity_search_tpu_torch.models import model_selector

    cfg = load_cfg(UCF_YAML, ["OUTPUT_PATH", os.path.join(OUT, "train_step")])
    b, t, s = cfg.TRAIN.BATCH_SIZE, cfg.DATA.SAMPLE_DURATION, cfg.DATA.SAMPLE_SIZE
    torch.manual_seed(SEED)
    init = model_selector(cfg).state_dict()
    rng = np.random.default_rng(SEED)
    host = triplet_batch(rng, b, t, s, n_cls=16)
    vs_cpu = step_vs_cpu(cfg, init, host)
    torch.cuda.empty_cache()
    vs_fp32 = bf16_vs_fp32(cfg, init, host)
    torch.cuda.empty_cache()
    timing = [time_steps(cfg, init, host, accum) for accum in (1, 2)]
    torch.cuda.empty_cache()
    learn = learning_check(cfg, init, rng)
    emit("train_step", config="configs/resnet_ucf_itercluster_flow.yaml",
         arch="R3D-18", clip=[t, s, s, 3], anchors=b, clips_per_step=3 * b,
         dtype=str(cfg.TPU.COMPUTE_DTYPE),
         strategy=cfg.DATASET.SAMPLING_STRATEGY, lr=cfg.OPTIM.LR,
         momentum=cfg.OPTIM.MOMENTUM, fp32_card_vs_cpu=vs_cpu,
         bf16_vs_fp32=vs_fp32, timing=timing, learning=learn)
    return timing[0]["clips_per_s"]


def run_cli(cmd, what: str, timeout: int = 900):
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"{what} exit {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    return proc.stdout, wall


def phase_train_cli(paths, step_clips_per_s: float):
    """python -m video_similarity_search_tpu_torch.cli.online_train --cfg
    configs/resnet_ucf_itercluster_flow.yaml --iterative_cluster on the
    synthetic UCF set cut to its first TRAIN_CLI_CLASSES classes (their
    test videos serve as the validation subset): 2 epochs, clustering and
    retrieval every epoch; the evaluate CLI on the written checkpoint; then
    a third epoch resumed from it."""
    import torch

    jpg, ann, flow = paths
    work = os.path.join(OUT, "train_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    with open(ann) as f:
        spec = json.load(f)
    keep = set(spec["labels"][:TRAIN_CLI_CLASSES])
    spec["database"] = {k: v for k, v in spec["database"].items()
                        if v["annotations"]["label"] in keep}
    ann_test = os.path.join(work, "annotation_traintest.json")
    with open(ann_test, "w") as f:
        json.dump(spec, f)
    for v in spec["database"].values():
        if v["subset"] == "test":
            v["subset"] = "validation"
    ann_val = os.path.join(work, "annotation_trainval.json")
    with open(ann_val, "w") as f:
        json.dump(spec, f)
    out = os.path.join(work, "out")
    data = ["DATASET.VID_PATH", jpg, "DATASET.ANNOTATION_PATH", ann_val,
            "DATASET.OPTICAL_U_PATH", flow, "ITERCLUSTER.INTERVAL", "1",
            "TRAIN.RETRIEVAL_INTERVAL", "1"]
    cli = [sys.executable, "-m",
           "video_similarity_search_tpu_torch.cli.online_train",
           "--cfg", UCF_YAML, "--iterative_cluster", "--output", out,
           "--device", "cuda"]
    stdout, wall = run_cli(cli + data + ["TRAIN.EPOCHS", "2"],
                           "training CLI")
    logs = os.path.join(out, "tnet_checkpoints")
    ckpt = os.path.join(logs, "3dresnet", "checkpoint.pth.tar")
    lines = {}
    for name in ("NMIs.txt", "AMIs.txt", "train_loss_and_acc.txt",
                 "val_loss_and_acc.txt", "global_retrieval_acc.txt"):
        with open(os.path.join(logs, name)) as f:
            lines[name] = f.read().splitlines()
        check(len(lines[name]) == 2, f"{name}: one line an epoch")
    losses = [float(ln.split()[-1]) for ln in lines["train_loss_and_acc.txt"]]
    val = [[float(x) for x in ln.split()[1:]]
           for ln in lines["val_loss_and_acc.txt"]]
    check(all(np.isfinite(losses)) and np.isfinite(val).all(),
          "finite train and validation losses")
    with open(os.path.join(out, "vid_clusters.txt")) as f:
        n_labels = len(f.read().split())
    n_train = TRAIN_CLI_CLASSES * (SYN["videos_per_class"] - 1)
    check(n_labels == n_train, f"vid_clusters.txt: {n_labels} labels")
    check(os.path.exists(ckpt), "checkpoint.pth.tar written")
    rates = [float(m) for m in re.findall(
        r"Train set: Average loss: \S+ \(([\d.]+) clips/s", stdout)]
    check(len(rates) == 2, f"two epoch summaries: {rates}")

    # the evaluate CLI loads the written checkpoint
    ev_out, ev_wall = run_cli(
        [sys.executable, "-m", "video_similarity_search_tpu_torch.cli.evaluate",
         "--cfg", UCF_YAML, "--checkpoint_path", ckpt, "--output",
         os.path.join(work, "eval"), "--device", "cuda", "--crop", "center",
         "DATASET.VID_PATH", jpg, "DATASET.ANNOTATION_PATH", ann_test,
         "DATASET.OPTICAL_U_PATH", flow], "evaluate CLI on the checkpoint")
    check("checkpoint: loaded" in ev_out and "kept 0 at init" in ev_out,
          "the evaluate CLI loaded every tensor of the checkpoint")

    # a third epoch, resumed from the run root
    saved = torch.load(ckpt, map_location="cpu", weights_only=False)
    n_params = len(saved["optimizer"]["state"])
    check(saved["epoch"] == 2 and n_params > 0,
          "the checkpoint resumes at epoch 2 with momentum buffers")
    res_out, res_wall = run_cli(
        cli[:-2] + ["--checkpoint_path", out, "--device", "cuda"] + data
        + ["TRAIN.EPOCHS", "3"], "resumed training CLI")
    want = (f"resume: epoch 2, best_prec1 {saved['best_prec1']}, optimizer "
            f"state for {n_params}/{n_params} parameters, schedule count "
            f"{saved['lr_schedule']['count']}")
    check(want in res_out and "WARNING: restore" not in res_out,
          f"resumed with the saved momentum buffers ({want!r})")
    with open(os.path.join(logs, "train_loss_and_acc.txt")) as f:
        after = f.read().splitlines()
    check(len(after) == 3 and after[-1].startswith("epoch:2 "),
          "the resumed run trained epoch 2 only")
    check(torch.load(ckpt, map_location="cpu",
                     weights_only=False)["epoch"] == 3, "epoch 3 saved")
    emit("train_cli", command=" ".join(cli[1:6]) + " ...", epochs=2,
         wall_s=wall, train_videos=n_train, val_videos=TRAIN_CLI_CLASSES,
         train_loss=losses, val_lines=lines["val_loss_and_acc.txt"],
         nmi=lines["NMIs.txt"], retrieval=lines["global_retrieval_acc.txt"],
         loader_fed_triplets_per_s=rates,
         loader_fed_clips_per_s=[3 * r for r in rates],
         train_step_clips_per_s=step_clips_per_s,
         evaluate_wall_s=ev_wall, resume_wall_s=res_wall,
         resume_line=want, stdout_tail=stdout.strip().splitlines()[-3:])


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

    seconds = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    smi, sass = run("device", phase_device)
    bank, bank_lbl = mixture(240_000, seed=0)
    shapes = run("kernel", phase_kernel_nn1, smi, sass, bank)
    model, cfg, emb4096, cache = run("embed", phase_embed)
    finch_launches = run("cluster", phase_cluster, bank, bank_lbl, emb4096)
    run("retrieval", phase_retrieval, model, cfg, cache, bank)
    check(fused_knn.LAUNCHES == 0, "retrieval launches no 1-NN kernel")
    del bank, bank_lbl
    backend = run("host", phase_host)
    ucf, paths, train_loader, train_ds = run("data", phase_data, backend)
    ucf_model, emb = run("embed_loader", phase_embed_loader, ucf,
                         train_loader, backend)
    run("cluster_step", phase_cluster_step, ucf, ucf_model, train_loader,
        train_ds, backend)
    run("cli", phase_cli, ucf, paths, ucf_model, emb)
    del ucf_model, train_loader
    step_rate = run("train_step", phase_train_step)
    run("train_cli", phase_train_cli, paths, step_rate)
    emit("timing", seconds=seconds, total_s=sum(seconds.values()),
         notes="the data phase reads 3 epochs of the eval train loader "
               "(5 before the train_step and train_cli phases); train_cli "
               "trains on 20 of the synthetic set's 40 classes")

    main_shape = shapes[-1]
    src, replaces = KERNELS["nn1_cosine"]
    print(json.dumps({"kernels": [{
        "name": "nn1_cosine", "route": "cuda", "source": src,
        "replaces": replaces, "launches": finch_launches,
        "max_abs_err": max(r["max_abs_err"] for r in shapes),
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"], "library_ms": None,
        "fp32_simt_bound_ms": main_shape["fp32_simt_bound_ms"],
        "tflops_fp32_accurate": main_shape["tflops_fp32_accurate"],
        "sass": key_opcodes(sass["nn1_cosine"]),
        "shape": main_shape["shape"], "shapes": shapes}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
