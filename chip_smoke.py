#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Drives the port's serving path (video_similarity_search_tpu_torch) at the
full width of the Kinetics config (configs/resnet_kin_itercluster_flow.yaml:
R3D-18, 16x128x128 clips, 128-d embeddings) with random seeded weights and
data, in phases that each print one JSON line:

  device     card name and power limit, torch/CUDA versions, kernel builds
             (nvcc, sm_90a, all sources at once) with ptxas' registers,
             spills and shared memory, and the SASS opcode counts
             (cuobjdump; nn1_cosine must hold HGMMA and UTMALDG,
             stem_conv3d HGMMA)
  kernel     the 1-NN kernel against its plain PyTorch version on
             the card, at the path's shapes (ties, near ties, padding of D,
             D > 128 and ragged edges included), with its time beside the
             3xTF32 tensor-core bound and the fp32 CUDA-core bound; at 240k
             the kernel's picks and level-0 partition are held to an fp64
             1-NN (the plain version's are reported beside them)
  stem       R3D-18's stem convolution kernel (ops/stem_conv.py) at the
             triplet step's 96 and the embedding batch's 256 clips of
             16x128x128: its ms beside the bf16 bound, the plain version's
             (F.conv3d on the bf16 operands), and as library_ms the cuDNN
             7x7 call under autocast that the port made before and the
             space-to-depth cuDNN form (neither of which the port calls on
             its bf16 path); both sizes held to a float32 conv3d of the
             same bf16 operands within one bf16 unit. Its launches are
             counted on the main path: in the embed phase's passes and
             the train_step phase's timed steps (one a bf16 forward)
  stem_wgrad S3D's float32 stem weight gradient (ops/stem_wgrad.py) at the
             MoCo cell's 32 query clips of 32x128x128: the kernel's ms
             beside the FMA bound, the plain version's (which on the card
             is cuDNN's call of the path before) and cuDNN's on NCDHW
             copies; its worst error and cuDNN's against a float64
             unfold + matmul (the kernel's no larger), ragged shapes held
             to float64, two calls bitwise equal, and its launches on the
             main path: 1 a float32 MoCo step, 0 in the key forward and a
             bf16 step, and by classifier mode (last / ft / all)
  embed      get_embeddings_and_labels over 4096 train clips (batches of
             256) and a multi-window test split; clips/s, peak memory, and
             the bf16 embeddings against the fp32 forward
  cluster    FINCH / fit_cluster("finch") over the 240,000 x 128 planted
             mixture of perf_experiments/cluster_240k_r4.py (sparse level 0
             through the CUDA 1-NN kernel), sparse-vs-dense level-0 parity on
             20k points, and FINCH on the 4096 embeddings (dense path)
  retrieval  k_nearest_embeddings over the embed phase's embeddings, and
             top-50 of 9,537 queries over the 240k bank, exact and with
             approx=True (TPU.APPROX_TOPK), which must return the same

and the host data path, on the UCF config
(configs/resnet_ucf_itercluster_flow.yaml, with only the data paths set):

  host       the host's compiler, libjpeg header and library, OpenCV and
             PIL, core count, the port's native JPEG decoder build (the
             decode backend, ``native`` or ``pil``, is printed loudly), the
             msgpack / pandas / lmdb / matplotlib / sklearn packages (the
             port needs none) and a cv2 MJPG write -> read round trip
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
             augmentation) and to an fp64 run on the card (update, BN statistics);
             (b) bf16 against fp32 and fp64 at full width (loss, gradient
             cosine, n_triplets); (c) ms a bf16 step, its device time split
             into augment / forward+loss / backward / optimizer, clips/s,
             peak GiB, ACCUM_STEPS 2 beside 1; (d) 30 steps on one fixed
             batch lower the triplet loss
  train_cli  python -m video_similarity_search_tpu_torch.cli.online_train
             --iterative_cluster for an epoch on 20 classes of the synthetic
             set (220 train, 20 validation videos), the
             evaluate CLI on its checkpoint, a second epoch resumed from it;
             the loader-fed clips/s beside train_step's

and the classification path of cli/coclr_classify.py at its defaults:

  classify_step  LinearClassifier (S3D and S3D-G) from seed 0 on 32 clips
             of 32x128x128x3 from seed 0, 101 classes, dropout 0.9: (a) one
             fp32 --train_what all step on the card held to the CPU (2
             clips, dropout mask injected; top-1/top-5 equal, logits, loss,
             update and BN statistics held to an fp64 run on the card); (b) fp32
             against fp64 and bf16 against fp32 at batch 32 (loss, gradient
             cosine, each block's output); (c) ms an fp32 step (the CLI's
             dtype) for last / ft / all and a bf16 all step, each with its
             device time split into normalize / forward+loss / backward /
             optimizer and its bound, clips/s, peak GiB, the eval forward's
             clips/s and one ten-crop batch's ms and peak GiB; (d) 30 steps
             on one fixed batch lower the cross-entropy
  classify_cli  the CLI (cli/coclr_classify.py) on its own synthetic set
             (20 classes of 64-frame videos): last for 2 epochs as python -m
             video_similarity_search_tpu_torch.cli.coclr_classify, then in
             this process ft for 1 from its model_best.pth.tar, the ten-crop
             test and --retrieval on it; loader-fed clips/s

and the fifth slice, the rest of SLIC's single-device pretrain:

  kmeans     kmeans and spherical_kmeans over the 240,000 x 128 mixture with
             K = 1000, 10 restarts of 50 iterations, timed; the float32 run
             held to a plain float64 Lloyd run from the same initial points
             on 20k of them; iterative_cluster_step with ITERCLUSTER.METHOD
             kmeans on the UCF set (after cluster_step); 0 nn1_cosine
             launches
  train_options  the train_step cell once per option (LOSS.MEM_TRIPLET with
             640 slots, RESNET.ATTENTION, TPU.STEM_S2D, TPU.REMAT on all
             stages and on stage 1): one fp32 step on the card held to the
             CPU and to fp64 as in train_step (a), ms / clips/s / peak GiB
             of a bf16 step; the s2d stem's forward ms beside the 7x7
             stem's and its output against the 7x7 one
  contrastive  LOSS.TYPE contrastive at bench.py:276's shape (R3D-18, 64
             anchors of 16x128x128, 1024 negatives, 128-d features, 9,537
             videos): ms / clips/s / peak GiB of a bf16 step for rgb, res,
             intra-negative and MoCo; one fp32 step against fp64; 30 steps
             on fixed data lower the loss; the training CLI with
             LOSS.TYPE contrastive and k-means on 10 classes (lr 0.001) for
             an epoch, then a resumed second whose banks must be the saved
             ones, byte-equal

and the eighth slice (run after classify_cli), CoCLR's LMDB path and IIC
clip retrieval:

  lmdb       a seeded CoCLR store (ClassInd.txt, the split csvs and
             ucf101_frame.lmdb of msgpack-framed 320x240 JPEGs, 48-64 frames
             a video, 64 train videos) written by the port's write_lmdb
             under runs/chip_smoke/, reused when present; one item of each
             mode held byte-equal to a direct read of the file; python -m
             video_similarity_search_tpu_torch.cli.coclr_classify
             --lmdb_root at the CLI's defaults (S3D, 32 clips of 32x128x128,
             101 classes, float32; --lr 0.1) for an epoch of --train_what
             last with the pinned upload, then in this process the ten-crop
             test on its model_best.pth.tar and --retrieval; the loader-fed
             clips/s beside classify_step's; each CoCLR clip transform on
             32 clips of 32x128x128 timed and held to the CPU from the same
             injected draws; 0 nn1_cosine launches
  iic        seeded MJPG videos (320x240, 48-80 frames) in the UCF layout of
             the IIC datasets; python -m
             video_similarity_search_tpu_torch.cli.iic_retrieve_clips on a
             .pth.tar of the UCF config's R3D-18 from seed 0 (10 clips of
             16x128x128 a video, bf16): topk_correct.json, the features
             held to an in-process pass, decode ms a video, the feature
             pass's clips/s and its share of the bf16 bound (utils/flops.py's
             resnet3d_flops_per_clip, held equal to the hooks' count); 0
             nn1_cosine launches

and the ninth slice (run after train_cli), the evaluation tools and
fit_cluster's scikit-learn-free methods:

  tools      DBSCAN and OPTICS (cluster/density.py) on the card over a
             seeded 9,537 x 128 mixture whose clusters straddle both
             radii, through fit_cluster's dispatch, held to the port's
             CPU run (equal but where a pair lies within 1e-5 of the
             radius), with ms, edges and clusters; Agglomerative on the
             host at that size; DBSCAN over 240,000 x 128 rows of the
             planted mixture (ms, edges, clusters, peak device memory)
             and of the kernel phase's mixture (no pair within the
             radius: the scan alone); tsne_plot on the card over 20 of
             101 classes and over all 9,537 points (ms, final KL, 10-NN
             preservation; the 1,815 points' KL held to the port's CPU
             run within 2%); the evaluate CLI with --heatmap 0,1 --plot
             on the cli phase's checkpoint and cached embeddings (its
             heat map held to an in-process temporal_heat_map), the tsne
             CLI, and python -m ...cli.generate_report on train_cli's
             OUTPUT_PATH, each PNG decoded at its declared size; the
             cluster step with ITERCLUSTER.METHOD DBSCAN, its labels held
             to the CPU run on the embeddings it clustered; 0 nn1_cosine
             launches

and the sixth slice, SlowFast and the MoCo pretrain:

  slowfast   get_cfg()'s defaults unchanged (SlowFast-50, ALPHA 4, BETA_INV
             8, fusion ratio 2 and kernel 7, 8x224x224 clips, the triplet
             loss, 16 anchors + 16 positives = 32 clips, bf16): (a) one
             fp32 step at 2 anchors held to the CPU and to fp64 on the card;
             (b) bf16 against fp32 at the full batch; (c) ms a bf16 step,
             its device split, clips/s, peak GiB and its bound from the
             hooks' FLOPs at 989 TFLOP/s bf16; (d) 30 steps lower the
             triplet loss; the eval embed pass at batch 64; a Caffe2 blob
             .pkl of the model and its inflated 2-D counterpart loaded into
             the full model; 0 nn1_cosine launches
  moco       LOSS.TYPE UberNCE with the S3D MoCo encoder (info_nce and
             uber_nce), 32 anchors of 32x128x128, two views, LOSS.K 1024:
             ms / clips/s / peak GiB of a bf16 and an fp32 step each; one
             fp32 step held to fp64 (4 anchors: loss, gradient cosine,
             queue, pointer, labels, the momentum update's order); 30
             uber_nce steps lower the loss's excess over its floor; the
             training CLI with arch uber_nce for an epoch, then a resumed
             second whose moco bank must be the saved one, byte-equal; 0
             nn1_cosine launches

and the seventh slice, pretraining on more than one GPU (``parallel``):

  dist       two gloo ranks (all_reduce / broadcast on CUDA tensors) share
             the card, each fed its rows of the global batch of the UCF
             config's triplet step: (a) one fp32 step of 4 anchors held to
             the 1-rank step on the card and its fp64 run (parameters
             bit-identical across ranks; loss, negatives; update and
             statistics within 3x the 1-rank fp32's distance from fp64);
             (b) ms a bf16 step of train_step's 96 clips at world 2 beside
             1 rank and a world-1 NCCL group, a check of the path and not
             a scaling number; (c) each rank's FINCH over a 24,000 x 128
             bank launches nn1_cosine once, labels equal across ranks;
             (d) the training CLI's ``_run`` on --gpu 0 inside a world-1
             NCCL group for an epoch on the synthetic set's first 10
             classes with a loss-side bank: LOSS.MEM_TRIPLET (640 slots)
             with --iterative_cluster, and UberNCE; the files written,
             the bank in the checkpoint

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
    "stem_conv3d": ("video_similarity_search_tpu_torch/csrc/stem_conv3d.cu",
                    None),  # XLA's convolution in the JAX package
    "stem_wgrad_f32": (
        "video_similarity_search_tpu_torch/csrc/stem_wgrad_f32.cu",
        None),  # XLA's convolution gradient in the JAX package
}
# R3D-18's stem at the cells' shapes: the triplet step's and an embedding
# batch's clips of 16x128x128
STEM_CLIPS = (96, 256)

# S3D's stem weight gradient at the MoCo cell's query clips: (B, T, H, W),
# and ragged shapes (odd H and W, W not a multiple of 4, Cout 128) held to
# float64: (B, T, H, W, Cout)
STEM_WGRAD_SHAPE = (32, 32, 128, 128)
STEM_WGRAD_RAGGED = ((3, 5, 37, 45, 64), (2, 3, 17, 16, 128),
                     (1, 2, 9, 70, 64))
# the ragged shapes' worst error, as a share of the largest gradient
STEM_WGRAD_RAGGED_TOL = 1e-5

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
       "train_frames": 32, "test_frames": 64, "flow": True, "tint": 0.0,
       "seed": SEED}
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
    stem_smem = cuda_build.load("stem_conv3d").stem_conv3d_smem_bytes
    smem_bytes.update({f"stem_conv3d kT={kt}": stem_smem(kt)
                       for kt in (1, 3, 5, 7)})
    smem_bytes["stem_wgrad_f32"] = cuda_build.load(
        "stem_wgrad_f32").stem_wgrad_f32_smem_bytes()
    for op in ("HGMMA", "UTMALDG"):
        check(sass["nn1_cosine"].get(op, 0) > 0,
              f"nn1_cosine's SASS has {op} (tensor cores fed by TMA)")
    check(sass["stem_conv3d"].get("HGMMA", 0) > 0,
          "stem_conv3d's SASS has HGMMA (the tensor cores)")
    check(sass["stem_wgrad_f32"].get("FFMA", 0) > 0
          and sass["stem_wgrad_f32"].get("HGMMA", 0) == 0,
          "stem_wgrad_f32's SASS has FFMA and no HGMMA (IEEE float32 on "
          "the CUDA cores)")
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
    from video_similarity_search_tpu_torch.utils.flops import peaks_for

    variant, (fp32_peak, tf32_peak, bw_peak, _) = peaks_for(smi)
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


def stem_in_clip_taps(t: int, kt: int) -> int:
    """The (output frame, kernel frame) pairs of a clip of ``t`` frames
    whose input frame lies inside the clip: the kernel skips the temporal
    zero padding, so only these count as work (100 of 112 at T 16, kT 7)."""
    return sum(min(t - 1, i + kt // 2) - max(0, i - kt // 2) + 1
               for i in range(t))


def within_one_bf16_unit(got, ref, chunk: int = 32) -> dict:
    """``got`` against the float32 ``ref``, ``chunk`` clips at a time:
    within one bf16 unit of each output, and 2^-16 of the largest (near-zero
    outputs, where the two float32 sums' order decides)."""
    import torch

    floor = 2.0 ** -16 * float(ref.abs().max())
    worst, over = 0.0, 0
    for i in range(0, ref.shape[0], chunk):
        r = ref[i:i + chunk]
        err = (got[i:i + chunk].float() - r).abs()
        _, e = torch.frexp(r.abs())
        over += int((err > torch.ldexp(torch.ones_like(r), e - 8)
                     + floor).sum())
        worst = max(worst, float(err.max()))
    return {"max_abs_err": worst, "max_abs_ref": float(ref.abs().max()),
            "over_one_bf16_unit": over}


def phase_stem(smi: str, sass: dict):
    """The stem convolution kernel (ops/stem_conv.py) at STEM_CLIPS clips of
    16x128x128 from seeded uint8 clips and He-normal weights: its ms beside
    the bf16 bound (the in-clip taps' operations at the bf16 peak), the
    plain version's and the library calls' ms, and its output at each size
    against a float32 conv3d (TF32 off) of the same bf16 operands
    (``within_one_bf16_unit``). -> rows."""
    import torch

    from video_similarity_search_tpu_torch.data.augment import normalize_only
    from video_similarity_search_tpu_torch.models.layers import Conv3d
    from video_similarity_search_tpu_torch.models.resnet3d import (
        conv1_kernel_to_s2d, space_to_depth)
    from video_similarity_search_tpu_torch.ops import stem_conv
    from video_similarity_search_tpu_torch.utils.flops import peaks_for

    variant, peaks = peaks_for(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(SEED)
    conv = Conv3d(3, 64, (7, 7, 7), (1, 2, 2)).cuda().to(
        memory_format=torch.channels_last_3d)
    s2d = Conv3d(12, 64, (7, 4, 4), 1, padding=(3, 2, 2)).cuda().to(
        memory_format=torch.channels_last_3d)
    with torch.no_grad():
        s2d.weight.copy_(conv1_kernel_to_s2d(conv.weight))
    wb = conv.weight.detach().to(torch.bfloat16)
    rng = np.random.default_rng(SEED)
    rows = []
    for clips in STEM_CLIPS:
        x = normalize_only(torch.from_numpy(rng.integers(
            0, 256, (clips, 16, 128, 128, 3), np.uint8)).cuda(),
            dataset="ucf101")
        xb = x.to(torch.bfloat16).contiguous()

        def cudnn_7x7():
            with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
                return conv(x.permute(0, 4, 1, 2, 3))

        def cudnn_s2d():
            with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
                return s2d(space_to_depth(x).permute(0, 4, 1, 2, 3))[
                    ..., :64, :64]

        row = {"clips": clips, "shape": [clips, 16, 128, 128, 3]}
        got = stem_conv.stem_conv3d_cuda(xb, wb)
        ref = stem_conv.conv3d_plain(xb.float(), wb.float())
        row.update(within_one_bf16_unit(got, ref))
        check(row["over_one_bf16_unit"] == 0, "stem_conv3d within one "
              f"bf16 unit of a float32 conv3d at {clips} clips ({row})")
        del got, ref
        ops = (2.0 * clips * 64 * 64 * 64 * 3 * 7 * 7
               * stem_in_clip_taps(16, 7))
        nbytes = xb.numel() * 2 + clips * 16 * 64 * 64 * 64 * 2
        row.update(bound(ops, nbytes, "bfloat16", peaks))
        row["ms"] = time_ms(lambda: stem_conv.stem_conv3d_cuda(xb, wb), 10)
        row["tflops"] = ops / (row["ms"] * 1e-3) / 1e12
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["plain_ms"] = time_ms(lambda: stem_conv.conv3d_plain(xb, wb), 3)
        row["library_ms"] = {"cudnn_7x7_autocast": time_ms(cudnn_7x7, 3),
                             "cudnn_s2d_autocast": time_ms(cudnn_s2d, 3)}
        row["peak_variant"] = variant
        row["sass"] = key_opcodes(sass["stem_conv3d"])
        rows.append(row)
        emit("stem", name="stem_conv3d", **row)
        del x, xb
        torch.cuda.empty_cache()
    check(rows[-1]["ms"] < rows[-1]["library_ms"]["cudnn_s2d_autocast"],
          "stem_conv3d is faster than the s2d cuDNN form at "
          f"{STEM_CLIPS[-1]} clips")
    return rows


def stem_wgrad_unfold(x, dy, dtype=None, chunk: int = 64):
    """The stem's weight gradient by another route than the kernel's and
    cuDNN's: each frame's (3 x 7 x 7, position) patches (``F.unfold``,
    stride 2, padding 3) times the output gradient in one matrix product
    (``torch.einsum``), ``chunk`` frames at a time, in ``dtype`` (float64
    by default: the referee). ``x`` (B, T, H, W, 3), ``dy`` (B, Cout, T,
    Ho, Wo) -> (Cout, 3, 1, 7, 7)."""
    import torch
    import torch.nn.functional as F

    dtype = dtype or torch.float64
    b, t, h, w, _ = x.shape
    cout = dy.shape[1]
    frames = x.reshape(b * t, h, w, 3).permute(0, 3, 1, 2)
    grads = dy.permute(0, 2, 1, 3, 4).reshape(b * t, cout, -1)
    acc = torch.zeros(cout, 3 * 49, dtype=dtype, device=x.device)
    for i in range(0, b * t, chunk):
        cols = F.unfold(frames[i:i + chunk].to(dtype), 7, padding=3, stride=2)
        acc += torch.einsum("nol,nkl->ok", grads[i:i + chunk].to(dtype), cols)
    return acc.view(cout, 3, 1, 7, 7)


def stem_wgrad_in_frame_taps(n: int) -> int:
    """The (output position, kernel tap) pairs along one axis of ``n``
    pixels (stride 2, padding 3, 7 taps) whose input pixel lies inside the
    frame: the taps on the zero padding do no work (442 of 448 at 128)."""
    return sum(min(n - 1, 2 * o + 3) - max(0, 2 * o - 3) + 1
               for o in range((n + 1) // 2))


def wgrad_err(got, ref) -> float:
    """Worst |got - ref| as a share of the largest |ref|."""
    return float((got.double() - ref).abs().max() / ref.abs().max())


def stem_wgrad_operands(gen, b, t, h, w, cout):
    """Normalized seeded clips (B, T, H, W, 3) and a unit normal output
    gradient in channels_last_3d memory, on the card."""
    import torch

    from video_similarity_search_tpu_torch.data.augment import normalize_only

    x = normalize_only(torch.randint(0, 256, (b, t, h, w, 3), generator=gen,
                                     device="cuda", dtype=torch.uint8),
                       dataset="ucf101")
    dy = torch.randn((b, t, (h + 1) // 2, (w + 1) // 2, cout), generator=gen,
                     device="cuda").permute(0, 4, 1, 2, 3)
    return x, dy


def phase_stem_wgrad(smi: str, sass: dict):
    """S3D's float32 stem weight gradient kernel (ops/stem_wgrad.py) at
    the MoCo cell's 32 query clips of 32x128x128 from seeded uint8 clips
    and a unit normal output gradient: its ms beside the FMA bound, the
    plain version's (``aten.convolution_backward``, on the card cuDNN's
    call of the path before) and the library's other routes: cuDNN on
    NCDHW copies, cuDNN with its autotuner (``cudnn.benchmark``) and an
    ``F.unfold`` and matrix product in float32; its worst error and
    cuDNN's against ``stem_wgrad_unfold`` in float64 (the kernel's no
    larger), ragged shapes within STEM_WGRAD_RAGGED_TOL and two calls
    bitwise equal. Its launches are counted on the main path, in the
    classify_step and moco phases. -> the row."""
    import torch

    from video_similarity_search_tpu_torch.models.layers import Conv3d
    from video_similarity_search_tpu_torch.ops import cuda_build, stem_wgrad
    from video_similarity_search_tpu_torch.utils.flops import peaks_for

    variant, peaks = peaks_for(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ragged = []
    for b, t, h, w, cout in STEM_WGRAD_RAGGED:
        x, dy = stem_wgrad_operands(gen, b, t, h, w, cout)
        err = wgrad_err(stem_wgrad.weight_grad_cuda(x, dy),
                        stem_wgrad_unfold(x, dy))
        ragged.append({"shape": [b, t, h, w, cout], "err": err})
        check(err <= STEM_WGRAD_RAGGED_TOL, f"stem_wgrad at "
              f"{(b, t, h, w, cout)} within {STEM_WGRAD_RAGGED_TOL} of "
              f"float64: {err}")
    b, t, h, w = STEM_WGRAD_SHAPE
    x, dy = stem_wgrad_operands(gen, b, t, h, w, 64)
    torch.manual_seed(SEED)
    wt = Conv3d(3, 64, (1, 7, 7), (1, 2, 2), (0, 3, 3)).cuda().to(
        memory_format=torch.channels_last_3d).weight.detach()
    xv = x.permute(0, 4, 1, 2, 3)
    got = stem_wgrad.weight_grad_cuda(x, dy)
    again = stem_wgrad.weight_grad_cuda(x, dy)
    check(torch.equal(got, again), "stem_wgrad: two calls bitwise equal")
    cudnn = stem_wgrad.weight_grad_plain(xv, dy, wt)
    ref = stem_wgrad_unfold(x, dy)
    row = {"shape": [b, t, h, w, 3], "cout": 64,
           "err_vs_fp64": wgrad_err(got, ref),
           "cudnn_err_vs_fp64": wgrad_err(cudnn, ref),
           "max_abs_ref": float(ref.abs().max()), "ragged": ragged}
    check(row["err_vs_fp64"] <= row["cudnn_err_vs_fp64"], "stem_wgrad's "
          f"worst error against float64 no larger than cuDNN's ({row})")
    unfold = stem_wgrad_unfold(x, dy, torch.float32, 256)
    row["unfold_mm_err_vs_fp64"] = wgrad_err(unfold, ref)
    del again, cudnn, ref, unfold
    # the taps inside the frame: those on the zero padding do no work
    ops = (2.0 * 64 * 3 * b * t * stem_wgrad_in_frame_taps(h)
           * stem_wgrad_in_frame_taps(w))
    row["all_taps_gflop"] = 2.0 * 64 * 147 * b * t * ((h + 1) // 2) * (
        (w + 1) // 2) / 1e9
    row.update(bound(ops, x.numel() * 4 + dy.numel() * 4, "float32", peaks))
    row["bytes_ms"] = (x.numel() + dy.numel()) * 4 / peaks[2] * 1e3
    row["ms"] = time_ms(lambda: stem_wgrad.weight_grad_cuda(x, dy), 10)
    row["tflops"] = ops / (row["ms"] * 1e-3) / 1e12
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    row["plain_ms"] = time_ms(
        lambda: stem_wgrad.weight_grad_plain(xv, dy, wt), 3)
    xn, dyn = xv.contiguous(), dy.contiguous()
    row["library_ms"] = {"cudnn_ncdhw": time_ms(
        lambda: stem_wgrad.weight_grad_plain(xn, dyn, wt), 3)}
    del xn, dyn
    tuned = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:  # the warm-up call of time_ms runs the autotuner's search
        row["library_ms"]["cudnn_benchmark"] = time_ms(
            lambda: stem_wgrad.weight_grad_plain(xv, dy, wt), 3)
    finally:
        torch.backends.cudnn.benchmark = tuned
    row["library_ms"]["unfold_mm_fp32"] = time_ms(
        lambda: stem_wgrad_unfold(x, dy, torch.float32, 256), 3)
    del x, dy, xv
    torch.cuda.empty_cache()
    row["peak_variant"] = variant
    row["sass"] = key_opcodes(sass["stem_wgrad_f32"])
    row["ptxas"] = [ln.strip() for ln in cuda_build.BUILD_LOGS.get(
        "stem_wgrad_f32", "").splitlines() if "registers" in ln
        or "spill" in ln or "smem" in ln]
    row["dynamic_smem_bytes"] = cuda_build.load(
        "stem_wgrad_f32").stem_wgrad_f32_smem_bytes()
    emit("stem_wgrad", name="stem_wgrad_f32", **row)
    return row


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


def load_cfg(yaml_path, opts) -> object:
    """A config through the port's own CLI parser: defaults -> YAML ->
    opts; without a YAML, get_cfg()'s defaults -> opts."""
    from video_similarity_search_tpu_torch.config import (arg_parser,
                                                          get_cfg,
                                                          load_config)

    if yaml_path is None:
        cfg = get_cfg()
        cfg.merge_from_list([str(v) for v in opts])
        return cfg
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
    """The embedding pass over 4096 train clips and a multi-window test
    split at the Kinetics config's full width, and the stem kernel's
    launches in it: one for each bf16 forward (the model's forward calls,
    counted by a hook), none in the float32 forward.
    -> (model, cfg, train embeddings, cache dir, launches)."""
    import torch

    from video_similarity_search_tpu_torch.evaluation.embed import (
        cache_embeddings, get_embeddings_and_labels)
    from video_similarity_search_tpu_torch.models import model_selector
    from video_similarity_search_tpu_torch.ops import stem_conv
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

    forwards = []
    hook = model.register_forward_pre_hook(lambda *_: forwards.append(1))
    launches = {}
    torch.cuda.reset_peak_memory_stats()
    timed = Epochs(train, 1)
    stem_conv.LAUNCHES = 0
    t0 = time.perf_counter()
    tr_emb, tr_lbl, tr_idx = get_embeddings_and_labels(
        model, cfg, timed, split="train", verbose=False, device="cuda")
    t_end = time.perf_counter()
    launches["train_pass"] = stem_conv.LAUNCHES
    launches["train_pass_forwards"] = len(forwards)
    steady_clips = sum(len(b["clip"]) for b in train[1:])
    clips_per_s = steady_clips / (t_end - timed.stamps[1])
    first_batch_s = timed.stamps[1] - t0
    forwards.clear()
    stem_conv.LAUNCHES = 0
    te_emb, te_lbl, te_idx = get_embeddings_and_labels(
        model, cfg, test, split="test", batch_pad=256, verbose=False,
        device="cuda")
    launches["test_pass"] = stem_conv.LAUNCHES
    launches["test_pass_forwards"] = len(forwards)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    check(launches["train_pass"] == launches["train_pass_forwards"]
          == len(train), f"one stem_conv3d launch a batch of the train "
          f"pass ({launches}, {len(train)} batches)")
    check(launches["test_pass"] == launches["test_pass_forwards"] > 0,
          f"one stem_conv3d launch a forward of the test pass ({launches})")

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
    stem_conv.LAUNCHES = 0
    ref = step32(x).cpu().numpy()
    launches["float32_forward"] = stem_conv.LAUNCHES
    hook.remove()
    check(launches["float32_forward"] == 0, "the float32 forward keeps "
          "conv1 (no stem_conv3d launch)")
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
         peak_mem_gib=peak_gib, max_cos_dist_vs_fp32=max_cos,
         stem_conv3d_launches=launches)
    return model, cfg, tr_emb, cache, launches


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
    # TPU.APPROX_TOPK: the exact top-k (recall 1.0) serves approx=True
    a_idx, a_val = topk_neighbors(q, b, k, approx=True)
    check(torch.equal(a_idx, idx) and torch.equal(a_val, val),
          "approx=True returns the exact top-50")
    emit("retrieval", topk_acc={f"top{k_}": v for k_, v in acc.items()},
         topk_queries=int(q.shape[0]), topk_bank=int(bank.shape[0]), k=k,
         topk_ms=ms, approx_topk_exact=True,
         approx_topk_ms=time_ms(lambda: topk_neighbors(q, b, k, approx=True),
                                reps=3))


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


# the Python packages the LMDB path (msgpack, pandas, lmdb; the port needs
# none of them) and the evaluation tools (matplotlib, sklearn) could use,
# and an MJPG VideoWriter -> VideoCapture round trip (the IIC path's decode)
HOST_PROBE = r"""
import importlib, json, os, tempfile
out = {}
for name in ("msgpack", "pandas", "lmdb", "matplotlib", "sklearn"):
    try:
        mod = importlib.import_module(name)
        v = getattr(mod, "__version__", None) or getattr(mod, "version", "?")
        out[name] = ".".join(map(str, v)) if isinstance(v, tuple) else str(v)
    except ImportError:
        out[name] = None
try:
    import cv2
    import numpy as np
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "probe.avi")
        w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 25.0,
                            (64, 48))
        frames = [np.full((48, 64, 3), 40 * i, np.uint8) for i in range(5)]
        for f in frames:
            w.write(f)
        w.release()
        cap = cv2.VideoCapture(path)
        got = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            got.append(f)
        cap.release()
    out["cv2_mjpg_round_trip"] = {
        "frames": len(got), "max_abs_err": max(
            (int(np.abs(g.astype(int) - f).max()) for g, f in
             zip(got, frames)), default=None)}
except Exception as e:
    out["cv2_mjpg_round_trip"] = repr(e)
print(json.dumps(out))
"""


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
    probe = subprocess.run([sys.executable, "-c", HOST_PROBE],
                           capture_output=True, text=True, timeout=300)
    check(probe.returncode == 0, f"host probe: {probe.stderr[-2000:]}")
    libs = json.loads(probe.stdout.strip().splitlines()[-1])
    rt = libs["cv2_mjpg_round_trip"]
    check(isinstance(rt, dict) and rt["frames"] == 5,
          f"cv2 writes and reads back an MJPG video ({rt})")
    t0 = time.perf_counter()
    built = native_loader.available()
    build_s = time.perf_counter() - t0
    backend = "native" if built else "pil"
    emit("host", cpu_count=os.cpu_count(), gxx=gxx,
         jpeglib_h=header, ljpeg_link=link,
         cv2=cv2.stdout.strip() if cv2.returncode == 0 else None,
         pil=PIL.__version__,
         pil_libjpeg_turbo=features.check_feature("libjpeg_turbo"),
         pil_freetype=features.check("freetype2"),
         native_decoder_built=built, native_build_s=build_s,
         native_library=(os.path.relpath(native_loader.LIB_PATH, ROOT)
                         if built else None),
         native_build_log=None if built else native_loader.BUILD_LOG[-400:],
         decoder=backend, **libs)
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
    drifts sideways ``speed`` pixels a frame (small JPEGs, real motion),
    its mean shifted ``tint`` x 150 levels towards the class colour."""
    from PIL import Image

    vdir, n, (h, w), color, freq, phase, speed, gray, tint = job
    yy, xx = np.mgrid[0:h, 0:w + speed * n].astype(np.float32)
    wave = np.sin(xx * freq + phase) + 0.5 * np.cos(yy * freq * 1.7 + phase)
    os.makedirs(vdir, exist_ok=True)
    if gray:  # optical_u: one channel, TVL1 layout frame%06d.jpg
        canvas = np.clip(128 + 60 * wave, 0, 255).astype(np.uint8)
        name = "frame{:06d}.jpg"
    else:
        canvas = np.clip(128 + 80 * wave[..., None] * color
                         + tint * 150 * (color - 0.6), 0, 255).astype(np.uint8)
        name = "image_{:05d}.jpg"
    for f in range(n):
        frame = np.ascontiguousarray(canvas[:, speed * f:speed * f + w])
        Image.fromarray(frame).save(os.path.join(vdir, name.format(f + 1)))


def make_ucf_dataset(root: str, syn: dict = SYN):
    """Seeded UCF-101-layout dataset (kenshohara JSON, <label>/<vid>/
    image_%05d.jpg, and with ``syn["flow"]`` optical_u/<vid>/frame%06d.jpg
    for the train videos); the last video of each class is a test video.
    Reused when ``root`` holds one made from the same ``syn``. -> (jpg
    root, annotation path, optical_u root, seconds spent writing)."""
    jpg, flow = os.path.join(root, "jpg"), os.path.join(root, "optical_u")
    ann_path = os.path.join(root, "annotation.json")
    marker = os.path.join(root, "done.json")
    spec = json.dumps(syn, sort_keys=True)
    if os.path.exists(marker):
        with open(marker) as f:
            if f.read() == spec:
                return jpg, ann_path, flow, 0.0
    t0 = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(syn["seed"])
    labels = [f"class{c:02d}" for c in range(syn["classes"])]
    hw = (syn["height"], syn["width"])
    database, jobs = {}, []
    for label in labels:
        color = rng.uniform(0.2, 1.0, 3).astype(np.float32)
        freq = float(rng.uniform(0.01, 0.05))
        for v in range(syn["videos_per_class"]):
            test = v == syn["videos_per_class"] - 1
            n = syn["test_frames"] if test else syn["train_frames"]
            vid = f"v_{label}_g{v:02d}_c01"
            phase, speed = float(rng.uniform(0, 6.28)), int(rng.integers(1, 5))
            jobs.append((os.path.join(jpg, label, vid), n, hw, color, freq,
                         phase, speed, False, syn["tint"]))
            if syn["flow"] and not test:
                jobs.append((os.path.join(flow, vid), n, hw, color,
                             freq * 1.3, phase, speed, True, 0.0))
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
TRAIN_CLI_EPOCHS = 1  # then one resumed (was 2 and a third)
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


def class_clips(rng, labels, t, s, n_cls, structured=False):
    """uint8 clips (B, T, S, S, 3) of ``labels``. ``structured``: each
    class has its own colour under per-clip noise, so a clip's class can be
    learnt; otherwise uniform noise."""
    b = len(labels)
    if structured:
        colors = np.random.default_rng(SEED).integers(30, 226, (n_cls, 3))
        noise = rng.integers(-60, 61, (b, t, s, s, 3))
        return np.clip(colors[labels][:, None, None, None, :] + noise,
                       0, 255).astype(np.uint8)
    return rng.integers(0, 256, (b, t, s, s, 3), np.uint8)


def triplet_batch(rng, b, t, s, n_cls, structured=False):
    """Pre-cropped uint8 anchor / positive / extra (anchor2) clips (B, T, S,
    S, 3) and (2B,) targets [anchor labels; positive labels]."""
    labels = rng.integers(0, n_cls, b)
    out = {k: class_clips(rng, labels, t, s, n_cls, structured)
           for k in TRAIN_VIEWS}
    out["targets"] = np.concatenate([labels, labels]).astype(np.int64)
    return out


def fresh_trainer(cfg, init, device):
    """The seeded weights ``init`` on ``device`` with a new optimizer,
    schedule, step and loss function (and, with ``LOSS.MEM_TRIPLET``, a
    new seeded bank that both advance)."""
    from video_similarity_search_tpu_torch.models import model_selector
    from video_similarity_search_tpu_torch.train.state import make_optimizer
    from video_similarity_search_tpu_torch.train.steps import (
        make_banks, make_triplet_loss_fn, make_triplet_train_step)

    model = model_selector(cfg)
    model.load_state_dict(init)
    model.to(device)
    opt, sched = make_optimizer(cfg, model.parameters())
    bank = make_banks(cfg, 0).get("mem_triplet")
    step = make_triplet_train_step(cfg, model, opt, sched, device=device,
                                   bank=bank)
    return (model, opt, sched, step,
            make_triplet_loss_fn(cfg, model, device, bank))


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


def train_views(cfg):
    """The clip views the triplet step of ``cfg`` takes: anchor and
    positive, and ``extra`` when a relative-speed, local-local or
    intra-negative loss is on (the UCF config's local-local contrast; not
    get_cfg()'s defaults)."""
    loss = cfg.LOSS
    extra = (loss.RELATIVE_SPEED_PERCEPTION or loss.LOCAL_LOCAL_CONTRAST
             or loss.INTRA_NEGATIVE)
    return TRAIN_VIEWS if extra else TRAIN_VIEWS[:2]


def step_vs_cpu(cfg, init, host, cpu_runs=None):
    """(a) One fp32 step (TF32 off) on the card against the same step on
    the CPU: the same weights, batch, augmentation draws and Gumbel draws
    (drawn on the CPU, copied to both), CPU_ANCHORS anchors. The loss, the
    mined negatives and the augmented clips are held to the CPU's. The
    parameter update and the BatchNorm statistics are held to an fp64 run
    of the same step on the card (network in fp64, loss head in fp32; fed
    the CPU's augmented clips, as the CPU run is; cuDNN runs fp64 3-D
    convolutions, ~50x faster than the CPU's 36-46 s a step): at random
    init the stem's weight gradient sums ~400k terms that mostly cancel,
    so two fp32 orders of summation differ by ~1e-3 of the update; the
    card's fp32 must be no further from fp64 than 3x the CPU's.
    ``cpu_runs``: a dict that keeps the CPU and fp64 runs for the next
    call of the same arithmetic (remat on all stages and on stage 1),
    which then runs the card's fp32 step only."""
    import torch

    from video_similarity_search_tpu_torch.data.augment import (
        apply_augment, draw_augment_params)
    from video_similarity_search_tpu_torch.losses.triplet import (gumbel,
                                                                   pair_masks)

    cfg32 = cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    b, s = CPU_ANCHORS, cfg.DATA.SAMPLE_SIZE
    views = train_views(cfg)
    gen = torch.Generator().manual_seed(SEED)
    draws = {k: draw_augment_params(gen, b) for k in views}
    # the miner's candidates: the batch, or the LOSS.MEM_TRIPLET bank
    n_cand = cfg.LOSS.MEM_TRIPLET_K if cfg.LOSS.MEM_TRIPLET else 2 * b
    noise = gumbel(gen, (2 * b, 2 * b, n_cand))
    labels = torch.tensor([0, 1] * (b // 2) * 2)  # two labels, a pair each
    res = {} if cpu_runs is None else cpu_runs
    for name, dev, dtype in (("cpu", "cpu", torch.float32),
                             ("fp64", "cuda", torch.float64),
                             ("cuda", "cuda", torch.float32)):
        if name in res and name != "cuda":
            continue
        model, _, _, step, _ = fresh_trainer(cfg32, init, dev)
        model.to(dtype)
        aug = "cuda" if name == "cuda" else "cpu"  # where the clips augment
        batch = {k: apply_augment(
            torch.from_numpy(host[k][:b]).to(aug),
            {n: v.to(aug) for n, v in draws[k].items()}, s,
            dataset=cfg.TRAIN.DATASET, pre_cropped=True).to(dev, dtype)
            for k in views}
        batch["targets"] = labels.to(dev)
        t0 = time.perf_counter()
        met = step(batch, noise=noise.to(dev))
        loss = float(met["loss"])
        if dev == "cuda":
            torch.cuda.synchronize()
        res[name] = {"loss": loss, "n": int(met["n_triplets"]),
                     "neg": met["negatives"].cpu(),
                     "aug": {k: v.cpu().float() for k, v in batch.items()},
                     "sd": {k: v.detach().cpu().double()
                            for k, v in model.state_dict().items()},
                     "s": time.perf_counter() - t0}
        del model, step, batch
    c, g, ref = res["cpu"], res.pop("cuda"), res["fp64"]
    valid = pair_masks(labels)[0]  # the pairs whose negative counts
    init64 = {k: v.double() for k, v in init.items()}
    out = {"anchors": b, "clips": len(views) * b,
           "loss_cpu": c["loss"], "loss_cuda": g["loss"],
           "loss_fp64_card": ref["loss"],
           "loss_rel_diff": abs(g["loss"] - c["loss"]) / abs(c["loss"]),
           "augment_max_abs_diff": max(float((g["aug"][k] - c["aug"][k])
                                             .abs().max()) for k in views),
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
           "n_triplets": g["n"], "cpu_step_s": c["s"],
           "fp64_card_step_s": ref["s"]}
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


def bf16_vs_fp32(cfg, init, host, fp64: bool = True):
    """(b) The full-width bf16 forward and backward against fp32 (TF32 off)
    and (``fp64``) fp64 on the card: the same weights, augmented batch and Gumbel
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
                              pre_cropped=True) for k in train_views(cfg)}
    batch["targets"] = torch.from_numpy(host["targets"]).cuda()
    noise = gumbel(gen, (batch["targets"].shape[0],) * 3)

    def cos(a, b):
        return float(torch.nn.functional.cosine_similarity(a, b, dim=0))

    out = {}
    for strategy, names in (
            (cfg.DATASET.SAMPLING_STRATEGY, ("bfloat16", "float32")),
            ("random_negative", ("bfloat16", "float32")
             + (("float64",) if fp64 else ()))):
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
    check(not fp64 or (held["fp32_vs_fp64_grad_cosine"] >= FP32_MIN_GRAD_COS
                       and held["fp32_vs_fp64_loss_rel_diff"] <= 1e-5),
          f"fp32 vs fp64: gradient cosine {held.get('fp32_vs_fp64_grad_cosine')}"
          f" >= {FP32_MIN_GRAD_COS}, loss within 1e-5 relative")
    check(held["grad_cosine"] >= BF16_MIN_GRAD_COS, "bf16 vs fp32 gradient "
          f"cosine {held['grad_cosine']} >= {BF16_MIN_GRAD_COS}")
    check(held["loss_rel_diff"] <= BF16_MAX_LOSS_REL, "bf16 vs fp32 loss: "
          f"relative difference {held['loss_rel_diff']} <= {BF16_MAX_LOSS_REL}")
    return out


def time_steps(cfg, init, host, accum: int, split: bool = True):
    """(c) Median ms of the bf16 step after two warm-up steps: the whole
    step (augmentation of the three views included) on the host clock, and
    with ``split`` the device ms of its parts (``device_split_ms`` over
    the real step: augment, forward + loss, backward, optimizer)."""
    import torch
    from torch.profiler import record_function

    from video_similarity_search_tpu_torch.train.steps import RANGES

    from video_similarity_search_tpu_torch.data.augment import train_augment
    from video_similarity_search_tpu_torch.ops import stem_conv
    from video_similarity_search_tpu_torch.train.driver import (
        _microbatch_leaf, step_seed)

    c = cfg.clone()
    c.TRAIN.ACCUM_STEPS = accum
    model, opt, _, step, _ = fresh_trainer(c, init, "cuda")
    dev_u8 = {k: torch.from_numpy(_microbatch_leaf(k, host[k], accum)
                                  if accum > 1 else host[k]).cuda()
              for k in train_views(c)}
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
    stem_conv.LAUNCHES = 0
    for i in range(TIMED_STEPS):
        t0 = time.perf_counter()
        step(augment(10 + i), gen)
        torch.cuda.synchronize()
        whole.append((time.perf_counter() - t0) * 1e3)
    launches = stem_conv.LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    seeds = iter(range(20, 20 + TIMED_STEPS))

    def one():
        with record_function("augment"):
            batch = augment(next(seeds))
        step(batch, gen)

    split = (device_split_ms(one, TIMED_STEPS, ("augment",) + RANGES)
             if accum == 1 and split else None)
    clips = len(dev_u8) * host["targets"].shape[0] // 2
    out = {"accum_steps": accum, "step_ms": float(np.median(whole)),
           "step_ms_all": whole, "clips": clips,
           "clips_per_s": clips / (float(np.median(whole)) / 1e3),
           "peak_mem_gib": peak, "stem_conv3d_launches": launches,
           "forwards": TIMED_STEPS * accum}
    if split:
        out["device_split_ms"] = split
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
             for k in train_views(cfg)}
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
    for row in timing:  # one train-mode forward a microbatch
        check(row["stem_conv3d_launches"] == row["forwards"], "one "
              "stem_conv3d launch a bf16 forward of the triplet step "
              f"(ACCUM_STEPS {row['accum_steps']}: "
              f"{row['stem_conv3d_launches']} in {row['forwards']})")
    torch.cuda.empty_cache()
    learn = learning_check(cfg, init, rng)
    emit("train_step", config="configs/resnet_ucf_itercluster_flow.yaml",
         arch="R3D-18", clip=[t, s, s, 3], anchors=b, clips_per_step=3 * b,
         dtype=str(cfg.TPU.COMPUTE_DTYPE),
         strategy=cfg.DATASET.SAMPLING_STRATEGY, lr=cfg.OPTIM.LR,
         momentum=cfg.OPTIM.MOMENTUM, fp32_card_vs_cpu=vs_cpu,
         bf16_vs_fp32=vs_fp32, timing=timing, learning=learn)
    return timing[0]["clips_per_s"], {
        f"accum_{row['accum_steps']}": row["stem_conv3d_launches"]
        for row in timing}


def run_cli(cmd, what: str, timeout: int = 900):
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"{what} exit {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    return proc.stdout, wall


def train_cli_annotations(ann: str, work: str,
                          classes: int = TRAIN_CLI_CLASSES):
    """The synthetic set's annotation cut to its first ``classes``
    classes, written to ``work`` twice: as it is, and with the test videos
    as the validation subset (the set has none). -> (test, validation)
    paths."""
    with open(ann) as f:
        spec = json.load(f)
    keep = set(spec["labels"][:classes])
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
    return ann_test, ann_val


def phase_train_cli(paths, step_clips_per_s: float):
    """python -m video_similarity_search_tpu_torch.cli.online_train --cfg
    configs/resnet_ucf_itercluster_flow.yaml --iterative_cluster on the
    synthetic UCF set cut to its first TRAIN_CLI_CLASSES classes (their
    test videos serve as the validation subset): TRAIN_CLI_EPOCHS epochs,
    clustering and retrieval every epoch; the evaluate CLI on the written
    checkpoint; then one more epoch resumed from it."""
    import torch

    jpg, ann, flow = paths
    work = os.path.join(OUT, "train_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ann_test, ann_val = train_cli_annotations(ann, work)
    out = os.path.join(work, "out")
    data = ["DATASET.VID_PATH", jpg, "DATASET.ANNOTATION_PATH", ann_val,
            "DATASET.OPTICAL_U_PATH", flow, "ITERCLUSTER.INTERVAL", "1",
            "TRAIN.RETRIEVAL_INTERVAL", "1"]
    cli = [sys.executable, "-m",
           "video_similarity_search_tpu_torch.cli.online_train",
           "--cfg", UCF_YAML, "--iterative_cluster", "--output", out,
           "--device", "cuda"]
    n_ep = TRAIN_CLI_EPOCHS
    stdout, wall = run_cli(cli + data + ["TRAIN.EPOCHS", str(n_ep)],
                           "training CLI")
    logs = os.path.join(out, "tnet_checkpoints")
    ckpt = os.path.join(logs, "3dresnet", "checkpoint.pth.tar")
    lines = {}
    for name in ("NMIs.txt", "AMIs.txt", "train_loss_and_acc.txt",
                 "val_loss_and_acc.txt", "global_retrieval_acc.txt"):
        with open(os.path.join(logs, name)) as f:
            lines[name] = f.read().splitlines()
        check(len(lines[name]) == n_ep, f"{name}: one line an epoch")
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
    check(len(rates) == n_ep, f"{n_ep} epoch summaries: {rates}")

    # the evaluate CLI loads the written checkpoint
    ev_out, ev_wall = run_cli(
        [sys.executable, "-m", "video_similarity_search_tpu_torch.cli.evaluate",
         "--cfg", UCF_YAML, "--checkpoint_path", ckpt, "--output",
         os.path.join(work, "eval"), "--device", "cuda", "--crop", "center",
         "DATASET.VID_PATH", jpg, "DATASET.ANNOTATION_PATH", ann_test,
         "DATASET.OPTICAL_U_PATH", flow], "evaluate CLI on the checkpoint")
    check("checkpoint: loaded" in ev_out and "kept 0 at init" in ev_out,
          "the evaluate CLI loaded every tensor of the checkpoint")

    # one more epoch, resumed from the run root
    saved = torch.load(ckpt, map_location="cpu", weights_only=False)
    n_params = len(saved["optimizer"]["state"])
    check(saved["epoch"] == n_ep and n_params > 0,
          f"the checkpoint resumes at epoch {n_ep} with momentum buffers")
    res_out, res_wall = run_cli(
        cli[:-2] + ["--checkpoint_path", out, "--device", "cuda"] + data
        + ["TRAIN.EPOCHS", str(n_ep + 1)], "resumed training CLI")
    want = (f"resume: epoch {n_ep}, best_prec1 {saved['best_prec1']}, optimizer "
            f"state for {n_params}/{n_params} parameters, schedule count "
            f"{saved['lr_schedule']['count']}")
    check(want in res_out and "WARNING: restore" not in res_out,
          f"resumed with the saved momentum buffers ({want!r})")
    with open(os.path.join(logs, "train_loss_and_acc.txt")) as f:
        after = f.read().splitlines()
    check(len(after) == n_ep + 1 and after[-1].startswith(f"epoch:{n_ep} "),
          f"the resumed run trained epoch {n_ep} only")
    check(torch.load(ckpt, map_location="cpu", weights_only=False)["epoch"]
          == n_ep + 1, f"epoch {n_ep + 1} saved")
    emit("train_cli", command=" ".join(cli[1:6]) + " ...", epochs=n_ep,
         wall_s=wall, train_videos=n_train, val_videos=TRAIN_CLI_CLASSES,
         train_loss=losses, val_lines=lines["val_loss_and_acc.txt"],
         nmi=lines["NMIs.txt"], retrieval=lines["global_retrieval_acc.txt"],
         loader_fed_triplets_per_s=rates,
         loader_fed_clips_per_s=[3 * r for r in rates],
         train_step_clips_per_s=step_clips_per_s,
         evaluate_wall_s=ev_wall, resume_wall_s=res_wall,
         resume_line=want, stdout_tail=stdout.strip().splitlines()[-3:])


# --------------------------------------------------------------------------
# the evaluation tools and fit_cluster's density / agglomerative methods

TOOLS_N = 9537  # UCF-101 split 1's training videos
TOOLS_D = 128
TOOLS_CLASSES = 101
TOOLS_TSNE_CLASSES = 20  # tsne_plot's and the tsne CLI's default
NEAR_RADIUS = 1e-5  # a pair this close to a radius may fall either side
PRESERVE_K = 10
# the share of 10-NN a map keeps: chance is k / N (0.0055 at 1,815 points,
# 0.001 at 9,537); the port's map of the 1,815 keeps 0.36 on the CPU
PRESERVE_MIN = 0.1
# the final KL on the card, by class count: 1.2x what the card gave
# (0.746 at 1,815 points, 0.880 at 9,537); at 1,815 points the card's KL is
# also held to the port's CPU run on the same rows
TSNE_MAX_KL = {TOOLS_TSNE_CLASSES: 0.9, TOOLS_CLASSES: 1.06}
TSNE_KL_REL_VS_CPU = 0.02


def planted_mixture(n: int, d: int, seed: int) -> np.ndarray:
    """tests/test_torch_port_density.py's mixture (before it drops the rows
    near a radius): n // 25 unit centres, each cluster's spread drawn so
    that its mean cosine distance is 0.06-0.25, and 5% uniform noise, so
    the clusters straddle DBSCAN's 0.14 and OPTICS' 0.2."""
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
    return x.astype(np.float32)


def near_radius_points(x, radius: float, tol: float = NEAR_RADIUS):
    """Points in a pair whose float64 cosine distance is within ``tol`` of
    ``radius`` (on the card, in row blocks)."""
    import torch

    xn = torch.as_tensor(x, dtype=torch.float64, device="cuda")
    xn = xn / xn.norm(dim=1, keepdim=True)
    near = torch.zeros(xn.shape[0], dtype=torch.bool, device="cuda")
    for start in range(0, xn.shape[0], 2048):
        d = 1.0 - xn[start:start + 2048] @ xn.T
        hit = (d - radius).abs() < tol
        own = torch.arange(d.shape[0], device="cuda")
        hit[own, own + start] = False
        near[start:start + 2048] |= hit.any(1)
        near |= hit.any(0)
    return near.cpu().numpy()


DENSITY_RADIUS = {"DBSCAN": 0.14, "OPTICS": 0.2}  # fit_cluster's eps, max_eps


def density_card_vs_cpu(method: str, x: np.ndarray, card: np.ndarray,
                        what: str) -> dict:
    """fit_cluster(method) labels ``card`` from the card against the port's
    own CPU run on the same rows: equal except in the clusters of a point
    that lies in a pair within NEAR_RADIUS of the method's radius."""
    import torch

    from video_similarity_search_tpu_torch.cluster import density, fit_cluster

    radius = DENSITY_RADIUS[method]
    cpu = fit_cluster(x, method=method, device="cpu", verbose=False)
    edges = int(density.radius_graph(torch.from_numpy(x).cuda(),
                                     radius)[0].numel())
    near = near_radius_points(x, radius)
    tainted = near.copy()
    for lab in (card, cpu):
        ids = np.unique(lab[near])
        tainted |= np.isin(lab, ids[ids >= 0])
    differ = card != cpu
    check(not (differ & ~tainted).any(),
          f"{what} card vs CPU: {int(differ.sum())} labels differ, "
          f"{int((differ & ~tainted).sum())} away from the radius")
    return {"edges": edges,
            "clusters": int(len(np.unique(card[card >= 0]))),
            "noise": int((card == -1).sum()),
            "points_near_radius": int(near.sum()),
            "labels_differing_from_cpu": int(differ.sum()),
            "labels_allowed_to_differ": int(tainted.sum())}


def fit_cluster_on_card(method: str, x: np.ndarray) -> dict:
    """fit_cluster(x, method, device="cuda") as the cluster step calls it,
    timed, and held to the CPU run."""
    from video_similarity_search_tpu_torch.cluster import fit_cluster

    def fit():
        return fit_cluster(x, method=method, device="cuda", verbose=False)

    card = fit()
    out = {"ms": time_ms(fit, reps=3)}
    out.update(density_card_vs_cpu(method, x, card, f"fit_cluster {method}"))
    return out


def dbscan_240k(x: np.ndarray) -> dict:
    """DBSCAN on the card over 240,000 rows: time, edges, clusters and the
    peak of allocated device memory during the call."""
    import torch

    from video_similarity_search_tpu_torch.cluster import density

    xc = torch.from_numpy(x).cuda()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    labels = density.dbscan(xc, device="cuda").cpu().numpy()
    peak = torch.cuda.max_memory_allocated()
    out = {"ms": time_ms(lambda: density.dbscan(xc, device="cuda"), reps=1),
           "edges": int(density.radius_graph(xc, 0.14)[0].numel()),
           "clusters": int(len(np.unique(labels[labels >= 0]))),
           "noise": int((labels == -1).sum()),
           "peak_mib_above_input": (peak - resident) / 2 ** 20}
    check(out["edges"] >= x.shape[0] and labels.shape == (x.shape[0],),
          "DBSCAN at 240k: every row has its self edge and a label")
    return out


def knn_preservation(x, y, k: int = PRESERVE_K) -> float:
    """The share of each row's k nearest rows of ``x`` (euclidean) that are
    among its k nearest in the map ``y``, averaged."""
    from video_similarity_search_tpu_torch.ops.pdist import topk_neighbors

    kx, ky = (topk_neighbors(a, a, k, metric="euclidean",
                             exclude_self=True)[0] for a in (x, y))
    hits = (kx[:, :, None] == ky[:, None, :]).any(2).float()
    return float(hits.mean())


def png_size(path: str):
    from PIL import Image

    with Image.open(path) as im:
        im.load()
        return im.size


def phase_tools(paths) -> int:
    """fit_cluster's DBSCAN and OPTICS on the card over a planted 9,537 x
    128 mixture against the port's CPU run, Agglomerative on the host, and
    DBSCAN over 240,000 x 128 rows (the planted mixture, and the kernel
    phase's mixture, which has no pair within the radius: the scan alone);
    tsne_plot on the card (20 of 101 classes, and all 9,537 points) with
    its final KL and 10-NN preservation, the 1,815 points' KL held to the
    port's CPU run; the evaluate CLI with --heatmap 0,1 --plot on the cli
    phase's checkpoint and cached embeddings (its heat map held to an
    in-process temporal_heat_map), the tsne CLI and, as python -m,
    generate_report on train_cli's OUTPUT_PATH; each PNG decoded at its
    declared size; the cluster step with ITERCLUSTER.METHOD DBSCAN, its
    labels held to the CPU run on the embeddings it clustered.
    nn1_cosine's launches counted from 0 just before the phase. -> those
    launches (0)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from video_similarity_search_tpu_torch.cli import evaluate
    from video_similarity_search_tpu_torch.cli import tsne as tsne_cli
    from video_similarity_search_tpu_torch.cluster import fit_cluster
    from video_similarity_search_tpu_torch.data import build_data_loader
    from video_similarity_search_tpu_torch.evaluation import heatmap
    from video_similarity_search_tpu_torch.evaluation import tsne as tsne_mod
    from video_similarity_search_tpu_torch.evaluation.report import (
        parse_scalar_log, parse_val_log)
    from video_similarity_search_tpu_torch.models import model_selector
    from video_similarity_search_tpu_torch.ops import fused_knn
    from video_similarity_search_tpu_torch.train import driver
    from video_similarity_search_tpu_torch.train.checkpoint import (
        load_encoder_state, load_torch_checkpoint)

    jpg, ann, flow = paths
    work = os.path.join(OUT, "tools")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    fused_knn.LAUNCHES = 0

    # (1) the density methods and Agglomerative at UCF-101's train size
    x = planted_mixture(TOOLS_N, TOOLS_D, SEED)
    clusters = {m.lower(): fit_cluster_on_card(m, x)
                for m in ("DBSCAN", "OPTICS")}
    t0 = time.perf_counter()
    agg = fit_cluster(x, method="Agglomerative", device="cuda", verbose=False)
    clusters["agglomerative_host"] = {
        "s": time.perf_counter() - t0,
        "clusters": int(len(np.unique(agg)))}
    check(agg.shape == (TOOLS_N,) and agg.min() == 0,
          "Agglomerative labels every row")
    clusters["dbscan_240k_planted"] = dbscan_240k(
        planted_mixture(240_000, TOOLS_D, SEED))
    clusters["dbscan_240k_kernel_mixture"] = dbscan_240k(
        mixture(240_000, seed=0)[0])

    # (2) t-SNE on the card: 20 of 101 classes, then every point
    emb, lbl = mixture(TOOLS_N, d=TOOLS_D, classes=TOOLS_CLASSES, seed=1)
    tsne, cpu_rows = {}, None
    for n_cls in (TOOLS_TSNE_CLASSES, TOOLS_CLASSES):
        png = os.path.join(work, f"tsne_{n_cls}.png")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tsne_mod.tsne_plot(emb, lbl, out_path=png, n_classes=n_cls,
                           device="cuda")
        plot_ms = 1e3 * (time.perf_counter() - t0)
        check(png_size(png) == (1500, 1200), f"{png}: 1500 x 1200")
        rows = emb[np.isin(lbl, tsne_mod.choose_classes(lbl, n_cls, 0))]
        xs = tsne_mod.pca(torch.from_numpy(rows).cuda(), 50).float()
        if n_cls == TOOLS_TSNE_CLASSES:
            cpu_rows = xs.cpu()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, kl, it = tsne_mod.tsne(xs, perplexity=30.0, device="cuda")
        torch.cuda.synchronize()
        tsne_ms = 1e3 * (time.perf_counter() - t0)
        pres = knn_preservation(xs, y)
        chance = PRESERVE_K / len(rows)
        check(bool(torch.isfinite(y).all()) and np.isfinite(kl)
              and kl < TSNE_MAX_KL[n_cls],
              f"t-SNE of {len(rows)} points: KL {kl}")
        check(pres >= PRESERVE_MIN,
              f"t-SNE of {len(rows)} points: 10-NN preservation {pres}")
        tsne[str(len(rows))] = {
            "classes": n_cls, "plot_ms": plot_ms, "tsne_ms": tsne_ms,
            "kl": kl, "last_iter": it, "knn10_preservation": pres,
            "chance": chance}

    # the CPU t-SNE of the 1,815 points runs in a thread beside (3) and (4)
    pool = ThreadPoolExecutor(1)
    cpu_run = pool.submit(tsne_mod.tsne, cpu_rows, 30.0, device="cpu")

    # (3) the CLIs on the cli and train_cli phases' outputs
    ckpt = os.path.join(OUT, "cli", "r3d18_seed0.pth.tar")
    cli_out = os.path.join(OUT, "cli", "out")  # holds the cached embeddings
    data = ["DATASET.VID_PATH", jpg, "DATASET.ANNOTATION_PATH", ann,
            "DATASET.OPTICAL_U_PATH", flow]
    captured = {}

    def capture(*args, **kw):
        captured["heat"] = heat_map(*args, **kw)
        return captured["heat"]

    heat_map = heatmap.temporal_heat_map
    heatmap.temporal_heat_map = capture
    try:
        ev_out, ev_wall = run_main(evaluate.main, [
            "--cfg", UCF_YAML, "--checkpoint_path", ckpt, "--output",
            cli_out, "--device", "cuda", "--heatmap", "0,1", "--plot"]
            + data, "evaluate CLI --heatmap 0,1 --plot")
    finally:
        heatmap.temporal_heat_map = heat_map
    cfg = ucf_cfg(jpg, ann, flow, cli_out)
    model = model_selector(cfg)
    load_encoder_state(model, load_torch_checkpoint(ckpt)["torch_state_dict"],
                       verbose=False)
    _, (test_ds, _) = build_data_loader("test", cfg, triplets=False,
                                        drop_last=False, batch_size=1,
                                        device="cuda")
    pos, dists = heat_map(model, cfg, test_ds, exemplar_idx=0, test_idx=1,
                          device="cuda")
    heat_err = float(np.abs(dists - captured["heat"][1]).max())
    check(np.array_equal(pos, captured["heat"][0]) and heat_err <= 1e-5,
          f"the CLI's heat map vs in-process: {heat_err}")
    n_test = len(test_ds.samples)
    grid = ((5 + 1) * 240, min(4, n_test) * 240)
    for name, size in (("temporal_heat_map.png", (960, 360)),
                       ("exemplar_retrievals.png", grid)):
        got = png_size(os.path.join(cli_out, name))
        check(got == size, f"{name}: {got} (want {size})")

    work_cli = os.path.join(OUT, "train_cli")
    tsne_png = os.path.join(work, "tsne_cli.png")
    ts_out, ts_wall = run_main(tsne_cli.main, [
        "--cfg", UCF_YAML, "--checkpoint_path", ckpt, "--output", tsne_png,
        "--split", "val", "--device", "cuda", "DATASET.VID_PATH", jpg,
        "DATASET.ANNOTATION_PATH",
        os.path.join(work_cli, "annotation_trainval.json"),
        "DATASET.OPTICAL_U_PATH", flow], "tsne CLI")
    check(png_size(tsne_png) == (1500, 1200), "tsne CLI PNG: 1500 x 1200")

    run_dir = os.path.join(work_cli, "out")
    logs = os.path.join(run_dir, "tnet_checkpoints")
    val = parse_val_log(os.path.join(logs, "val_loss_and_acc.txt"))
    panels = 2 + sum(bool(v) for v in (
        val["top1"], parse_scalar_log(os.path.join(logs, "NMIs.txt")),
        parse_scalar_log(os.path.join(logs, "AMIs.txt"))))
    rep_out, rep_wall = run_cli(
        [sys.executable, "-m",
         "video_similarity_search_tpu_torch.cli.generate_report",
         "--output_path", run_dir], "generate_report CLI", timeout=300)
    rep_png = os.path.join(logs, "training_progress.png")
    check(png_size(rep_png) == (600 * panels, 525),
          f"training_progress.png: {png_size(rep_png)} ({panels} panels)")

    # (4) the cluster step with ITERCLUSTER.METHOD DBSCAN, on the card
    cfg.OUTPUT_PATH = os.path.join(work, "cluster_step_dbscan")
    cfg.ITERCLUSTER.METHOD = "DBSCAN"
    train_loader, (train_ds, _) = build_data_loader(
        "train", cfg, triplets=False, req_train_shuffle=False,
        drop_last=False, device="cuda")
    seen = {}

    def record(emb, **kw):
        seen["emb"] = np.asarray(emb, np.float32)
        seen["labels"] = fit(emb, **kw)
        return seen["labels"]

    fit, before = driver.fit_cluster, fused_knn.LAUNCHES
    driver.fit_cluster = record
    try:
        t0 = time.perf_counter()
        step_labels = driver.iterative_cluster_step(model, cfg, train_loader,
                                                    device="cuda")
        step_s = time.perf_counter() - t0
    finally:
        driver.fit_cluster = fit
    step = {"videos": len(train_ds), "s": step_s,
            "nn1_cosine_launches": fused_knn.LAUNCHES - before}
    step.update(density_card_vs_cpu("DBSCAN", seen["emb"], seen["labels"],
                                    "the DBSCAN cluster step"))
    with open(os.path.join(cfg.OUTPUT_PATH, "vid_clusters.txt")) as f:
        lines = [ln for ln in f.read().splitlines() if ln]
    check(np.array_equal(np.array(lines, np.int64), step_labels)
          and len(lines) == len(train_ds),
          "DBSCAN step: vid_clusters.txt holds the labels, one a video")

    cpu_n = str(cpu_rows.shape[0])
    _, cpu_kl, _ = cpu_run.result()
    pool.shutdown()
    tsne[cpu_n]["cpu_kl"] = cpu_kl
    rel = abs(tsne[cpu_n]["kl"] - cpu_kl) / cpu_kl
    check(rel <= TSNE_KL_REL_VS_CPU,
          f"t-SNE of {cpu_n} points: card KL {tsne[cpu_n]['kl']} vs CPU "
          f"{cpu_kl}")

    launches = fused_knn.LAUNCHES
    check(launches == 0, f"the tools launched nn1_cosine {launches} times")
    emit("tools", clusters=clusters, tsne=tsne, dbscan_cluster_step=step,
         evaluate_wall_s=ev_wall, heat_map_positions=[int(p) for p in pos],
         heat_map_max_abs_err_vs_in_process=heat_err,
         exemplar_grid=list(grid), tsne_cli_wall_s=ts_wall,
         generate_report_wall_s=rep_wall, report_panels=panels,
         nn1_cosine_launches=launches)
    return launches


# --------------------------------------------------------------------------
# k-means (ITERCLUSTER.METHOD's default) at the Kinetics bank's size

KMEANS_K = 1000  # ITERCLUSTER.K
KMEANS_N_INIT, KMEANS_ITERS = 10, 50  # fit_cluster's restarts, max_iter
KMEANS_CHECK_N = 20000
# the card's float32 Lloyd run against a float64 one from the same initial
# points on KMEANS_CHECK_N points: after one update only near-ties may
# differ; after KMEANS_ITERS a flipped point moves two centres, so a few
# more may follow, and the inertia stays within 1e-4
KMEANS_MIN_AGREE = {1: 0.9999, KMEANS_ITERS: 0.99}
KMEANS_MAX_INERTIA_REL = {1: 1e-6, KMEANS_ITERS: 1e-4}
UCF_KMEANS_K = SYN["classes"]  # the synthetic set has 440 train videos


def lloyd_fp64(x, idx, iters: int, spherical: bool):
    """Plain float64 Lloyd iterations from the points ``idx`` (the
    reference the port's float32 k-means is held to): -> (labels,
    inertia)."""
    import torch

    x = x.double()
    if spherical:
        x = x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)
    c = x[idx]
    k = c.shape[0]

    def dist(c):
        return ((x * x).sum(1)[:, None] + (c * c).sum(1)[None, :]
                - 2.0 * x @ c.T)

    for _ in range(iters):
        a = dist(c).argmin(1)
        sums = torch.zeros_like(c).index_add_(0, a, x)
        counts = torch.bincount(a, minlength=k).double()
        c = torch.where(counts[:, None] > 0, sums / counts.clamp_min(1)[:, None],
                        c)
        if spherical:
            c = c / c.norm(dim=1, keepdim=True).clamp_min(1e-12)
    d = dist(c)
    a = d.argmin(1)
    return a, float(d.gather(1, a[:, None]).sum())


def phase_kmeans(bank: np.ndarray, bank_lbl: np.ndarray, ucf, ucf_model,
                 train_loader, train_ds):
    """kmeans and spherical_kmeans over the 240,000 x 128 planted mixture
    with K = 1000, 10 restarts and 50 iterations, timed; the float32 run
    held to a float64 Lloyd run from the same points on 20k of them;
    iterative_cluster_step with ITERCLUSTER.METHOD kmeans on the UCF set.
    None of it launches nn1_cosine."""
    import torch

    from video_similarity_search_tpu_torch.cluster import (fit_cluster,
                                                           kmeans,
                                                           spherical_kmeans)
    from video_similarity_search_tpu_torch.ops import fused_knn
    from video_similarity_search_tpu_torch.train.driver import \
        iterative_cluster_step

    fused_knn.LAUNCHES = 0
    x = torch.from_numpy(bank).cuda()
    timed = {}
    for name, fn, kw in (("kmeans", kmeans, {"l2normalize": True}),
                         ("spherical_kmeans", spherical_kmeans, {})):
        fn(x[:4096], 8, n_init=1, max_iter=2, device="cuda", **kw)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        labels, inertia = fn(x, KMEANS_K, n_init=KMEANS_N_INIT,
                             max_iter=KMEANS_ITERS, seed=SEED, device="cuda",
                             **kw)
        inertia = float(inertia)  # waits for the card
        labels = labels.cpu().numpy()
        timed[name] = {"s": time.perf_counter() - t0, "inertia": inertia,
                       "clusters": int(len(np.unique(labels))),
                       "nmi_vs_planted": nmi(bank_lbl, labels),
                       "peak_mem_gib": torch.cuda.max_memory_allocated()
                       / 2 ** 30}
        check(labels.shape == (bank.shape[0],) and np.isfinite(inertia),
              f"{name}: a label a point and a finite inertia")
    fit_s = time.perf_counter()
    fit_labels = fit_cluster(bank, method="kmeans", k=KMEANS_K,
                             verbose=False, device="cuda")
    fit_s = time.perf_counter() - fit_s
    check(fit_labels.shape == (bank.shape[0],), "fit_cluster('kmeans')")

    # float32 on the card against float64 from the same initial points
    sub = x[:KMEANS_CHECK_N]
    idx = np.random.default_rng(SEED).choice(KMEANS_CHECK_N, KMEANS_K,
                                             replace=False)
    vs64 = {}
    for name, spherical in (("kmeans", False), ("spherical_kmeans", True)):
        for iters in (1, KMEANS_ITERS):
            lt, it = kmeans(sub, KMEANS_K, n_init=1, max_iter=iters,
                            spherical=spherical, init_idx=idx[None],
                            device="cuda")
            l64, i64 = lloyd_fp64(sub, torch.from_numpy(idx).cuda(), iters,
                                  spherical)
            agree = float((lt == l64).float().mean())
            rel = abs(float(it) - i64) / i64
            vs64[f"{name}_iters{iters}"] = {"labels_agree": agree,
                                             "inertia_rel_diff": rel}
            check(agree >= KMEANS_MIN_AGREE[iters]
                  and rel <= KMEANS_MAX_INERTIA_REL[iters],
                  f"{name}, {iters} iterations, float32 vs float64: labels "
                  f"agree {agree} (>= {KMEANS_MIN_AGREE[iters]}), inertia "
                  f"{rel} (<= {KMEANS_MAX_INERTIA_REL[iters]})")
    del x, sub

    # the iterative-cluster step with k-means on the UCF set
    cfg = ucf.clone()
    cfg.OUTPUT_PATH = os.path.join(OUT, "kmeans_step")
    cfg.ITERCLUSTER.METHOD = "kmeans"
    cfg.ITERCLUSTER.K = UCF_KMEANS_K
    shutil.rmtree(cfg.OUTPUT_PATH, ignore_errors=True)
    t0 = time.perf_counter()
    step_labels = iterative_cluster_step(ucf_model, cfg, train_loader,
                                         device="cuda")
    step_s = time.perf_counter() - t0
    with open(os.path.join(cfg.OUTPUT_PATH, "vid_clusters.txt")) as f:
        lines = [ln for ln in f.read().splitlines() if ln]
    check(np.array_equal(np.array(lines, np.int64), step_labels)
          and len(lines) == len(train_ds),
          "vid_clusters.txt holds the k-means labels, one a video")
    check(len(np.unique(step_labels)) <= UCF_KMEANS_K,
          f"at most {UCF_KMEANS_K} clusters")
    true = np.array([s["label"] for s in train_ds.samples])
    launches = fused_knn.LAUNCHES
    check(launches == 0, f"k-means launched nn1_cosine {launches} times")
    emit("kmeans", n=int(bank.shape[0]), d=int(bank.shape[1]), k=KMEANS_K,
         n_init=KMEANS_N_INIT, max_iter=KMEANS_ITERS, timed=timed,
         fit_cluster_s=fit_s, vs_fp64_on=KMEANS_CHECK_N, vs_fp64=vs64,
         ucf_step={"videos": len(train_ds), "k": UCF_KMEANS_K,
                   "s": step_s, "clusters": int(len(np.unique(step_labels))),
                   "nmi": nmi(true, step_labels)},
         nn1_cosine_launches=launches)


# --------------------------------------------------------------------------
# the ResNet3D and loss options of the triplet pretrain, one at a time

MEM_TRIPLET_K = 640  # a multiple of 2B = 64; the default 40 is not
TRAIN_OPTIONS = {
    "mem_triplet": ["LOSS.MEM_TRIPLET", True,
                    "LOSS.MEM_TRIPLET_K", MEM_TRIPLET_K],
    "attention": ["RESNET.ATTENTION", True],
    "stem_s2d": ["TPU.STEM_S2D", True],
    "remat_all": ["TPU.REMAT", True],
    "remat_stage1": ["TPU.REMAT", True, "TPU.REMAT_STAGES", "1"],
}


def stem_vs_7x7(cfg7, init7, cfg_s2d, init_s2d, host):
    """The space-to-depth stem against the 7x7 stem it was made from, on
    the step's 96 normalized clips: the forward's ms of each ``conv1``
    call under bf16 autocast in channels_last_3d (the 7x7's is cuDNN's,
    which the bf16 step no longer calls: it runs ``stem_conv3d``), and the
    s2d output against the 7x7 one in float32 (TF32 off) and in bf16."""
    import torch

    from video_similarity_search_tpu_torch.data.augment import normalize_only
    from video_similarity_search_tpu_torch.models import model_selector
    from video_similarity_search_tpu_torch.models.resnet3d import \
        space_to_depth

    x = normalize_only(torch.from_numpy(np.concatenate(
        [host[k] for k in TRAIN_VIEWS])).cuda(), dataset=cfg7.TRAIN.DATASET)
    stems = {}
    for name, cfg, init in (("7x7", cfg7, init7), ("s2d", cfg_s2d, init_s2d)):
        model = model_selector(cfg)
        model.load_state_dict(init)
        stems[name] = model.conv1.cuda().to(
            memory_format=torch.channels_last_3d)
        del model
    out_hw = x.shape[2] // 2

    def run(name, dtype):
        with torch.inference_mode(), torch.autocast(
                "cuda", dtype=dtype, enabled=dtype != torch.float32):
            if name == "7x7":
                return stems[name](x.permute(0, 4, 1, 2, 3))
            xs = space_to_depth(x).permute(0, 4, 1, 2, 3)
            return stems[name](xs)[..., :out_hw, :out_hw]

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        ref, got = run("7x7", dtype).float(), run("s2d", dtype).float()
        err = float((got - ref).abs().max())
        out[str(dtype).split(".")[-1]] = {
            "max_abs_diff": err, "rel_to_max": err / float(ref.abs().max())}
    out["ms_7x7"] = time_ms(lambda: run("7x7", torch.bfloat16))
    out["ms_s2d"] = time_ms(lambda: run("s2d", torch.bfloat16))
    out["clips"] = int(x.shape[0])
    check(out["float32"]["rel_to_max"] <= 1e-5, "s2d stem = 7x7 stem in "
          f"float32 within 1e-5 of its largest value ({out['float32']})")
    return out


def phase_train_options():
    """R3D-18 on the UCF config with the train_step phase's 96 in-memory
    clips, one option at a time (LOSS.MEM_TRIPLET with 640 slots,
    RESNET.ATTENTION, TPU.STEM_S2D, TPU.REMAT on all stages and on stage
    1): one fp32 step on the card held to the CPU and to an fp64 run on the card
    at 2 anchors, as train_step (a) holds the plain step (both remat
    options to one CPU and one fp64 run), and a timed bf16 step; for the s2d
    stem its forward beside the 7x7 stem's."""
    import torch

    from video_similarity_search_tpu_torch.models import model_selector
    from video_similarity_search_tpu_torch.models.resnet3d import \
        conv1_kernel_to_s2d

    base = ["OUTPUT_PATH", os.path.join(OUT, "train_options")]
    cfg7 = load_cfg(UCF_YAML, base)
    b, t, s = (cfg7.TRAIN.BATCH_SIZE, cfg7.DATA.SAMPLE_DURATION,
               cfg7.DATA.SAMPLE_SIZE)
    torch.manual_seed(SEED)
    init7 = model_selector(cfg7).state_dict()
    host = triplet_batch(np.random.default_rng(SEED), b, t, s, n_cls=16)
    out, remat_cpu = {}, {}  # remat changes memory, not arithmetic
    for name, opts in TRAIN_OPTIONS.items():
        cfg = load_cfg(UCF_YAML, base + opts)
        torch.manual_seed(SEED)
        init = model_selector(cfg).state_dict()
        if name == "stem_s2d":  # the 7x7 model's weights, its stem mapped
            init = dict(init7, **{"conv1.weight": conv1_kernel_to_s2d(
                init7["conv1.weight"])})
        row = {"fp32_card_vs_cpu": step_vs_cpu(
            cfg, init, host, remat_cpu if name.startswith("remat") else None)}
        torch.cuda.empty_cache()
        row["bf16_step"] = time_steps(cfg, init, host, 1, split=False)
        torch.cuda.empty_cache()
        if name == "stem_s2d":
            row["stem"] = stem_vs_7x7(cfg7, init7, cfg, init, host)
        out[name] = row
    emit("train_options", config="configs/resnet_ucf_itercluster_flow.yaml",
         arch="R3D-18", clip=[t, s, s, 3], anchors=b, clips_per_step=3 * b,
         mem_triplet_k=MEM_TRIPLET_K, options=out)
    return {k: v["bf16_step"]["step_ms"] for k, v in out.items()}


# --------------------------------------------------------------------------
# the contrastive (NCE / MemoryMoCo) pretrain at bench.py:276's shape

NCE_ANCHORS = 64  # bench.py contrastive_step_bench(batch=64)
NCE_K, NCE_FEAT = 1024, 128  # LOSS.K, LOSS.FEAT_DIM
NCE_DATA = 9537  # UCF-101 split 1's training videos
NCE_VARIANTS = {"rgb": ["DATASET.MODALITY", "rgb"],
                "res": [],  # the default MODALITY False means res
                "intra_neg": ["DATASET.MODALITY", "rgb",
                              "LOSS.INTRA_NEGATIVE", True],
                "moco": ["DATASET.MODALITY", "rgb", "LOSS.MOCO", True]}
NCE_FP64_ANCHORS = 16  # the fp32-vs-fp64 step: fp64 R3D-18 at 2 x 16 clips
NCE_CLI_CLASSES = 10  # of the synthetic set's 40: 110 train videos
# the config's lr 0.1 on the unnormalized projections (as in JAX) can send
# the CLI's few steps to NaN embeddings before validation; the CLI run
# checks the path and the resume, not the learning rate
NCE_CLI_LR = 0.001
NCE_MAX_LOSS_REL = 1e-4
NCE_MIN_GRAD_COS = 0.999


def contrastive_cfg(variant: str, extra=()):
    return load_cfg(UCF_YAML, ["LOSS.TYPE", "contrastive",
                               "TRAIN.BATCH_SIZE", NCE_ANCHORS,
                               "LOSS.K", NCE_K, "LOSS.FEAT_DIM", NCE_FEAT,
                               "OUTPUT_PATH", os.path.join(OUT, "nce")]
                    + NCE_VARIANTS[variant] + list(extra))


def contrastive_trainer(cfg, init, device, dtype=None):
    """R3D-18 from ``init`` on ``device`` (cast to ``dtype``) with its
    optimizer, seeded bank over NCE_DATA videos and contrastive step."""
    from video_similarity_search_tpu_torch.models import model_selector
    from video_similarity_search_tpu_torch.train.driver import \
        make_train_step
    from video_similarity_search_tpu_torch.train.state import make_optimizer
    from video_similarity_search_tpu_torch.train.steps import make_banks

    model = model_selector(cfg)
    model.load_state_dict(init)
    model.to(device)
    if dtype is not None:
        model.to(dtype)
    opt, sched = make_optimizer(cfg, model.parameters())
    banks = make_banks(cfg, NCE_DATA)
    step, _ = make_train_step(cfg, model, opt, sched, banks, device=device)
    return model, banks, step


def nce_views(rng, b, t, s, structured=False):
    """Normalized view1 / view2 clips on the card and their dataset
    indices; ``structured``: two clips of one class colour a row."""
    import torch

    from video_similarity_search_tpu_torch.data.augment import normalize_only

    labels = rng.integers(0, 8, b)
    views = {k: normalize_only(torch.from_numpy(class_clips(
        rng, labels, t, s, 8, structured)).cuda(), dataset="ucf101")
        for k in ("view1", "view2")}
    views["index"] = torch.from_numpy(rng.choice(NCE_DATA, b,
                                                 replace=False)).cuda()
    return views


def contrastive_fp32_vs_fp64(init):
    """One rgb step, fp32 (TF32 off) against fp64 networks on the card
    (banks and losses float32 in both, as in the JAX step), from the same
    weights, bank and NCE draws: the loss, the whole gradient's cosine and
    the banks after the step."""
    import torch

    cfg = contrastive_cfg("rgb", ["TPU.COMPUTE_DTYPE", "float32"])
    t, s = cfg.DATA.SAMPLE_DURATION, cfg.DATA.SAMPLE_SIZE
    batch = nce_views(np.random.default_rng(SEED + 1), NCE_FP64_ANCHORS, t, s)
    gen = torch.Generator().manual_seed(SEED)
    idx = torch.randint(0, NCE_DATA, (NCE_FP64_ANCHORS, NCE_K + 1),
                        generator=gen)
    res = {}
    for dtype in (torch.float32, torch.float64):
        model, banks, step = contrastive_trainer(cfg, init, "cuda", dtype)
        b = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in batch.items()}
        met = step(b, nce_idx=idx)  # the gradients stay until the next
        grad = torch.cat([p.grad.double().flatten()
                          for p in model.parameters()])
        res[dtype] = {"loss": float(met["loss"]), "grad": grad,
                      "bank": banks["nce"].memory_l.detach().clone()}
        del model, banks, step
        torch.cuda.empty_cache()
    lo, hi = res[torch.float32], res[torch.float64]
    out = {"anchors": NCE_FP64_ANCHORS, "loss_fp32": lo["loss"],
           "loss_fp64": hi["loss"],
           "loss_rel_diff": abs(lo["loss"] - hi["loss"]) / abs(hi["loss"]),
           "grad_cosine": float(torch.nn.functional.cosine_similarity(
               lo["grad"], hi["grad"], dim=0)),
           "bank_max_abs_diff": float((lo["bank"] - hi["bank"]).abs().max())}
    check(out["loss_rel_diff"] <= NCE_MAX_LOSS_REL
          and out["grad_cosine"] >= NCE_MIN_GRAD_COS
          and out["bank_max_abs_diff"] <= 1e-4,
          f"contrastive fp32 vs fp64: {out}")
    return out


def time_contrastive(variant: str, init, host_rng):
    """ms of a bf16 step (median of TIMED_STEPS after two warm-up steps,
    host clock around a synchronized step), clips/s (forward clips: the
    views times the anchors) and peak GiB."""
    import torch

    cfg = contrastive_cfg(variant)
    model, banks, step = contrastive_trainer(cfg, init, "cuda")
    t, s = cfg.DATA.SAMPLE_DURATION, cfg.DATA.SAMPLE_SIZE
    batch = nce_views(host_rng, NCE_ANCHORS, t, s)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # the first step's loss, from the seeded weights (the timed steps'
    # losses follow lr 0.1 on one batch: MoCo's reaches ~1e25 by then)
    first = float(step(batch, gen)["loss"])
    step(batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        met = step(batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    n_views = 3 if variant == "intra_neg" else 2
    ms = float(np.median(times))
    check(np.isfinite(first), f"{variant}: a finite first loss ({first})")
    return {"step_ms": ms, "step_ms_all": times, "views": n_views,
            "clips_per_s": n_views * NCE_ANCHORS / (ms / 1e3),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "bank": sorted(banks), "first_loss": first,
            "last_loss": float(met["loss"])}


def contrastive_learning(init):
    """LEARN_STEPS bf16 rgb steps on one fixed batch of class-coloured
    clip pairs lower the loss."""
    import torch

    cfg = contrastive_cfg("rgb")
    _, _, step = contrastive_trainer(cfg, init, "cuda")
    batch = nce_views(np.random.default_rng(SEED + 2), NCE_ANCHORS,
                      cfg.DATA.SAMPLE_DURATION, cfg.DATA.SAMPLE_SIZE,
                      structured=True)
    gen = torch.Generator(device="cuda")
    losses = []
    for i in range(LEARN_STEPS):
        gen.manual_seed(SEED + i)
        losses.append(step(batch, gen)["loss"])
    losses = [float(v) for v in losses]
    ratio = float(np.mean(losses[-5:])) / losses[0]
    check(all(np.isfinite(losses)) and ratio <= LEARN_MAX_RATIO,
          f"contrastive learning check: the last 5 steps' mean loss is "
          f"{ratio:.3f} of the first's (<= {LEARN_MAX_RATIO})")
    return {"steps": LEARN_STEPS, "first": losses[0],
            "last5_mean": float(np.mean(losses[-5:])), "ratio": ratio}


def contrastive_cli(paths):
    """The training CLI with LOSS.TYPE contrastive and k-means clustering
    on NCE_CLI_CLASSES classes of the synthetic set: one epoch as python
    -m, then a second resumed from its checkpoint in this process, whose
    banks must be the saved ones."""
    import torch

    from video_similarity_search_tpu_torch.cli import online_train
    from video_similarity_search_tpu_torch.train import steps

    jpg, ann, flow = paths
    work = os.path.join(OUT, "nce_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ann_val = train_cli_annotations(ann, work, NCE_CLI_CLASSES)[1]
    out = os.path.join(work, "out")
    opts = ["DATASET.VID_PATH", jpg, "DATASET.ANNOTATION_PATH", ann_val,
            "DATASET.OPTICAL_U_PATH", flow, "LOSS.TYPE", "contrastive",
            "DATASET.MODALITY", "rgb", "LOSS.K", str(NCE_K),
            "LOSS.FEAT_DIM", str(NCE_FEAT), "ITERCLUSTER.METHOD", "kmeans",
            "ITERCLUSTER.K", str(NCE_CLI_CLASSES), "ITERCLUSTER.INTERVAL",
            "1", "OPTIM.LR", str(NCE_CLI_LR)]
    cli = ["--cfg", UCF_YAML, "--iterative_cluster", "--output", out,
           "--device", "cuda"]
    stdout, wall = run_cli([sys.executable, "-m",
                            "video_similarity_search_tpu_torch.cli."
                            "online_train"] + cli + opts
                           + ["TRAIN.EPOCHS", "1"], "contrastive CLI")
    ckpt = os.path.join(out, "tnet_checkpoints", "3dresnet",
                        "checkpoint.pth.tar")
    saved = torch.load(ckpt, map_location="cpu", weights_only=False)
    check(saved["epoch"] == 1 and set(saved.get("banks", {})) == {"nce"},
          "the checkpoint holds epoch 1 and the nce bank")
    seen = {}
    make_step = steps.make_contrastive_train_step

    def spy(cfg, model, optimizer, schedule, bank, **kw):
        seen.update({k: v.detach().cpu().clone()
                     for k, v in bank.state_dict().items()})
        return make_step(cfg, model, optimizer, schedule, bank, **kw)

    steps.make_contrastive_train_step = spy
    try:
        res_out, res_wall = run_main(
            online_train.main, cli + ["--checkpoint_path", out] + opts
            + ["TRAIN.EPOCHS", "2"], "resumed contrastive CLI")
    finally:
        steps.make_contrastive_train_step = make_step
    want = saved["banks"]["nce"]
    check(seen.keys() == want.keys()
          and all(torch.equal(seen[k], v) for k, v in want.items()),
          "the resumed run starts from the saved banks, byte-equal")
    check("WARNING: restore" not in res_out, "a clean resume")
    logs = os.path.join(out, "tnet_checkpoints")
    with open(os.path.join(logs, "train_loss_and_acc.txt")) as f:
        lines = f.read().splitlines()
    with open(os.path.join(logs, "NMIs.txt")) as f:
        nmis = f.read().split()
    losses = [float(ln.split()[-1]) for ln in lines]
    check(len(lines) == 2 and all(np.isfinite(losses)),
          "two epochs, finite losses")
    check(len(nmis) == 2, "k-means clustered before each epoch")
    rates = [float(m) for m in re.findall(
        r"Train set: Average loss: \S+ \(([\d.]+) clips/s", stdout + res_out)]
    return {"wall_s": wall, "resume_wall_s": res_wall, "train_loss": losses,
            "nmi": nmis,
            "loader_fed_anchors_per_s": rates,
            "banks_restored_byte_equal": True}


def phase_contrastive(paths):
    """LOSS.TYPE contrastive at bench.py:276's shape (R3D-18, 64 anchors of
    16x128x128, K 1024 negatives, 128-d features, 9,537 videos): a timed
    bf16 step for rgb, res, intra-negative and MoCo; one fp32 step held to
    fp64; a learning check; the CLI for an epoch and a resumed second."""
    import torch

    from video_similarity_search_tpu_torch.models import model_selector
    from video_similarity_search_tpu_torch.ops import fused_knn

    fused_knn.LAUNCHES = 0
    torch.manual_seed(SEED)
    init = model_selector(contrastive_cfg("rgb")).state_dict()
    rng = np.random.default_rng(SEED)
    timing = {v: time_contrastive(v, init, rng) for v in NCE_VARIANTS}
    torch.cuda.empty_cache()
    vs64 = contrastive_fp32_vs_fp64(init)
    learn = contrastive_learning(init)
    torch.cuda.empty_cache()
    cli = contrastive_cli(paths)
    launches = fused_knn.LAUNCHES
    check(launches == 0, f"the contrastive path launched nn1_cosine "
          f"{launches} times")
    emit("contrastive", arch="R3D-18", anchors=NCE_ANCHORS, k=NCE_K,
         feat_dim=NCE_FEAT, n_data=NCE_DATA, timing=timing,
         fp32_vs_fp64=vs64, learning=learn, cli=cli,
         nn1_cosine_launches=launches)
    return {k: v["step_ms"] for k, v in timing.items()}


# --------------------------------------------------------------------------
# the classification path (cli/coclr_classify.py): the S3D(-G)
# LinearClassifier at the CLI's defaults, then the CLI itself

CLS_NETS = ("s3d", "s3dg")
CLS_MODES = ("last", "ft", "all")  # --train_what
CLS_T, CLS_S = 32, 128  # the CLI's --seq_len and --img_dim
CLS_BATCH = 32  # --batch_size
CLS_CLASSES = 101  # --num_class
CLS_DROPOUT = 0.9  # --dropout
CLS_LR = CLS_WD = 1e-3  # --lr and --wd
CLS_FEAT = 1024  # S3D's pooled feature
CLS_CPU_CLIPS = 2  # the fp32 step held against the CPU
# checks of (b): fp32, the dtype the CLI runs, against fp64 on the card;
# bf16 against fp32 on the loss, the head's gradient and every backbone
# block's output. bf16's whole gradient is reported, not held to a bar: at
# init it is near orthogonal to fp32's in the JAX package too once XLA
# rounds to bf16 after every op, as autocast does, and there each block
# drifts from fp32 as the port's does (the last block to a cosine of 0.57
# at 4 clips of 8x32x32; tests/test_torch_port_bf16_witness.py). The block
# bar is that run's lowest, rounded down
CLS_FP32_MIN_GRAD_COS = 0.99
CLS_BF16_MIN_HEAD_COS = 0.9
CLS_BF16_MIN_BLOCK_COS = 0.5
S3D_BLOCKS = ("Conv_1a", "Conv_2b", "Conv_2c", "Mixed_3b", "Mixed_3c",
              "Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f",
              "Mixed_5b", "Mixed_5c")
# the CLI's own synthetic set: the manifest keeps videos of 2 x --seq_len
# frames or more, so 64 frames; of each class's 6 videos 4 train, 1
# validates (rewritten in an annotation copy) and 1 is the test video. Each
# class is tinted its colour, a signal the random weights carry (retrieval
# on the test videos finds it). The CLI writes model_best.pth.tar only when
# validation top-1 rises above 0; after the probe's 20 steps final_bn's
# running statistics are still warming up and it predicts nearly one class
# for every video, which, with one validation video a class, scores 1/20.
# Retrieval ranks the test videos among 80 train videos, more than its
# largest k (50)
CLS_SYN = dict(SYN, classes=20, videos_per_class=6, train_frames=64,
               test_frames=64, flow=False, tint=1.0)
CLS_CLI_ARGS = ["--seq_len", str(CLS_T), "--img_dim", str(CLS_S),
                "--num_class", str(CLS_SYN["classes"]), "--batch_size", "8"]


def device_split_ms(fn, reps: int, names) -> dict:
    """Device ms of the kernels launched inside each named
    ``record_function`` range, median over ``reps`` calls of ``fn``:
    torch.profiler over the calls, and each kernel given to the range whose
    host-time span holds the start of the op that launched it (autograd
    runs the backward's ops on its own thread, inside the span of the
    step's backward range). The train steps carry their ranges
    (``train/steps.py::RANGES``), so this splits the real step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.name in names]
    ops = [(e.time_range.start, sum(k.duration for k in e.kernels))
           for e in events if e.kernels]
    per = collections.defaultdict(list)
    for start, end, name in spans:
        per[name].append(sum(d for t, d in ops if start <= t < end) / 1e3)
    check(all(len(per[n]) == reps for n in names), "profiler ranges "
          f"{ {n: len(per[n]) for n in names} } over {reps} calls")
    check(sum(d for _, d in ops) > 0, "the profiler saw device time")
    return {n.split(".")[-1]: float(np.median(per[n])) for n in names}


def classifier(net, train_what, device, dtype="float32", lr=CLS_LR):
    """The CLI's LinearClassifier for ``train_what`` from seed SEED on
    ``device``, its optimizer groups, step schedule and train step, in
    ``dtype`` (the CLI's float32 unless asked). -> (cfg, model, optimizer,
    schedule, step)."""
    import torch

    from video_similarity_search_tpu_torch.config import get_cfg
    from video_similarity_search_tpu_torch.models.heads import LinearClassifier
    from video_similarity_search_tpu_torch.train.state import (
        make_classify_optimizer, make_lr_schedule)
    from video_similarity_search_tpu_torch.train.steps import \
        make_classify_train_step

    cfg = get_cfg()
    cfg.MODEL.ARCH = "s3d"
    cfg.TRAIN.DATASET = "ucf101"
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.DATA.SAMPLE_DURATION, cfg.DATA.SAMPLE_SIZE = CLS_T, CLS_S
    torch.manual_seed(SEED)
    model = LinearClassifier(num_class=CLS_CLASSES, network=net,
                             dropout=CLS_DROPOUT,
                             use_l2_norm=train_what == "last",
                             use_final_bn=train_what == "last")
    # the CLI's default schedule (x0.1 at epochs 60 and 100) stays at lr here
    schedule = make_lr_schedule(lr, 150, [60, 100], False, 100)
    opt, sched = make_classify_optimizer(model, train_what, schedule, CLS_WD)
    step = make_classify_train_step(cfg, model, opt, sched, device=device)
    return cfg, model, opt, sched, step


def classify_batch(rng, b, n_cls=CLS_CLASSES, structured=False):
    labels = rng.integers(0, n_cls, b)
    return {"clips": class_clips(rng, labels, CLS_T, CLS_S, n_cls, structured),
            "label": labels.astype(np.int64)}


def clip_flop(net) -> dict:
    """FLOPs of one CLS_T x CLS_S x CLS_S clip's forward (the port's
    ``utils/flops.py::model_flops_per_clip``) and of the stem's first
    convolution, whose input needs no gradient."""
    import torch

    from video_similarity_search_tpu_torch.utils.flops import \
        model_flops_per_clip

    _, model, _, _, _ = classifier(net, "all", "cuda")
    model.eval()
    flop = model_flops_per_clip(
        model, torch.zeros((1, CLS_T, CLS_S, CLS_S, 3), device="cuda"),
        [model.backbone.Conv_1a.conv1])
    return {"forward": flop["forward"], "stem": flop["first"]}


def bound(ops: float, nbytes: float, dtype: str, peaks) -> dict:
    """The least time of ``ops`` operations at the card's dense peak for
    ``dtype`` (fp32 off the tensor cores, as TF32 is off; bf16 on them) and
    of ``nbytes`` at its memory rate: the larger of the two."""
    fp32_peak, _, bw_peak, bf16_peak = peaks
    ops_ms = ops / (bf16_peak if dtype == "bfloat16" else fp32_peak) * 1e3
    bytes_ms = nbytes / bw_peak * 1e3
    return {"gflop": ops / 1e9, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def classify_vs_cpu(net, host):
    """(a) One fp32 ``--train_what all`` step (TF32 off) on the card against
    the same step on the CPU: the same weights, CLS_CPU_CLIPS clips and
    dropout mask (drawn on the CPU, copied to both). Top-1/top-5 equal the
    CPU's. The logits, the loss, the update and the BatchNorm statistics
    are held to an fp64 run of the step on the card: the card's fp32 must
    be no further from it than 3x the CPU's, as in train_step (a)."""
    import torch

    from video_similarity_search_tpu_torch.data.augment import normalize_only

    b = CLS_CPU_CLIPS
    keep = torch.rand((b, CLS_FEAT), generator=torch.Generator().manual_seed(
        SEED)) < 1 - CLS_DROPOUT
    res = {}
    for name, dev, dtype in (("cpu", "cpu", torch.float32),
                             ("fp64", "cuda", torch.float64),
                             ("cuda", "cuda", torch.float32)):
        _, model, _, _, step = classifier(net, "all", dev)
        model.to(dtype)
        # every run starts from the same seeded weights
        init = {k: v.detach().cpu().double()
                for k, v in model.state_dict().items()}
        logits = []
        hook = model.final_fc[-1].register_forward_hook(
            lambda mod, inp, out: logits.append(out.detach()))
        clips = normalize_only(torch.from_numpy(host["clips"][:b]).to(dev))
        t0 = time.perf_counter()
        met = step({"clips": clips.to(dtype),
                    "label": torch.from_numpy(host["label"][:b]).to(dev)},
                   dropout_keep=keep.to(dev))
        loss = float(met["loss"])
        if dev == "cuda":
            torch.cuda.synchronize()
        res[name] = {"loss": loss, "s": time.perf_counter() - t0,
                     "top": [float(met["top1"]), float(met["top5"])],
                     "logits": logits[0].cpu().double(),
                     "sd": {k: v.detach().cpu().double()
                            for k, v in model.state_dict().items()}}
        hook.remove()
        del model, step
    c, g, ref = res["cpu"], res["cuda"], res["fp64"]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    out = {"clips": b, "loss_cpu": c["loss"], "loss_cuda": g["loss"],
           "loss_fp64_card": ref["loss"],
           "loss_rel_diff": abs(g["loss"] - c["loss"]) / abs(c["loss"]),
           "logits_rel_diff": rel(g["logits"], c["logits"]),
           "logits_rel_err_cuda_vs_fp64": rel(g["logits"], ref["logits"]),
           "logits_rel_err_cpu_vs_fp64": rel(c["logits"], ref["logits"]),
           "top1_top5_cuda": g["top"], "top1_top5_cpu": c["top"],
           "update_rel_err_cuda_vs_fp64": update_rel_err(g["sd"], ref["sd"],
                                                         init),
           "update_rel_err_cpu_vs_fp64": update_rel_err(c["sd"], ref["sd"],
                                                        init),
           "bn_stat_max_abs_diff_cuda_vs_fp64": max_state_diff(
               g["sd"], ref["sd"], True),
           "bn_stat_max_abs_diff_cpu_vs_fp64": max_state_diff(
               c["sd"], ref["sd"], True),
           "cpu_step_s": c["s"], "fp64_card_step_s": ref["s"]}
    check(g["top"] == c["top"], f"{net} fp32 step: top-1/top-5 {g['top']} "
          f"on the card, {c['top']} on the CPU")
    for what, err, err_cpu, floor in (
            ("logits", out["logits_rel_err_cuda_vs_fp64"],
             out["logits_rel_err_cpu_vs_fp64"], 1e-6),
            ("loss", abs(g["loss"] - ref["loss"]) / abs(ref["loss"]),
             abs(c["loss"] - ref["loss"]) / abs(ref["loss"]), 1e-6),
            ("update", out["update_rel_err_cuda_vs_fp64"],
             out["update_rel_err_cpu_vs_fp64"], 1e-5),
            ("BatchNorm statistics",
             out["bn_stat_max_abs_diff_cuda_vs_fp64"][0],
             out["bn_stat_max_abs_diff_cpu_vs_fp64"][0], 1e-6)):
        check(err <= 3 * err_cpu + floor, f"{net} fp32 step {what}: the "
              f"card's within {err} of fp64's, the CPU's within {err_cpu} "
              "(limit: 3x)")
    return out


def classify_precision(net, host):
    """(b) ``--train_what all`` at the full batch in fp32 (TF32 off)
    against fp64 and bf16 on the card: the same weights, clips and dropout
    mask. The step runs at lr 0, which leaves the weights and the gradient
    in ``.grad``. Loss and gradient cosine of fp32 against fp64 and of bf16
    against fp32, for the whole gradient and for the head's (final_fc); and
    the cosine of each backbone block's train-mode output in bf16 against
    fp32."""
    import torch

    from video_similarity_search_tpu_torch.data.augment import normalize_only

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    keep = torch.rand((CLS_BATCH, CLS_FEAT), generator=gen,
                      device="cuda") < 1 - CLS_DROPOUT
    u8 = torch.from_numpy(host["clips"]).cuda()
    labels = torch.from_numpy(host["label"]).cuda()
    res = {}
    for name in ("float32", "bfloat16", "float64"):
        _, model, _, _, step = classifier(
            net, "all", "cuda", lr=0.0,
            dtype="float32" if name == "float64" else name)
        clips = normalize_only(u8)
        if name == "float64":
            model.double()
            clips = clips.double()
        blocks = {}
        hooks = [] if name == "float64" else [
            getattr(model.backbone, b).register_forward_hook(
                lambda mod, inp, out, b=b: blocks.__setitem__(
                    b, out.detach().float()))
            for b in S3D_BLOCKS]
        torch.cuda.reset_peak_memory_stats()
        met = step({"clips": clips, "label": labels}, dropout_keep=keep)
        for h in hooks:
            h.remove()
        grads = {k: p.grad.detach().double().flatten()
                 for k, p in model.named_parameters()}
        res[name] = {"loss": float(met["loss"]),
                     "head": grads["final_fc.1.weight"],
                     "grad": torch.cat(list(grads.values())),
                     "blocks": blocks,
                     "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        del model, step, grads, clips
        torch.cuda.empty_cache()

    def cos(a, b):
        return float(torch.nn.functional.cosine_similarity(
            a.flatten().double(), b.flatten().double(), dim=0))

    out = {}
    for pair, (lo, hi) in (("fp32_vs_fp64", ("float32", "float64")),
                           ("bf16_vs_fp32", ("bfloat16", "float32"))):
        a, b = res[lo], res[hi]
        out[pair] = {"loss": [a["loss"], b["loss"]],
                     "loss_rel_diff": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
                     "grad_cosine": cos(a["grad"], b["grad"]),
                     "head_grad_cosine": cos(a["head"], b["head"]),
                     "grad_norm": [float(a["grad"].norm()),
                                   float(b["grad"].norm())]}
    blocks = {b: cos(res["bfloat16"]["blocks"][b], res["float32"]["blocks"][b])
              for b in S3D_BLOCKS}
    out["bf16_vs_fp32"]["block_cosine"] = blocks
    out["peak_mem_gib"] = {k: v["peak_mem_gib"] for k, v in res.items()}
    del res
    torch.cuda.empty_cache()
    hi, lo = out["fp32_vs_fp64"], out["bf16_vs_fp32"]
    check(hi["loss_rel_diff"] <= 1e-4 and hi["grad_cosine"]
          >= CLS_FP32_MIN_GRAD_COS, f"{net} fp32 vs fp64: loss within 1e-4 "
          f"({hi['loss_rel_diff']}), gradient cosine {hi['grad_cosine']} >= "
          f"{CLS_FP32_MIN_GRAD_COS}")
    check(lo["loss_rel_diff"] <= BF16_MAX_LOSS_REL and lo["head_grad_cosine"]
          >= CLS_BF16_MIN_HEAD_COS, f"{net} bf16 vs fp32: loss within "
          f"{BF16_MAX_LOSS_REL} ({lo['loss_rel_diff']}), head gradient cosine "
          f"{lo['head_grad_cosine']} >= {CLS_BF16_MIN_HEAD_COS}")
    check(min(blocks.values()) >= CLS_BF16_MIN_BLOCK_COS, f"{net} bf16 vs "
          f"fp32: every block's output cosine >= {CLS_BF16_MIN_BLOCK_COS} "
          f"({blocks})")
    return out


def time_classify(net, train_what, host, dtype="float32"):
    """(c) Median ms of the step after two warm-up steps on the host clock
    (normalize + step, as the CLI runs it), clips/s and peak GiB; the stem
    weight gradient kernel's launches in the timed steps; and the device
    ms of its parts (``device_split_ms`` over the real step: normalize,
    forward + loss, backward, optimizer)."""
    import torch
    from torch.profiler import record_function

    from video_similarity_search_tpu_torch.data.augment import normalize_only
    from video_similarity_search_tpu_torch.ops import stem_wgrad
    from video_similarity_search_tpu_torch.train.steps import RANGES

    _, model, _, _, step = classifier(net, train_what, "cuda", dtype=dtype)
    u8 = torch.from_numpy(host["clips"]).cuda()
    labels = torch.from_numpy(host["label"]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def one():
        with record_function("normalize"):
            clips = normalize_only(u8)
        return step({"clips": clips, "label": labels}, generator=gen)

    for _ in range(2):
        one()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    whole = []
    stem_wgrad.LAUNCHES = 0
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        whole.append((time.perf_counter() - t0) * 1e3)
    launches = stem_wgrad.LAUNCHES
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    split = device_split_ms(one, TIMED_STEPS, ("normalize",) + RANGES)
    ms = float(np.median(whole))
    params = [p.numel() for p in model.parameters()]
    trained = sum(p.numel() for p in model.parameters() if p.requires_grad)
    return {"train_what": train_what, "dtype": dtype, "step_ms": ms,
            "step_ms_all": whole, "clips_per_s": CLS_BATCH / (ms / 1e3),
            "peak_mem_gib": peak, "trained_params": trained,
            "frozen_params": sum(params) - trained, "device_split_ms": split,
            "stem_wgrad_launches": launches}


def time_eval(net, host, rng):
    """(c) The eval forward (``make_embed_step``, fp32 as in the CLI) over
    the batch: ms and clips/s; and ``test_10crop`` over one batch of
    CLS_BATCH clips decoded at int(1.14 * img_dim), as the CLI's test
    loader gives them: ms (the host-to-card copy and the softmax read back
    included) and peak GiB."""
    import torch

    from video_similarity_search_tpu_torch.data.augment import normalize_only
    from video_similarity_search_tpu_torch.evaluation.classify import \
        test_10crop
    from video_similarity_search_tpu_torch.train.steps import make_embed_step

    cfg, model, _, _, _ = classifier(net, "last", "cuda")
    embed = make_embed_step(cfg, model, device="cuda")
    x = normalize_only(torch.from_numpy(host["clips"]).cuda())
    eval_ms = time_ms(lambda: embed(x))
    buf = int(1.14 * CLS_S)
    batch = {"clip": rng.integers(0, 256, (CLS_BATCH, CLS_T, buf, buf, 3),
                                  np.uint8),
             "target": host["label"], "index": np.arange(CLS_BATCH),
             "window_counts": np.ones(CLS_BATCH, np.int32)}
    del x
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ten_ms = time_ms(lambda: test_10crop(model, cfg, [batch], device="cuda",
                                         is_master_proc=False), reps=3)
    return {"eval_ms": eval_ms, "eval_clips_per_s": CLS_BATCH / (eval_ms / 1e3),
            "ten_crop_batch_ms": ten_ms, "ten_crop_buffer": buf,
            "ten_crop_peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def classify_learning(rng):
    """(d) LEARN_STEPS fp32 ``--train_what all`` steps of S3D on one fixed
    batch of class-coloured clips (8 of the 101 classes) lower the
    cross-entropy."""
    import torch

    from video_similarity_search_tpu_torch.data.augment import normalize_only

    host = classify_batch(rng, CLS_BATCH, n_cls=8, structured=True)
    _, _, _, _, step = classifier("s3d", "all", "cuda")
    batch = {"clips": normalize_only(torch.from_numpy(host["clips"]).cuda()),
             "label": torch.from_numpy(host["label"]).cuda()}
    gen = torch.Generator(device="cuda")
    losses = []
    for i in range(LEARN_STEPS):
        gen.manual_seed(SEED + 1 + i)
        losses.append(step(batch, generator=gen)["loss"])
    losses = [float(v) for v in losses]
    ratio = float(np.mean(losses[-5:])) / losses[0]
    check(all(np.isfinite(losses)), "classify learning check: finite losses")
    check(ratio <= LEARN_MAX_RATIO, f"classify learning check: the last 5 "
          f"steps' mean cross-entropy is {ratio:.3f} of the first's (<= "
          f"{LEARN_MAX_RATIO})")
    return {"net": "s3d", "train_what": "all", "dtype": "float32",
            "steps": LEARN_STEPS, "first": losses[0],
            "last5_mean": float(np.mean(losses[-5:])), "ratio": ratio,
            "losses": losses}


def phase_classify_step(smi: str):
    """The classifier step at the CLI's defaults: LinearClassifier for s3d
    and s3dg from seed 0, CLS_BATCH clips of 32x128x128x3 from seed 0,
    101 classes, dropout 0.9, lr and wd 1e-3, float32 as the CLI runs it
    (bf16 ``all`` timed beside it). Each timing carries its bound: the
    convolutions' and linear layers' operations (``clip_flop``; a frozen
    backbone runs no backward, and the stem no input gradient) and the
    bytes of the clips, the weights and the momentum."""
    import torch

    from video_similarity_search_tpu_torch.utils.flops import peaks_for

    _, peaks = peaks_for(smi)
    rng = np.random.default_rng(SEED)
    host = classify_batch(rng, CLS_BATCH)
    clip_bytes = host["clips"].nbytes
    nets, launches = {}, {}
    for net in CLS_NETS:
        flop = clip_flop(net)
        row = {"forward_gflop_per_clip": flop["forward"] / 1e9,
               "fp32_card_vs_cpu": classify_vs_cpu(net, host)}
        torch.cuda.empty_cache()
        row["precision"] = classify_precision(net, host)
        row["timing"] = [time_classify(net, m, host) for m in CLS_MODES]
        row["timing"].append(time_classify(net, "all", host, "bfloat16"))
        # the float32 stem trains in ft and all: one launch a step; last
        # freezes it, and bf16 keeps cuDNN
        launches[net] = {f"{t['train_what']} {t['dtype']}":
                         t["stem_wgrad_launches"] for t in row["timing"]}
        check(list(launches[net].values()) == [0, TIMED_STEPS, TIMED_STEPS,
                                               0], f"{net}: the stem weight "
              "gradient kernel launches once a float32 ft or all step, never "
              f"in last or bf16 ({launches[net]})")
        for t in row["timing"]:
            per_clip = (flop["forward"] if t["train_what"] == "last"
                        else 3 * flop["forward"] - flop["stem"])
            nbytes = (clip_bytes + 4 * 4 * t["trained_params"]
                      + 4 * t["frozen_params"])
            t.update(bound(CLS_BATCH * per_clip, nbytes, t["dtype"], peaks))
        torch.cuda.empty_cache()
        row["eval"] = time_eval(net, host, rng)
        row["eval"].update(bound(CLS_BATCH * flop["forward"], clip_bytes,
                                 "float32", peaks))
        torch.cuda.empty_cache()
        nets[net] = row
    learn = classify_learning(rng)
    emit("classify_step", clip=[CLS_T, CLS_S, CLS_S, 3], batch=CLS_BATCH,
         classes=CLS_CLASSES, dropout=CLS_DROPOUT, lr=CLS_LR, wd=CLS_WD,
         dtype="float32", device=smi, nets=nets, learning=learn)
    return {t["train_what"]: t["clips_per_s"] for t in nets["s3d"]["timing"]
            if t["dtype"] == "float32"}, launches


def run_main(main, argv, what: str):
    """A CLI's ``main(argv)`` in this process, its standard output captured:
    the entry point the module runs, on this process's warm CUDA context.
    -> (stdout, wall seconds)."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            main(argv)
    except Exception as e:
        raise RuntimeError(f"{what}: {e!r}; stdout: "
                           f"{buf.getvalue()[-2000:]}") from e
    return buf.getvalue(), time.perf_counter() - t0


def phase_classify_cli(step_clips_per_s: dict):
    """The classification CLI on its own synthetic set (CLS_SYN, 20
    classes): ``--train_what last`` for 2 epochs as ``python -m
    video_similarity_search_tpu_torch.cli.coclr_classify`` in a process of
    its own; then, through the same entry function in this process (no
    second CUDA start-up), ``ft`` for 1 epoch from the probe's
    ``model_best.pth.tar`` (``--pretrain``), the ten-crop test and
    ``--retrieval`` on that checkpoint. The printed lines and the files are
    checked, and the loader-fed clips/s of each epoch reported beside
    classify_step's."""
    from video_similarity_search_tpu_torch.cli import coclr_classify

    root = os.path.join(OUT, "ucf_classify")
    jpg, ann, _, gen_s = make_ucf_dataset(root, CLS_SYN)
    work = os.path.join(OUT, "classify_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    with open(ann) as f:
        spec = json.load(f)
    val_tag = f"_g{CLS_SYN['videos_per_class'] - 2:02d}_c01"
    for vid, v in spec["database"].items():
        if vid.endswith(val_tag):
            v["subset"] = "validation"
    ann_cls = os.path.join(work, "annotation.json")
    with open(ann_cls, "w") as f:
        json.dump(spec, f)
    module = "video_similarity_search_tpu_torch.cli.coclr_classify"
    argv = ["--vid_path", jpg, "--annotation_path", ann_cls, "--device",
            "cuda"] + CLS_CLI_ARGS
    n_cls = CLS_SYN["classes"]
    n_train = n_cls * (CLS_SYN["videos_per_class"] - 2)
    epoch_re = re.compile(r"epoch (\d+): lr \S+ loss (\S+) top1 (\S+) "
                          r"\(([\d.]+) clips/s\)")
    best = os.path.join(work, "last", "tnet_checkpoints", "s3d",
                        "model_best.pth.tar")
    runs, walls = {}, {}
    for mode, epochs, extra in (("last", 2, []),
                                ("ft", 1, ["--pretrain", best])):
        out = os.path.join(work, mode)
        args = argv + ["--train_what", mode, "--epochs", str(epochs),
                       "--output", out] + extra
        what = f"classify CLI --train_what {mode}"
        stdout, walls[mode] = (
            run_cli([sys.executable, "-m", module] + args, what)
            if mode == "last" else run_main(coclr_classify.main, args, what))
        rows = epoch_re.findall(stdout)
        val = [float(v) for v in re.findall(r"val top1 (\S+)", stdout)]
        check(len(rows) == epochs and len(val) == epochs,
              f"{mode}: {epochs} epoch and val lines ({rows}, {val})")
        check(all(np.isfinite(float(r[1])) for r in rows),
              f"{mode}: finite losses")
        with open(os.path.join(out, "metrics", "scalars.csv")) as f:
            scalars = f.read()
        for tag in ("train/lr", "train/loss", "train/top1", "train/top5",
                    "val/top1"):
            check(f",{tag}," in scalars, f"{mode}: {tag} in scalars.csv")
        mode_best = os.path.join(out, "tnet_checkpoints", "s3d",
                                 "model_best.pth.tar")
        runs[mode] = {"epochs": epochs, "loss": [float(r[1]) for r in rows],
                      "top1": [float(r[2]) for r in rows], "val_top1": val,
                      "loader_fed_clips_per_s": [float(r[3]) for r in rows],
                      "model_best_written": os.path.exists(mode_best)}
        if mode == "last":
            check(os.path.exists(best), "last: model_best.pth.tar written "
                  "(validation top-1 rose above 0)")
        else:
            m = re.search(r"partial load: matched (\d+) tensors, kept (\d+) "
                          r"at init", stdout)
            check(m is not None and int(m.group(2)) == 0, "ft: the probe's "
                  f"checkpoint loaded with nothing kept at init ({m})")
            runs[mode]["pretrain_matched"] = int(m.group(1))
    test = argv + ["--train_what", "last", "--checkpoint_path", best]
    t_out, walls["ten_crop"] = run_main(
        coclr_classify.main, test + ["--output", os.path.join(work, "test")],
        "ten-crop test")
    m = re.search(r"10-crop test: top1 (\S+) top5 (\S+) \((\d+) videos\)",
                  t_out)
    check("resume: epoch" in t_out and m is not None
          and int(m.group(3)) == n_cls
          and 0 <= float(m.group(1)) <= float(m.group(2)) <= 1,
          f"ten-crop test line over {n_cls} videos ({m})")
    r_out, walls["retrieval"] = run_main(
        coclr_classify.main,
        test + ["--retrieval", "--output", os.path.join(work, "retrieval")],
        "retrieval")
    line = [ln for ln in r_out.splitlines() if ln.startswith("retrieval:")]
    check(len(line) == 1 and all(f"{k}:" in line[0]
                                 for k in (1, 5, 10, 20, 50)),
          f"retrieval line with top 1/5/10/20/50 ({line})")
    emit("classify_cli", command=f"-m {module} ...", args=CLS_CLI_ARGS,
         in_process=["ft", "ten_crop", "retrieval"],
         dataset={**CLS_SYN, "train_videos": n_train, "val_videos": n_cls,
                  "test_videos": n_cls},
         dataset_write_s=gen_s, runs=runs, wall_s=walls,
         ten_crop={"top1": float(m.group(1)), "top5": float(m.group(2))},
         retrieval=line[0], classify_step_clips_per_s=step_clips_per_s)


# --------------------------------------------------------------------------
# the eighth slice: CoCLR's LMDB classification path with the CoCLR clip
# transforms, and IIC clip retrieval

# the LMDB store: ClassInd.txt lists UCF-101's 101 classes; videos in the
# first LMDB_USED, each class tinted its colour (a signal the probe can
# learn in two steps). 4 train videos a class are 2 batches of 32; of the
# 2 test videos a class, validation keeps pandas' 30% (10 videos). The
# probe steps at lr 0.1 (the CLI's --lr; its default 1e-3 moves no
# prediction in two steps), so validation top-1 rises above 0 and the CLI
# writes model_best.pth.tar
LMDB_USED = 16
# 192 training videos: 6 batches of 32, so an epoch's clips/s (its first
# step left out) spans 5 steps
LMDB_TRAIN_PER_CLASS, LMDB_TEST_PER_CLASS = 12, 2
LMDB_FRAMES = (48, 64)  # each video's length is drawn in [48, 64]
LMDB_HW = (240, 320)
LMDB_CLI_LR = 0.1
LMDB_CPU_CLIPS = 2  # the transforms held against the CPU on these clips
COCLR_OUT = 112  # the controllers' crop from the 128 x 128 clips


def _jpeg_frames(job) -> list:
    """One synthetic video as JPEG bytes (``_write_video``'s drifting
    class-coloured pattern, tinted)."""
    import io

    from PIL import Image

    n, (h, w), color, freq, phase, speed = job
    yy, xx = np.mgrid[0:h, 0:w + speed * n].astype(np.float32)
    wave = np.sin(xx * freq + phase) + 0.5 * np.cos(yy * freq * 1.7 + phase)
    canvas = np.clip(128 + 80 * wave[..., None] * color
                     + 150 * (color - 0.6), 0, 255).astype(np.uint8)
    out = []
    for f in range(n):
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(
            canvas[:, speed * f:speed * f + w])).save(buf, format="JPEG")
        out.append(buf.getvalue())
    return out


def make_lmdb_store(root: str):
    """A seeded CoCLR store under ``root``: ClassInd.txt, train_split01.csv
    and test_split01.csv (tests/test_lmdb.py's layout: vpath, vlen) and
    ucf101_frame.lmdb, each video a msgpack array of 320x240 JPEGs, written
    with the port's ``write_lmdb``. Reused when ``root`` holds the same
    store. -> (root, db path, seconds spent writing)."""
    import msgpack

    from video_similarity_search_tpu_torch.data.lmdb_lite import write_lmdb

    db = os.path.join(root, "ucf101_frame.lmdb")
    marker = os.path.join(root, "done.json")
    spec = json.dumps([LMDB_USED, LMDB_TRAIN_PER_CLASS, LMDB_TEST_PER_CLASS,
                       LMDB_FRAMES, LMDB_HW, SEED])
    if os.path.exists(marker):
        with open(marker) as f:
            if f.read() == spec:
                return root, db, 0.0
    t0 = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rng = np.random.default_rng(SEED)
    classes = [f"class{c:03d}" for c in range(CLS_CLASSES)]
    with open(os.path.join(root, "ClassInd.txt"), "w") as f:
        f.write("\n".join(f"{i + 1},{c}" for i, c in enumerate(classes)))
    names, jobs, rows = [], [], {"train": [], "test": []}
    for c in classes[:LMDB_USED]:
        color = rng.uniform(0.2, 1.0, 3).astype(np.float32)
        freq = float(rng.uniform(0.01, 0.05))
        for v in range(LMDB_TRAIN_PER_CLASS + LMDB_TEST_PER_CLASS):
            split = "train" if v < LMDB_TRAIN_PER_CLASS else "test"
            n = int(rng.integers(LMDB_FRAMES[0], LMDB_FRAMES[1] + 1))
            names.append(f"{c}/v_{c}_g{v:02d}_c01")
            jobs.append((n, LMDB_HW, color, freq,
                         float(rng.uniform(0, 6.28)),
                         int(rng.integers(1, 5))))
            rows[split].append(f"/data/{names[-1]}/frames,{n}")
    for split, lines in rows.items():
        with open(os.path.join(root, f"{split}_split01.csv"), "w") as f:
            f.write("\n".join(lines))
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        videos = list(pool.map(_jpeg_frames, jobs))
    mapping = {b"__len__": msgpack.packb(len(names)),
               b"__keys__": msgpack.packb(
                   [f"{i:09d}".encode() for i in range(len(names))]),
               b"__order__": msgpack.packb([n.encode() for n in names])}
    for i, frames in enumerate(videos):
        mapping[f"{i:09d}".encode()] = msgpack.packb(frames)
    write_lmdb(db, mapping)
    with open(marker, "w") as f:
        f.write(spec)
    return root, db, time.perf_counter() - t0


def lmdb_items_direct(root: str, db: str) -> dict:
    """One item of each mode (train, val, test) of the port's UCF101LMDB
    and the train adapter's resized item, each byte-equal to the same
    frames read straight from the file: the key from ``__order__``, the
    value unframed by msgpack, the JPEGs decoded by PIL, the frame indices
    drawn from a fresh generator of the dataset's seed."""
    import io

    import msgpack
    from PIL import Image

    from video_similarity_search_tpu_torch.data import lmdb_data
    from video_similarity_search_tpu_torch.data.lmdb_lite import LiteEnv

    out = {}
    with LiteEnv(db) as env:
        order = msgpack.unpackb(env.get(b"__order__"))
        for mode in ("train", "val", "test"):
            ds = lmdb_data.get_lmdb_dataset("ucf101", root, db, mode=mode,
                                            num_frames=CLS_T, seed=SEED)
            row = ds.video_subset[0]
            item = ds[0]
            idx = lmdb_data.frame_sampler(row["vlen"], CLS_T, 1, mode,
                                          rng=np.random.default_rng(SEED))
            raw = msgpack.unpackb(env.get(
                f"{order.index(row['vname'].encode()):09d}".encode()))
            frames = [Image.open(io.BytesIO(raw[int(i)])).convert("RGB")
                      for i in idx]
            direct = np.stack([np.asarray(f) for f in frames])
            check(item["clips"].shape == (len(idx),) + LMDB_HW + (3,)
                  and np.array_equal(item["clips"], direct)
                  and item["label"] == ds.class_to_idx[row["vlabel"]],
                  f"LMDB {mode} item byte-equal to a direct read")
            out[mode] = {"videos": len(ds), "frames": len(idx)}
            if mode == "train":
                ds.rng = np.random.default_rng(SEED)
                buf = 2 * CLS_S
                got = lmdb_data.LMDBClipAdapter(ds, buf, CLS_T)[0]["clip"]
                want = np.stack([np.asarray(f.resize((buf, buf)))
                                 for f in frames])
                check(np.array_equal(got, want), "LMDB train adapter item "
                      "byte-equal to a direct PIL resize")
    return out


def coclr_transforms(host_clips: np.ndarray) -> list:
    """Each CoCLR transform on the card at CLS_BATCH clips of
    CLS_T x CLS_S x CLS_S (uint8, or float in [0, 1] for the rotation):
    ms (median of 5, CUDA events), and the first LMDB_CPU_CLIPS clips held
    to the CPU from the same draws, made on the card and injected."""
    import torch

    from video_similarity_search_tpu_torch.data import augment as ta

    x = torch.from_numpy(host_clips).cuda()
    x2 = torch.roll(x, 1, dims=0)
    xf = x.float() / 255
    b, t, n = x.shape[0], x.shape[1], LMDB_CPU_CLIPS
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def u(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    def params():
        return ta.draw_augment_params(gen, b, pre_cropped=False,
                                      in_hw=(CLS_S, CLS_S))

    def head(v):  # the first n clips' draws (or inputs), on the CPU
        if isinstance(v, dict):
            return {k: head(w) for k, w in v.items()}
        if isinstance(v, (tuple, list)):
            return type(v)(head(w) for w in v)
        return v[:n].cpu() if torch.is_tensor(v) else v

    blocks = -(-t // 4)
    p1, p2, p3, p4 = params(), params(), params(), params()
    cases = [  # name, fn, its card arguments, tolerance (max abs)
        ("pad_clip", lambda c: ta.pad_clip(c, 8), (x,), 0.0),
        ("scale_clip uint8 to 112", lambda c: ta.scale_clip(c, 112), (x,),
         1.0),
        ("scale_clip float to 160", lambda c: ta.scale_clip(c, 160),
         (x.float(),), 1e-3),
        ("random_gray_clip per clip", lambda c, a, k: ta.random_gray_clip(
            c, 0.5, True, 0, apply=a, channel=k),
         (x, u(b) < 0.5, (u(b) * 3).long()), 0.0),
        ("random_gray_clip per frame", lambda c, a, k: ta.random_gray_clip(
            c, 0.5, False, 0, apply=a.reshape(-1), channel=k.reshape(-1)),
         (x, u(b, t) < 0.5, (u(b, t) * 3).long()), 0.0),
        ("random_gray_clip per 4 frames",
         lambda c, a, k: ta.random_gray_clip(
             c, 0.5, True, 4, apply=a.reshape(-1), channel=k.reshape(-1)),
         (x, u(b, blocks) < 0.5, (u(b, blocks) * 3).long()), 0.0),
        ("center_crop_normalize",
         lambda c: ta.center_crop_normalize(c, COCLR_OUT), (x,), 1e-6),
        ("rotate_clip", lambda c, a, d: ta.rotate_clip(c, 15.0, angles=a,
                                                        apply=d),
         (xf, 30 * u(b) - 15, u(b) < 0.9), 1e-5),
        ("two_clip_transform", lambda c, c2, pa, pb, ua, ub:
         ta.two_clip_transform(c, c2, COCLR_OUT, p=0.5, params=(pa, pb),
                               use_base=(ua, ub)),
         (x, x2, p1, p2, u(b) < 0.5, u(b) < 0.5), 1e-4),
        ("one_clip_transform", lambda c, c2, pk, bf, pa:
         ta.one_clip_transform(c, c2, COCLR_OUT, pick1=pk, base_first=bf,
                               params=pa),
         (x, x2, u(b) < 0.5, u(b) < 0.5, p3), 1e-4),
        ("two_crops_transform", lambda c, pa, pb: ta.two_crops_transform(
            c, COCLR_OUT, params=(pa, pb)), (x, p1, p4), 1e-4),
        ("transform_controller", lambda c, pa, pb, ch:
         ta.transform_controller(
             [lambda: ta.two_crops_transform(c, COCLR_OUT, params=(pa, pb)),
              lambda: ta.center_crop_normalize(c, COCLR_OUT)],
             [0.5, 0.5], choice=ch),
         (x, p1, p4, int(u(1).item() < 0.5)), 1e-4),
    ]
    out = []
    for name, fn, args, tol in cases:
        card = fn(*args)
        cpu = fn(*(head(a) for a in args))
        card, cpu = ((card,), (cpu,)) if torch.is_tensor(card) else (card,
                                                                    cpu)
        err = max(float((g[:n].cpu().double() - w.double()).abs().max())
                  for g, w in zip(card, cpu))
        check(err <= tol and all(g.shape[0] == b for g in card)
              and all(bool(torch.isfinite(g.float()).all()) for g in card),
              f"{name}: the card within {tol} of the CPU ({err})")
        out.append({"name": name, "ms": time_ms(lambda: fn(*args)),
                    "max_abs_err_vs_cpu": err, "tolerance": tol,
                    "out_shape": list(card[0].shape)})
    return out


def lmdb_loader_alone(root: str, yaml: str) -> dict:
    """The CLI's training loader alone, no step: its config (the YAML, then
    --seq_len / --img_dim), its 2x buffer and its pinned upload, one epoch.
    The clips/s runs from the first batch's arrival to the last batch's
    upload, so it spans every batch but the first."""
    import torch

    from video_similarity_search_tpu_torch.config import get_cfg
    from video_similarity_search_tpu_torch.data.lmdb_data import \
        build_lmdb_loader

    cfg = get_cfg()
    cfg.merge_from_file(yaml)
    cfg.DATA.SAMPLE_DURATION, cfg.DATA.SAMPLE_SIZE = CLS_T, CLS_S
    loader, _ = build_lmdb_loader("ucf101", root, "train", cfg, CLS_BATCH,
                                  device="cuda")
    t0, clips, batches = None, 0, 0
    for batch in loader:
        batches += 1
        if t0 is None:
            t0 = time.perf_counter()
            continue
        clips += len(batch["target"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return {"batches": batches, "clips_timed": clips, "seconds": dt,
            "clips_per_s": clips / dt,
            "consumer_wait_s": [float(w) for w in loader.wait_s]}


def phase_lmdb(step_clips_per_s: dict):
    """CoCLR's classification CLI on an LMDB store at its defaults (S3D,
    32 clips of 32x128x128, 101 classes, float32): the store made with the
    port's writer; one item of each mode held to a direct read; the CLI's
    training loader timed alone; then ``coclr_classify.main`` in this
    process, the entry point of ``python -m ...coclr_classify``: ``--lmdb_root
    ... --train_what last`` for an epoch (the 2x buffer cropped on the card
    by ``train_augment``, the batches uploaded through the pinned ring), the
    ten-crop test and ``--retrieval`` on its model_best.pth.tar (the
    epoch's weights where validation scored 0 and it kept none), each run's
    nn1_cosine launches counted from 0 just before it (all 0); the
    loader-fed clips/s beside classify_step's; each CoCLR transform timed
    and held to the CPU. -> each run's launches."""
    from video_similarity_search_tpu_torch.cli import coclr_classify
    from video_similarity_search_tpu_torch.ops import fused_knn

    root, db, write_s = make_lmdb_store(os.path.join(OUT, "lmdb_store"))
    items = lmdb_items_direct(root, db)
    work = os.path.join(OUT, "lmdb_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    yaml = os.path.join(work, "loader.yaml")
    with open(yaml, "w") as f:
        f.write(f"TRAIN:\n  NUM_DATA_WORKERS: {os.cpu_count()}\n"
                "TPU:\n  PREFETCH_DEVICE_PUT: True\n")
    loader = lmdb_loader_alone(root, yaml)
    argv = ["--lmdb_root", root, "--cfg", yaml, "--device", "cuda",
            "--seq_len", str(CLS_T), "--img_dim", str(CLS_S),
            "--num_class", str(CLS_CLASSES), "--batch_size", str(CLS_BATCH),
            "--train_what", "last", "--lr", str(LMDB_CLI_LR)]
    launches, walls, returned = {}, {}, {}

    def cli(a):
        returned["main"] = coclr_classify.main(a)

    def counted(what, extra):
        fused_knn.LAUNCHES = 0
        stdout, walls[what] = run_main(cli, argv + extra, f"LMDB {what}")
        launches[what] = fused_knn.LAUNCHES
        return stdout

    out = os.path.join(work, "last")
    stdout = counted("train", ["--epochs", "1", "--output", out])
    model = returned["main"][0]  # the trained (model, optimizer)
    rows = re.findall(r"epoch 0: lr \S+ loss (\S+) top1 (\S+) "
                      r"\(([\d.]+) clips/s\)", stdout)
    val = re.findall(r"val top1 (\S+)", stdout)
    check(len(rows) == 1 and len(val) == 1 and np.isfinite(float(rows[0][0])),
          f"LMDB CLI: one epoch line and one validation ({stdout[-500:]})")
    # the CLI writes model_best.pth.tar only when validation beats 0, as
    # the JAX CLI does; after one epoch the eval-mode BatchNorm's running
    # statistics are still mostly at init, so the probe may score 0
    best = os.path.join(out, "tnet_checkpoints", "s3d", "model_best.pth.tar")
    check(os.path.exists(best) == (float(val[0]) > 0), "LMDB CLI: "
          f"model_best.pth.tar written iff val top1 > 0 (val top1 {val})")
    if not os.path.exists(best):  # the epoch's weights, as a checkpoint
        import torch

        best = os.path.join(work, "epoch_weights.pth.tar")
        torch.save({"state_dict": {k: v.detach().cpu() for k, v in
                                   model.state_dict().items()},
                    "epoch": 1}, best)
    n_val = items["val"]["videos"]
    t_out = counted("ten_crop", ["--checkpoint_path", best, "--output",
                                 os.path.join(work, "test")])
    m = re.search(r"10-crop test: top1 (\S+) top5 (\S+) \((\d+) videos\)",
                  t_out)
    check(m is not None and int(m.group(3)) == n_val
          and 0 <= float(m.group(1)) <= float(m.group(2)) <= 1,
          f"LMDB ten-crop test over {n_val} videos ({m})")
    r_out = counted("retrieval", ["--checkpoint_path", best, "--retrieval",
                                  "--output", os.path.join(work, "ret")])
    line = [ln for ln in r_out.splitlines() if ln.startswith("retrieval:")]
    check(len(line) == 1 and all(f"{k}:" in line[0]
                                 for k in (1, 5, 10, 20, 50)),
          f"LMDB retrieval line with top 1/5/10/20/50 ({line})")
    check(all(n == 0 for n in launches.values()),
          f"the LMDB path launched nn1_cosine {launches} times")
    rng = np.random.default_rng(SEED)
    transforms = coclr_transforms(rng.integers(
        0, 256, (CLS_BATCH, CLS_T, CLS_S, CLS_S, 3), np.uint8))
    emit("lmdb", command="coclr_classify.main(['--lmdb_root', ...])",
         args=argv[2:], store={
             "classes_listed": CLS_CLASSES, "classes_with_videos": LMDB_USED,
             "frames": list(LMDB_FRAMES), "frame_hw": list(LMDB_HW),
             "write_s": write_s, "bytes": os.path.getsize(db),
             "modes": items},
         loader_alone=loader,
         train={"loss": float(rows[0][0]), "top1": float(rows[0][1]),
                "val_top1": float(val[0]),
                "loader_fed_clips_per_s": float(rows[0][2]),
                "steps_timed": items["train"]["videos"] // CLS_BATCH - 1},
         classify_step_fp32_last_clips_per_s=step_clips_per_s.get("last"),
         ten_crop={"top1": float(m.group(1)), "top5": float(m.group(2)),
                   "videos": n_val, "checkpoint": os.path.basename(best)},
         retrieval=line[0], wall_s=walls, transforms=transforms,
         nn1_cosine_launches=launches)
    return launches


IIC_CLASSES = 10
IIC_TRAIN_PER_CLASS, IIC_TEST_PER_CLASS = 3, 1
IIC_FRAMES = (48, 80)  # each video's length is drawn in [48, 80]
IIC_SAMPLE_NUM = 10  # clips a video (the CLI's --sample_num)


def _write_avi(job) -> None:
    """One synthetic MJPG .avi (``_jpeg_frames``' pattern, BGR)."""
    import cv2

    path, n, (h, w), color, freq, phase, speed = job
    yy, xx = np.mgrid[0:h, 0:w + speed * n].astype(np.float32)
    wave = np.sin(xx * freq + phase) + 0.5 * np.cos(yy * freq * 1.7 + phase)
    canvas = np.clip(128 + 80 * wave[..., None] * color
                     + 150 * (color - 0.6), 0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 25.0,
                             (w, h))
    for f in range(n):
        writer.write(np.ascontiguousarray(
            canvas[:, speed * f:speed * f + w, ::-1]))
    writer.release()


def make_iic_videos(root: str):
    """Seeded MJPG videos at 320x240 in the UCF layout of the IIC datasets
    (split/classInd.txt, split/trainlist01.txt, split/testlist01.txt,
    videos/<class>/<video>.avi), reused when ``root`` holds the same set.
    -> (root, seconds spent writing)."""
    marker = os.path.join(root, "done.json")
    spec = json.dumps([IIC_CLASSES, IIC_TRAIN_PER_CLASS, IIC_TEST_PER_CLASS,
                       IIC_FRAMES, LMDB_HW, SEED])
    if os.path.exists(marker):
        with open(marker) as f:
            if f.read() == spec:
                return root, 0.0
    t0 = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, "split"))
    rng = np.random.default_rng(SEED + 1)
    classes = [f"Class{c:02d}" for c in range(IIC_CLASSES)]
    lists, jobs = {"train": [], "test": []}, []
    for c in classes:
        color = rng.uniform(0.2, 1.0, 3).astype(np.float32)
        freq = float(rng.uniform(0.01, 0.05))
        for v in range(IIC_TRAIN_PER_CLASS + IIC_TEST_PER_CLASS):
            rel = f"{c}/v_{c}_g{v:02d}_c01.avi"
            split = "train" if v < IIC_TRAIN_PER_CLASS else "test"
            lists[split].append(rel)
            jobs.append((os.path.join(root, "videos", rel),
                         int(rng.integers(IIC_FRAMES[0], IIC_FRAMES[1] + 1)),
                         LMDB_HW, color, freq, float(rng.uniform(0, 6.28)),
                         int(rng.integers(1, 5))))
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        list(pool.map(_write_avi, jobs))
    with open(os.path.join(root, "split", "classInd.txt"), "w") as f:
        f.write("\n".join(f"{i + 1} {c}" for i, c in enumerate(classes)))
    with open(os.path.join(root, "split", "trainlist01.txt"), "w") as f:
        f.write("\n".join(f"{r} {classes.index(r.split('/')[0]) + 1}"
                          for r in lists["train"]))
    with open(os.path.join(root, "split", "testlist01.txt"), "w") as f:
        f.write("\n".join(lists["test"]))
    with open(marker, "w") as f:
        f.write(spec)
    return root, time.perf_counter() - t0


def phase_iic(smi: str):
    """IIC clip retrieval at the UCF config's width (R3D-18, 10 clips of
    16x128x128 a video, bf16): seeded MJPG videos in the UCF layout;
    ``iic_retrieve_clips.main`` in this process (the entry point of
    ``python -m ...iic_retrieve_clips``) on a .pth.tar of the smoke's
    seeded R3D-18, its nn1_cosine launches counted from 0 just before it
    (0), its topk_correct.json and its features held to this script's own
    pass on the card; decode ms a video, the feature pass's clips/s and its
    share of the bf16 bound from the port's ``resnet3d_flops_per_clip``
    (held equal to the hooks' count). -> the CLI's launches."""
    import torch

    from video_similarity_search_tpu_torch.cli import iic_retrieve_clips
    from video_similarity_search_tpu_torch.data.augment import normalize_only
    from video_similarity_search_tpu_torch.data.iic_data import \
        UCF101ClipRetrievalDataset
    from video_similarity_search_tpu_torch.models import model_selector
    from video_similarity_search_tpu_torch.ops import fused_knn
    from video_similarity_search_tpu_torch.train.checkpoint import (
        load_encoder_state, load_torch_checkpoint)
    from video_similarity_search_tpu_torch.train.steps import make_embed_step
    from video_similarity_search_tpu_torch.utils.flops import (
        model_flops_per_clip, peaks_for, resnet3d_flops_per_clip)

    root, write_s = make_iic_videos(os.path.join(OUT, "iic_videos"))
    work = os.path.join(OUT, "iic")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = load_cfg(UCF_YAML, [])
    t, s, r = (cfg.DATA.SAMPLE_DURATION, cfg.DATA.SAMPLE_SIZE, cfg.RESNET)
    torch.manual_seed(SEED)
    model = model_selector(cfg)
    ckpt = os.path.join(work, "r3d18_seed0.pth.tar")
    torch.save({"state_dict": {"module." + k: v.detach().cpu()
                               for k, v in model.state_dict().items()},
                "epoch": 0}, ckpt)
    feature_dir = os.path.join(work, "features")
    fused_knn.LAUNCHES = 0
    stdout, wall = run_main(iic_retrieve_clips.main, [
        "--cfg", UCF_YAML, "--dataset", "ucf101", "--root_dir", root,
        "--checkpoint_path", ckpt, "--feature_dir", feature_dir,
        "--clip_len", str(t), "--sample_num", str(IIC_SAMPLE_NUM),
        "--device", "cuda"], "IIC CLI")
    launches = fused_knn.LAUNCHES
    check(launches == 0, f"the IIC path launched nn1_cosine {launches} times")
    with open(os.path.join(feature_dir, "topk_correct.json")) as f:
        topk = json.load(f)
    check(sorted(topk) == ["1", "10", "20", "5", "50"]
          and all(0 <= v <= 1 for v in topk.values()),
          f"IIC topk_correct.json ({topk})")

    # the same weights and videos through this script's own loop
    model = model_selector(cfg)
    load_encoder_state(model, load_torch_checkpoint(ckpt)["torch_state_dict"],
                       verbose=False)
    embed = make_embed_step(cfg, model, device="cuda")
    sample_num = IIC_SAMPLE_NUM
    decode_ms, embed_s, n_clips, max_cos = [], 0.0, 0, {}
    for split in ("train", "test"):
        ds = UCF101ClipRetrievalDataset(root, t, sample_num=sample_num,
                                        train=split == "train",
                                        sample_size=s)
        items = []
        for i in range(len(ds)):
            t0 = time.perf_counter()
            items.append(ds[i]["clips"])
            decode_ms.append((time.perf_counter() - t0) * 1e3)
        feats = []
        embed(normalize_only(torch.from_numpy(items[0]).cuda()))  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for clips in items:
            feats.append(embed(normalize_only(torch.from_numpy(clips)
                                              .cuda())))
        torch.cuda.synchronize()
        embed_s += time.perf_counter() - t0
        n_clips += sum(len(c) for c in items)
        mine = torch.stack(feats).cpu().numpy()
        cli = np.load(os.path.join(feature_dir, f"{split}_features.npy"))
        check(cli.shape == mine.shape == (len(ds), sample_num,
                                          r.OUT_DIM)
              and bool(np.isfinite(cli).all()),
              f"IIC {split} features: shape {cli.shape} and finite")
        a = cli / np.linalg.norm(cli, axis=-1, keepdims=True)
        b = mine / np.linalg.norm(mine, axis=-1, keepdims=True)
        max_cos[split] = float(np.max(1.0 - np.sum(a * b, axis=-1)))
        # same weights, inputs and path, one process
        check(max_cos[split] < 1e-5, f"IIC CLI {split} features vs "
              f"in-process: {max_cos[split]}")
    flops = resnet3d_flops_per_clip(
        r.MODEL_DEPTH, t=t, size=s, conv1_t_size=r.CONV1_T_SIZE,
        conv1_t_stride=r.CONV1_T_STRIDE, no_max_pool=r.NO_MAX_POOl,
        widen_factor=r.WIDEN_FACTOR, hidden_layer=r.HIDDEN_LAYER,
        out_dim=r.OUT_DIM)
    hooks = model_flops_per_clip(
        model, torch.zeros((1, t, s, s, 3), device="cuda"))["forward"]
    check(hooks == flops, f"R3D-18 FLOPs: the formula's {flops} equals the "
          f"hooks' {hooks}")
    clips_per_s = n_clips / embed_s
    peak = peaks_for(smi)[1][3]  # bf16 dense, the card's form factor
    emit("iic", command="iic_retrieve_clips.main(['--dataset', 'ucf101', "
         "...])", wall_s=wall,
         videos={"classes": IIC_CLASSES, "train": IIC_CLASSES
                 * IIC_TRAIN_PER_CLASS, "test": IIC_CLASSES
                 * IIC_TEST_PER_CLASS, "frames": list(IIC_FRAMES),
                 "frame_hw": list(LMDB_HW), "write_s": write_s},
         clip=[t, s, s, 3], clips_per_video=sample_num,
         dtype=cfg.TPU.COMPUTE_DTYPE, topk_correct=topk,
         max_cos_dist_vs_in_process=max_cos,
         decode_ms_per_video=float(np.median(decode_ms)),
         decode_ms_all=decode_ms, feature_clips_per_s=clips_per_s,
         gflop_per_clip=flops / 1e9, bf16_peak_tflops=peak / 1e12,
         bound_share=clips_per_s * flops / peak,
         stdout_tail=stdout.strip().splitlines()[-3:],
         nn1_cosine_launches=launches, device=smi)
    return launches


# --------------------------------------------------------------------------
# the sixth slice: SlowFast at get_cfg()'s defaults, its checkpoint import,
# and the MoCo InfoNCE / UberNCE pretrain

SF_EMBED_BATCH = 64
# Caffe2 blob suffix of each BatchNorm field (reference c2_model_loading.py)
C2_BN = {"weight": "s", "bias": "b", "running_mean": "rm",
         "running_var": "riv"}


def caffe2_blob_name(key: str):
    """A pyslowfast torch name -> its Caffe2 blob name (the inverse of the
    port's ``caffe2_name_to_torch`` on SlowFast's stems, fusions and
    blocks); None for the fc1/fc2 projection and the counters, which have
    no blob."""
    if key.endswith("num_batches_tracked") or key.startswith(("fc1.",
                                                              "fc2.")):
        return None
    m = re.match(r"^s1\.pathway([01])_stem\.(conv|bn)\.(\w+)$", key)
    if m:
        t = "t_" if m.group(1) == "1" else ""
        return (f"{t}conv1_w" if m.group(2) == "conv"
                else f"{t}res_conv1_bn_{C2_BN[m.group(3)]}")
    m = re.match(r"^s(\d)_fuse\.(conv_f2s|bn)\.(\w+)$", key)
    if m:
        base = ("t_pool1_subsample" if m.group(1) == "1"
                else f"t_res{m.group(1)}_0_branch2c_bn_subsample")
        return (f"{base}_w" if m.group(2) == "conv_f2s"
                else f"{base}_bn_{C2_BN[m.group(3)]}")
    m = re.match(r"^s(\d)\.pathway([01])_res(\d+)\.(branch1|branch2\.[abc])"
                 r"(_bn)?\.(\w+)$", key)
    if m and m.group(6) in C2_BN:
        n, p, i, br, bn, field = m.groups()
        t = "t_" if p == "1" else ""
        name = f"{t}res{n}_{i}_" + br.replace("branch2.", "branch2")
        return f"{name}_bn_{C2_BN[field]}" if bn else f"{name}_w"
    raise RuntimeError(f"check failed: no Caffe2 blob for {key}")


def slowfast_checkpoints(model):
    """The Caffe2 import into the full model: a blob dict made from
    ``model``'s own state_dict (solver blobs beside it) written as a .pkl
    loads every backbone tensor unchanged through ``load_torch_checkpoint``
    and ``load_encoder_state``; its 2-D counterpart (each kernel's
    temporal slices summed to one (Cout, Cin, kH, kW) kernel) loads with
    ``inflate_temporal`` as kT copies of it / kT, the BatchNorms as they
    are."""
    import pickle

    import torch

    from video_similarity_search_tpu_torch.models import model_selector
    from video_similarity_search_tpu_torch.train.checkpoint import (
        caffe2_name_to_torch, load_encoder_state, load_torch_checkpoint)

    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    blobs = {}
    for k, v in sd.items():
        name = caffe2_blob_name(k)
        if name is not None:
            check(caffe2_name_to_torch(name) == k, f"{name} -> {k}")
            blobs[name] = v.numpy()
    flat = {n: (v.sum(axis=2) if v.ndim == 5 else v)
            for n, v in blobs.items()}
    out = {"blobs": len(blobs)}
    for what, payload, inflate in (("caffe2", blobs, False),
                                   ("caffe2_2d_inflated", flat, True)):
        path = os.path.join(OUT, f"slowfast_{what}.pkl")
        with open(path, "wb") as f:
            pickle.dump({"blobs": {**payload, "model_iter": np.int64(1),
                                   "lr": np.float32(0.1)}}, f, protocol=2)
        t0 = time.perf_counter()
        fresh = model_selector(load_cfg(None, []))
        got = load_encoder_state(
            fresh, load_torch_checkpoint(path)["torch_state_dict"],
            verbose=False, inflate_temporal=inflate)
        own = fresh.state_dict()
        worst = 0.0
        for k in got["loaded"]:
            want = sd[k]
            if inflate and want.ndim == 5:
                kt = want.shape[2]
                want = (want.sum(dim=2, keepdim=True) / kt).expand_as(want)
            worst = max(worst, float((own[k] - want).abs().max()))
        check(len(got["loaded"]) == len(blobs) and got["skipped"] == [],
              f"{what}: {len(got['loaded'])} of {len(blobs)} blobs loaded")
        check(worst <= 1e-6, f"{what}: loaded tensors within {worst}")
        out[what] = {"loaded": len(got["loaded"]),
                     "kept_at_init": len(got["missing"]),
                     "max_abs_err": worst,
                     "load_s": time.perf_counter() - t0,
                     "file_mib": os.path.getsize(path) / 2 ** 20}
        os.remove(path)
    return out


def phase_slowfast(smi: str):
    """SlowFast at get_cfg()'s defaults, unchanged (SlowFast-50, ALPHA 4,
    BETA_INV 8, fusion ratio 2 and kernel 7, 8x224x224 clips, the triplet
    loss with random_semi_hard mining, TRAIN.BATCH_SIZE 16 anchors, bf16):
    the defaults add no third view, so a step is 16 anchors + 16 positives
    = 32 clips. (a) one fp32 step at 2 anchors on the card held to the CPU
    and to fp64 on the card (train_step (a)); (b) bf16 against fp32 at the
    full batch; (c) ms a bf16 step with its device split, clips/s, peak
    GiB, and the step's bound from the hooks' FLOPs at the bf16 peak; (d)
    30 steps lower the triplet loss; the eval embed pass at batch 64; the
    Caffe2 and inflated 2-D imports into the full model."""
    import torch

    from video_similarity_search_tpu_torch.data.augment import normalize_only
    from video_similarity_search_tpu_torch.models import model_selector
    from video_similarity_search_tpu_torch.models.slowfast import \
        multipathway_input
    from video_similarity_search_tpu_torch.ops import fused_knn
    from video_similarity_search_tpu_torch.train.steps import make_embed_step
    from video_similarity_search_tpu_torch.utils.flops import (
        model_flops_per_clip, peaks_for)

    _, peaks = peaks_for(smi)
    cfg = load_cfg(None, ["OUTPUT_PATH", os.path.join(OUT, "slowfast")])
    b, t, s = cfg.TRAIN.BATCH_SIZE, cfg.DATA.SAMPLE_DURATION, cfg.DATA.SAMPLE_SIZE
    fused_knn.LAUNCHES = 0
    torch.manual_seed(SEED)
    model = model_selector(cfg)
    init = model.state_dict()
    rng = np.random.default_rng(SEED)
    host = triplet_batch(rng, b, t, s, n_cls=8)
    views = train_views(cfg)
    model.cuda().eval()
    flop = model_flops_per_clip(model, multipathway_input(
        torch.zeros((1, t, s, s, 3), device="cuda"), cfg.SLOWFAST.ALPHA),
        [model.s1.pathway0_stem.conv, model.s1.pathway1_stem.conv])
    per_clip = 3 * flop["forward"] - flop["first"]  # no input gradient
    clips = len(views) * b
    vs_cpu = step_vs_cpu(cfg, init, host)
    torch.cuda.empty_cache()
    vs_fp32 = bf16_vs_fp32(cfg, init, host, fp64=False)
    torch.cuda.empty_cache()
    timing = time_steps(cfg, init, host, 1)
    timing.update(bound(clips * per_clip, sum(host[k].nbytes for k in views)
                        + 4 * 4 * sum(v.numel() for v in init.values()),
                        "bfloat16", peaks))
    torch.cuda.empty_cache()
    learn = learning_check(cfg, init, rng)
    torch.cuda.empty_cache()
    embed = make_embed_step(cfg, model, device="cuda")
    x = normalize_only(torch.from_numpy(class_clips(
        rng, rng.integers(0, 8, SF_EMBED_BATCH), t, s, 8)).cuda(),
        dataset=cfg.TRAIN.DATASET)
    torch.cuda.reset_peak_memory_stats()
    emb = embed(x)
    check(tuple(emb.shape) == (SF_EMBED_BATCH, cfg.SLOWFAST.OUT_DIM)
          and bool(torch.isfinite(emb).all()), "finite embeddings")
    eval_ms = time_ms(lambda: embed(x))
    ev = {"batch": SF_EMBED_BATCH, "ms": eval_ms,
          "clips_per_s": SF_EMBED_BATCH / (eval_ms / 1e3),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    ev.update(bound(SF_EMBED_BATCH * flop["forward"], x.numel() * 4,
                    "bfloat16", peaks))
    del x, embed
    torch.cuda.empty_cache()
    ckpt = slowfast_checkpoints(model)
    launches = fused_knn.LAUNCHES
    check(launches == 0, f"the SlowFast path launched nn1_cosine "
          f"{launches} times")
    emit("slowfast", config="get_cfg() defaults",
         arch=f"SlowFast-{cfg.SLOWFAST.DEPTH}",
         alpha=cfg.SLOWFAST.ALPHA, beta_inv=cfg.SLOWFAST.BETA_INV,
         clip=[t, s, s, 3], anchors=b, views=list(views),
         clips_per_step=clips, dtype=str(cfg.TPU.COMPUTE_DTYPE),
         strategy=cfg.DATASET.SAMPLING_STRATEGY, lr=cfg.OPTIM.LR,
         params=sum(p.numel() for p in model.parameters()),
         forward_gflop_per_clip=flop["forward"] / 1e9,
         step_gflop_per_clip=per_clip / 1e9, fp32_card_vs_cpu=vs_cpu,
         bf16_vs_fp32=vs_fp32, timing=timing, learning=learn, eval=ev,
         checkpoints=ckpt, nn1_cosine_launches=launches)
    return timing["clips_per_s"]


MOCO_ARCHES = ("info_nce", "uber_nce")
MOCO_T, MOCO_S = CLS_T, CLS_S  # the classifier phase's clip shape
MOCO_ANCHORS = 32
MOCO_FP64_ANCHORS = 4
MOCO_CLASSES = 8
MOCO_CLI_CLASSES = 10  # of the synthetic set's 40: 110 train videos
MOCO_MIN_GRAD_COS = CLS_FP32_MIN_GRAD_COS  # S3D's fp32 step at init
# the learning check: UberNCE's loss cannot fall below the mean log of
# each row's positive count (its optimum spreads p over the positives),
# log(1 + 1024 / 8) = 4.86 here, so the check holds the loss's excess over
# that floor, at the UCF config's lr 0.1
MOCO_LEARN_LR = 0.1
MOCO_LEARN_MAX_EXCESS = 0.9


def moco_cfg(arch: str, dtype=None, extra=()):
    opts = ["MODEL.ARCH", arch, "LOSS.TYPE", "UberNCE",
            "TRAIN.BATCH_SIZE", MOCO_ANCHORS, "DATA.SAMPLE_DURATION", MOCO_T,
            "DATA.SAMPLE_SIZE", MOCO_S,
            "OUTPUT_PATH", os.path.join(OUT, "moco")] + list(extra)
    if dtype is not None:
        opts += ["TPU.COMPUTE_DTYPE", dtype]
    return load_cfg(None, opts)


def moco_trainer(cfg, init, dtype=None):
    """The MoCo encoder from ``init`` on the card (cast to ``dtype``, its
    key encoder too; the queue stays float32) with its optimizer, its
    ``moco`` bank (queue seeded) and step."""
    from video_similarity_search_tpu_torch.models import model_selector
    from video_similarity_search_tpu_torch.train.driver import \
        make_train_step
    from video_similarity_search_tpu_torch.train.state import make_optimizer
    from video_similarity_search_tpu_torch.train.steps import make_banks

    model = model_selector(cfg)
    model.load_state_dict(init)
    model.cuda()
    banks = make_banks(cfg, 0, model)
    if dtype is not None:
        model.to(dtype)
        banks["moco"].encoder_k.to(dtype)
    opt, sched = make_optimizer(cfg, model.parameters())
    step, _ = make_train_step(cfg, model, opt, sched, banks, device="cuda")
    return model, banks["moco"], step


def moco_batch(rng, b, structured=False, dtype=None):
    """Normalized x1 / x2 views (two clips of each row's class) and their
    labels, drawn on the card from a seed taken from ``rng`` (a host
    draw of 2 x 32 clips of 32x128x128 takes ~2 s). ``structured``: each
    class has its own colour under per-clip noise, as ``class_clips``;
    otherwise uniform noise."""
    import torch

    from video_similarity_search_tpu_torch.data.augment import normalize_only

    labels = rng.integers(0, MOCO_CLASSES, b)
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(2 ** 31)))
    shape = (b, MOCO_T, MOCO_S, MOCO_S, 3)
    colors = torch.from_numpy(np.random.default_rng(SEED).integers(
        30, 226, (MOCO_CLASSES, 3))[labels]).cuda()[:, None, None, None, :]
    out = {}
    for k in ("x1", "x2"):
        if structured:
            noise = torch.randint(-60, 61, shape, generator=gen, device="cuda")
            u8 = (colors + noise).clamp(0, 255).to(torch.uint8)
        else:
            u8 = torch.randint(0, 256, shape, generator=gen, device="cuda",
                               dtype=torch.uint8)
        out[k] = normalize_only(u8, dataset="ucf101")
        if dtype is not None:
            out[k] = out[k].to(dtype)
    out["label"] = torch.from_numpy(labels).cuda()
    return out


def time_moco(arch, dtype, init, rng):
    """ms of a step (median of TIMED_STEPS after two warm-up steps, host
    clock around a synchronized step), clips/s (two views a row) and peak
    GiB; the stem weight gradient kernel's launches in the timed steps
    (one a float32 step, none in bf16) and in a key forward after them
    (none); in bf16 (the config's dtype) the device split of the step's
    ranges too."""
    import torch

    from video_similarity_search_tpu_torch.ops import stem_wgrad
    from video_similarity_search_tpu_torch.train.steps import RANGES

    model, bank, step = moco_trainer(moco_cfg(arch, dtype), init)
    batch = moco_batch(rng, MOCO_ANCHORS)
    first = float(step(batch)["loss"])
    step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    stem_wgrad.LAUNCHES = 0
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        met = step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = {"timed_steps": stem_wgrad.LAUNCHES}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = float(np.median(times))
    stem_wgrad.LAUNCHES = 0
    bank.keys(batch["x2"])
    torch.cuda.synchronize()
    launches["key_forward"] = stem_wgrad.LAUNCHES
    check(np.isfinite(first), f"{arch} {dtype}: a finite first loss")
    check(launches == {"timed_steps": TIMED_STEPS * (dtype == "float32"),
                       "key_forward": 0}, f"{arch} {dtype}: the stem weight "
          "gradient kernel launches once a float32 step, never in bf16 or "
          f"the key forward ({launches})")
    out = {"arch": arch, "dtype": dtype, "step_ms": ms, "step_ms_all": times,
           "clips_per_s": 2 * MOCO_ANCHORS / (ms / 1e3),
           "peak_mem_gib": peak, "first_loss": first,
           "last_loss": float(met["loss"]), "queue_ptr": int(bank.queue_ptr),
           "stem_wgrad_launches": launches}
    if dtype == "bfloat16":
        out["device_split_ms"] = device_split_ms(lambda: step(batch),
                                                 TIMED_STEPS, RANGES)
    return out


def moco_fp32_vs_fp64(arch, init):
    """One step at MOCO_FP64_ANCHORS anchors, fp32 (TF32 off) against fp64
    networks on the card from the same weights, queue and batch (the queue
    and logits float32 in both, as in the JAX step): the loss, the whole
    gradient's cosine, the queue, its pointer and labels; and in each run
    the key parameters' move equal to (1 - m) x the query's update, the
    momentum update from the updated query parameters."""
    import torch

    from video_similarity_search_tpu_torch.train import steps

    cfg = moco_cfg(arch, "float32")
    batch = moco_batch(np.random.default_rng(SEED + 3), MOCO_FP64_ANCHORS)
    res = {}
    m = steps.MOCO_M

    def flat(params):
        return torch.cat([p.detach().double().flatten() for p in params])

    for dtype in (torch.float32, torch.float64):
        model, bank, step = moco_trainer(cfg, init, dtype)
        b = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in batch.items()}
        q0, k0 = flat(model.parameters()), flat(bank.encoder_k.parameters())
        met = step(b)  # the gradients stay until the next step
        q1, k1 = flat(model.parameters()), flat(bank.encoder_k.parameters())
        res[dtype] = {
            "loss": float(met["loss"]),
            "grad": torch.cat([p.grad.double().flatten()
                               for p in model.parameters()]),
            "key": k1,
            "momentum_err": float(((k1 - k0) - (1 - m) * (q1 - q0)).abs()
                                  .max()),
            "key_scale": max(1.0, float(k0.abs().max())),
            "bank": {k: v.detach().clone() for k, v in
                     bank.state_dict().items()
                     if not k.startswith("encoder_k.")}}
        del model, bank, step
        torch.cuda.empty_cache()
    lo, hi = res[torch.float32], res[torch.float64]
    out = {"anchors": MOCO_FP64_ANCHORS, "loss_fp32": lo["loss"],
           "loss_fp64": hi["loss"],
           "loss_rel_diff": abs(lo["loss"] - hi["loss"]) / abs(hi["loss"]),
           "grad_cosine": float(torch.nn.functional.cosine_similarity(
               lo["grad"], hi["grad"], dim=0)),
           "key_params_max_abs_diff": float((lo["key"] - hi["key"])
                                            .abs().max()),
           "momentum_max_abs_err_fp32": lo["momentum_err"],
           "momentum_max_abs_err_fp64": hi["momentum_err"],
           "queue_max_abs_diff": float((lo["bank"]["queue"]
                                        - hi["bank"]["queue"]).abs().max()),
           "queue_ptr": int(lo["bank"]["queue_ptr"])}
    exact = [k for k in lo["bank"] if k != "queue"]
    check(all(torch.equal(lo["bank"][k], hi["bank"][k]) for k in exact)
          and out["queue_ptr"] == MOCO_FP64_ANCHORS,
          f"{arch} fp32 vs fp64: the same pointer and labels")
    # the loss is logsumexp minus the positive logit, both ~1/T = 14 at
    # init and nearly equal: relative to a loss of ~0.004 their float32
    # rounding reads as ~1e-4, so small losses are held absolutely
    check(abs(lo["loss"] - hi["loss"]) <= 1e-4 * max(abs(hi["loss"]), 1.0)
          and out["grad_cosine"] >= MOCO_MIN_GRAD_COS
          and out["queue_max_abs_diff"] <= 1e-3,
          f"{arch} fp32 vs fp64: {out}")
    check(all(r["momentum_err"] <= 1e-6 * r["key_scale"]
              for r in (lo, hi)), f"{arch}: the key parameters moved by "
          f"(1 - m) x the query's update ({lo['momentum_err']}, "
          f"{hi['momentum_err']})")
    return out


def moco_learning(init):
    """LEARN_STEPS bf16 uber_nce steps at lr MOCO_LEARN_LR on fresh
    class-coloured batches (8 classes; every queue entry of a row's class
    is a positive), after the queue is filled with the key encoder's keys
    of such batches, so the first loss scores real negatives: the loss's
    excess over its floor (MOCO_LEARN_MAX_EXCESS) falls."""
    import torch

    _, bank, step = moco_trainer(moco_cfg("uber_nce", extra=[
        "OPTIM.LR", MOCO_LEARN_LR]), init)
    rng = np.random.default_rng(SEED + 4)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        for _ in range(bank.queue.shape[0] // MOCO_ANCHORS):
            b = moco_batch(rng, MOCO_ANCHORS, structured=True)
            bank.dequeue_and_enqueue(bank.keys(b["x2"]), b["label"])
    losses, floors = [], []
    for _ in range(LEARN_STEPS):
        b = moco_batch(rng, MOCO_ANCHORS, structured=True)
        positives = 1 + (bank.queue_labels[None] == b["label"][:, None]).sum(1)
        floors.append(torch.log(positives.float()).mean())
        losses.append(step(b)["loss"])
    losses, floors = np.array([float(v) for v in losses]), np.array(
        [float(v) for v in floors])
    excess = float(np.mean(losses[-5:] - floors[-5:])
                   / np.mean(losses[:5] - floors[:5]))
    check(bool(np.isfinite(losses).all()) and excess <= MOCO_LEARN_MAX_EXCESS,
          f"MoCo learning check: the last 5 steps' mean excess loss is "
          f"{excess:.3f} of the first 5's (<= {MOCO_LEARN_MAX_EXCESS})")
    return {"arch": "uber_nce", "lr": MOCO_LEARN_LR, "steps": LEARN_STEPS,
            "first5_mean": float(np.mean(losses[:5])),
            "last5_mean": float(np.mean(losses[-5:])),
            "floor_mean": float(floors.mean()), "excess_ratio": excess,
            "losses": losses.tolist()}


def moco_cli(paths):
    """The training CLI with MODEL.ARCH uber_nce and LOSS.TYPE UberNCE on
    MOCO_CLI_CLASSES classes of the synthetic set (the UCF config's
    16x128x128 clips and 32 anchors): one epoch as python -m, then a second
    resumed from its checkpoint in this process, whose ``moco`` bank (key
    encoder, queue, pointer, labels) must be the saved one."""
    import torch

    from video_similarity_search_tpu_torch.cli import online_train
    from video_similarity_search_tpu_torch.train import steps

    jpg, ann, flow = paths
    work = os.path.join(OUT, "moco_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ann_val = train_cli_annotations(ann, work, MOCO_CLI_CLASSES)[1]
    out = os.path.join(work, "out")
    opts = ["DATASET.VID_PATH", jpg, "DATASET.ANNOTATION_PATH", ann_val,
            "DATASET.OPTICAL_U_PATH", flow, "MODEL.ARCH", "uber_nce",
            "LOSS.TYPE", "UberNCE", "OPTIM.LR", str(NCE_CLI_LR)]
    cli = ["--cfg", UCF_YAML, "--output", out, "--device", "cuda"]
    stdout, wall = run_cli([sys.executable, "-m",
                            "video_similarity_search_tpu_torch.cli."
                            "online_train"] + cli + opts
                           + ["TRAIN.EPOCHS", "1"], "UberNCE CLI")
    ckpt = os.path.join(out, "tnet_checkpoints", "uber_nce",
                        "checkpoint.pth.tar")
    saved = torch.load(ckpt, map_location="cpu", weights_only=False)
    check(saved["epoch"] == 1 and set(saved.get("banks", {})) == {"moco"},
          "the checkpoint holds epoch 1 and the moco bank")
    seen = {}
    make_step = steps.make_moco_train_step

    def spy(cfg, model, optimizer, schedule, bank, **kw):
        seen.update({k: v.detach().cpu().clone()
                     for k, v in bank.state_dict().items()})
        return make_step(cfg, model, optimizer, schedule, bank, **kw)

    steps.make_moco_train_step = spy
    try:
        res_out, res_wall = run_main(
            online_train.main, cli + ["--checkpoint_path", out] + opts
            + ["TRAIN.EPOCHS", "2"], "resumed UberNCE CLI")
    finally:
        steps.make_moco_train_step = make_step
    want = saved["banks"]["moco"]
    check(seen.keys() == want.keys()
          and all(torch.equal(seen[k], v) for k, v in want.items()),
          "the resumed run starts from the saved moco bank, byte-equal")
    check("WARNING: restore" not in res_out, "a clean resume")
    with open(os.path.join(out, "tnet_checkpoints",
                           "train_loss_and_acc.txt")) as f:
        lines = f.read().splitlines()
    losses = [float(ln.split()[-1]) for ln in lines]
    check(len(lines) == 2 and all(np.isfinite(losses)),
          "two epochs, finite losses")
    top1 = [float(v) for v in re.findall(r"Top1:(\S+)", stdout + res_out)]
    rates = [float(m) for m in re.findall(
        r"Train set: Average loss: \S+ \(([\d.]+) clips/s", stdout + res_out)]
    return {"wall_s": wall, "resume_wall_s": res_wall, "train_loss": losses,
            "top1": top1, "loader_fed_anchors_per_s": rates,
            "queue_labels_filled": int((want["queue_labels"] >= 0).sum()),
            "bank_restored_byte_equal": True}


def phase_moco(paths):
    """LOSS.TYPE UberNCE with the MoCo S3D encoder (info_nce, uber_nce) at
    the classifier phase's clips (32 anchors of 32x128x128, two views,
    LOSS.K 1024): a timed step in bf16 and fp32 for each arch, one fp32
    step held to fp64 (uber_nce, whose queue carries labels; info_nce
    shares its forward and update), a learning check, and the CLI for an
    epoch and a resumed second, each part's seconds beside it."""
    import torch

    from video_similarity_search_tpu_torch.models import model_selector
    from video_similarity_search_tpu_torch.ops import fused_knn

    fused_knn.LAUNCHES = 0
    torch.manual_seed(SEED)
    init = model_selector(moco_cfg("uber_nce")).state_dict()
    rng = np.random.default_rng(SEED)
    sec = {}

    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        sec[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        return out

    timing = [part(f"time_{a}_{d}", time_moco, a, d, init, rng)
              for a in MOCO_ARCHES for d in ("bfloat16", "float32")]
    vs64 = part("fp32_vs_fp64", moco_fp32_vs_fp64, "uber_nce", init)
    learn = part("learning", moco_learning, init)
    cli = part("cli", moco_cli, paths)
    launches = fused_knn.LAUNCHES
    check(launches == 0, f"the MoCo path launched nn1_cosine {launches} "
          "times")
    emit("moco", network="s3d", anchors=MOCO_ANCHORS,
         clip=[MOCO_T, MOCO_S, MOCO_S, 3], k=moco_cfg("info_nce").LOSS.K,
         timing=timing, fp32_vs_fp64=vs64, learning=learn, cli=cli,
         nn1_cosine_launches=launches, seconds=sec)
    return {f"{t['arch']} {t['dtype']}": t["stem_wgrad_launches"]
            for t in timing}


DIST_WORLD = 2  # gloo ranks sharing the one card
DIST_CHECK_ANCHORS = 4  # the fp32 check's global batch: 12 clips
DIST_BANK = 24_000  # > FINCH's DENSE_THRESHOLD (20,000): level 0 on the kernel
DIST_JOIN_S = 600


def dist_cfg(dtype=None):
    cfg = load_cfg(UCF_YAML, ["OUTPUT_PATH", os.path.join(OUT, "dist")])
    if dtype:
        cfg.TPU.COMPUTE_DTYPE = dtype
    return cfg


def dist_init(cfg):
    import torch

    from video_similarity_search_tpu_torch.models import model_selector

    torch.manual_seed(SEED)
    return model_selector(cfg).state_dict()


def dist_host(anchors: int):
    """The global uint8 batch of ``anchors`` (train_step's clips at 32)."""
    cfg = dist_cfg()
    t, s = cfg.DATA.SAMPLE_DURATION, cfg.DATA.SAMPLE_SIZE
    return triplet_batch(np.random.default_rng(SEED), anchors, t, s,
                         n_cls=16)


def dist_batch(cfg, host, gen, rank: int, world: int, dtype=None):
    """Rank's rows of the global batch ``host``, augmented on the card with
    the draws of the global batch (``train_augment``'s ``shard``);
    ``targets`` [anchor labels; positive labels] of those rows."""
    import torch

    from video_similarity_search_tpu_torch.data.augment import train_augment

    b = host["targets"].shape[0] // 2 // world
    rows = slice(rank * b, (rank + 1) * b)
    out = {k: train_augment(torch.from_numpy(host[k][rows]).cuda(), gen,
                            cfg.DATA.SAMPLE_SIZE, dataset=cfg.TRAIN.DATASET,
                            pre_cropped=True, shard=(rank, world))
           for k in train_views(cfg)}
    if dtype is not None:
        out = {k: v.to(dtype) for k, v in out.items()}
    out["targets"] = torch.from_numpy(
        host["targets"].reshape(2, world, b)[:, rank].reshape(-1)).cuda()
    return out


def dist_fp32_step(rank: int, world: int, dtype=None) -> dict:
    """One fp32 (TF32 off) step of the check batch on rank's rows: the
    loss, negatives, n_triplets and the state after it, on the host."""
    import torch

    cfg = dist_cfg("float32")
    model, _, _, step, _ = fresh_trainer(cfg, dist_init(cfg), "cuda")
    if dtype is not None:
        model.to(dtype)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    batch = dist_batch(cfg, dist_host(DIST_CHECK_ANCHORS), gen, rank, world,
                       dtype)
    met = step(batch, gen)
    out = {"loss": float(met["loss"]), "n": int(met["n_triplets"]),
           "neg": met["negatives"].cpu(),
           "sd": {k: v.detach().cpu().double()
                  for k, v in model.state_dict().items()}}
    del model, step, batch
    torch.cuda.empty_cache()
    return out


def dist_step_ms(rank: int, world: int, dtype=None) -> dict:
    """Median ms of the bf16 (or ``dtype``) step of train_step's global
    batch (32 anchors, 96 clips) on rank's rows after two warm-up steps,
    on the host clock around a synchronized step (augmentation of rank's
    rows included)."""
    import torch

    cfg = dist_cfg(dtype)
    _, _, _, step, _ = fresh_trainer(cfg, dist_init(cfg), "cuda")
    host = dist_host(cfg.TRAIN.BATCH_SIZE)
    gen = torch.Generator(device="cuda")
    times, losses = [], []
    for i in range(2 + TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen.manual_seed(SEED + 10 + i)
        met = step(dist_batch(cfg, host, gen, rank, world), gen)
        losses.append(float(met["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
    del step
    torch.cuda.empty_cache()
    return {"step_ms": float(np.median(times[2:])), "step_ms_all": times[2:],
            "losses": losses, "clips_per_step": 3 * cfg.TRAIN.BATCH_SIZE}


def dist_rank(rank: int, world: int, port: int, out_path: str) -> None:
    """One gloo rank of the dist phase, on card 0 beside the others."""
    from datetime import timedelta

    import torch

    sys.path.insert(0, ROOT)
    from video_similarity_search_tpu_torch import parallel
    from video_similarity_search_tpu_torch.cluster import fit_cluster
    from video_similarity_search_tpu_torch.ops import fused_knn

    torch.cuda.set_device(0)
    parallel.initialize_distributed(f"tcp://127.0.0.1:{port}", world, rank,
                                    backend="gloo",
                                    timeout=timedelta(seconds=300))
    try:
        out = {"fp32": dist_fp32_step(rank, world),
               "bf16": dist_step_ms(rank, world)}
        bank, _ = mixture(DIST_BANK, seed=1)
        fused_knn.LAUNCHES = 0
        t0 = time.perf_counter()
        labels = fit_cluster(bank, method="finch", verbose=False,
                             device="cuda")
        out["cluster_s"] = time.perf_counter() - t0
        out["launches"] = fused_knn.LAUNCHES
        out["labels"] = np.asarray(labels)
    finally:
        parallel.destroy()
    import pickle

    with open(out_path % rank, "wb") as f:
        pickle.dump(out, f)


def run_ranks(world: int) -> list:
    """``dist_rank`` on ``world`` spawned processes, joined within
    DIST_JOIN_S (killed after it) -> their results."""
    import pickle

    import torch.multiprocessing as mp

    work = tempfile.mkdtemp(dir=OUT)
    path = os.path.join(work, "rank%d.pkl")
    from video_similarity_search_tpu_torch import parallel

    ctx = mp.start_processes(dist_rank,
                             args=(world, parallel.free_port(), path),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + DIST_JOIN_S
    try:
        while not ctx.join(timeout=5):
            check(time.monotonic() < deadline,
                  f"dist ranks finish within {DIST_JOIN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    out = []
    for r in range(world):
        with open(path % r, "rb") as f:
            out.append(pickle.load(f))
    shutil.rmtree(work, ignore_errors=True)
    return out


DIST_CLI_RUNS = {  # checkpoint bank name -> CLI options
    "mem_triplet": ["--iterative_cluster", "LOSS.MEM_TRIPLET", "True",
                    "LOSS.MEM_TRIPLET_K", str(MEM_TRIPLET_K),
                    "ITERCLUSTER.INTERVAL", "1"],
    "moco": ["MODEL.ARCH", "uber_nce", "LOSS.TYPE", "UberNCE",
             "OPTIM.LR", str(NCE_CLI_LR)]}


def dist_cli(paths) -> dict:
    """The training CLI's ``_run`` (``_rank_device`` on --gpu 0, then
    ``driver.train``) inside a world-1 NCCL group, one epoch on
    NCE_CLI_CLASSES classes of the synthetic set with the MEM_TRIPLET bank
    (and the cluster step), then with UberNCE's: the driver's broadcast of
    the model and the bank, its checkpoint agreement, the synced BatchNorm
    and the steps' gathers all run over NCCL, which takes CUDA tensors
    only. Each run writes its logs (and NMIs and vid_clusters.txt with
    --iterative_cluster) and a checkpoint that holds its bank. The NCE
    banks take the same path (the GPU-marked hygiene test runs them).
    -> {bank: its numbers}."""
    from datetime import timedelta

    import torch

    from video_similarity_search_tpu_torch import parallel
    from video_similarity_search_tpu_torch.cli import online_train
    from video_similarity_search_tpu_torch.config import arg_parser

    jpg, ann, flow = paths
    work = os.path.join(OUT, "dist_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ann_val = train_cli_annotations(ann, work, NCE_CLI_CLASSES)[1]
    out = {}
    for bank, opts in DIST_CLI_RUNS.items():
        run_out = os.path.join(work, bank)
        flags = [o for o in opts if o.startswith("--")]
        args = arg_parser().parse_args(
            ["--cfg", UCF_YAML, "--output", run_out, "--device", "cuda",
             "--gpu", "0"] + flags
            + ["DATASET.VID_PATH", jpg, "DATASET.ANNOTATION_PATH", ann_val,
               "DATASET.OPTICAL_U_PATH", flow, "TRAIN.EPOCHS", "1",
               "TRAIN.RETRIEVAL_INTERVAL", "1"]
            + [o for o in opts if not o.startswith("--")])
        torch.cuda.set_device(0)
        parallel.initialize_distributed(
            f"tcp://127.0.0.1:{parallel.free_port()}", 1, 0, backend="nccl",
            timeout=timedelta(seconds=300))
        t0 = time.perf_counter()
        try:
            cfg, _, _ = online_train._run(args)
        finally:
            parallel.destroy()
        wall = time.perf_counter() - t0
        logs = os.path.join(run_out, "tnet_checkpoints")
        with open(os.path.join(logs, "train_loss_and_acc.txt")) as f:
            losses = [float(ln.split()[-1]) for ln in f.read().splitlines()]
        check(len(losses) == 1 and np.isfinite(losses[0]),
              f"dist CLI ({bank}): one epoch, a finite loss")
        saved = torch.load(os.path.join(logs, cfg.MODEL.ARCH,
                                        "checkpoint.pth.tar"),
                           map_location="cpu", weights_only=False)
        check(saved["epoch"] == 1 and set(saved.get("banks", {})) == {bank},
              f"dist CLI ({bank}): the checkpoint holds epoch 1 and the "
              "bank")
        out[bank] = {"wall_s": wall, "train_loss": losses}
        if "--iterative_cluster" in flags:
            with open(os.path.join(logs, "NMIs.txt")) as f:
                out[bank]["nmi"] = f.read().split()
            with open(os.path.join(run_out, "vid_clusters.txt")) as f:
                n_labels = len(f.read().split())
            n_train = NCE_CLI_CLASSES * (SYN["videos_per_class"] - 1)
            check(len(out[bank]["nmi"]) == 1 and n_labels == n_train,
                  f"dist CLI ({bank}): clustered once, {n_labels} labels")
    return out


def phase_dist(smi: str, paths):
    """Data-parallel pretrain (``parallel``) on the one card: DIST_WORLD
    gloo ranks (all_reduce / broadcast on CUDA tensors; NCCL refuses two
    ranks on one GPU) each take their rows of the global batch. (a) Their
    fp32 step of 4 anchors is held to the 1-rank step of the global batch
    on the card and to its fp64 run: parameters bit-identical across
    ranks, the same loss, negatives and n_triplets, the update and the
    BatchNorm statistics within 3x the 1-rank fp32's distance from fp64;
    (b) ms a bf16 step of train_step's 96 clips at world 2 beside 1 rank
    and beside a world-1 NCCL group (the synced BatchNorm, the gathers and
    the gradient all-reduce on one rank): a check of the path, not a
    scaling number (one card shared, loopback gloo, ~135 MB of R3D-18
    gradients a step through the host); (c) each rank's FINCH over a
    24,000 x 128 bank launches nn1_cosine once and its labels are equal
    across ranks; (d) ``dist_cli``: the training CLI in a world-1 NCCL
    group with the MEM_TRIPLET and UberNCE banks."""
    from datetime import timedelta

    import torch

    from video_similarity_search_tpu_torch import parallel

    torch.cuda.empty_cache()
    ref = {"fp32": dist_fp32_step(0, 1),
           "fp64": dist_fp32_step(0, 1, torch.float64)}
    one_rank = dist_step_ms(0, 1)
    ranks = run_ranks(DIST_WORLD)
    torch.cuda.set_device(0)
    parallel.initialize_distributed(
        f"tcp://127.0.0.1:{parallel.free_port()}", 1, 0, backend="nccl",
        timeout=timedelta(seconds=300))
    try:
        nccl = dist_step_ms(0, 1)
    finally:
        parallel.destroy()
    cli = dist_cli(paths)

    w, one, r64 = ranks[0]["fp32"], ref["fp32"], ref["fp64"]
    init = {k: v.double() for k, v in dist_init(dist_cfg()).items()}
    same = all(torch.equal(ranks[0]["fp32"]["sd"][k], r["fp32"]["sd"][k])
               for r in ranks[1:] for k in w["sd"])
    out = {
        "world": DIST_WORLD, "backend": "gloo", "check_anchors":
        DIST_CHECK_ANCHORS,
        "params_bit_identical_across_ranks": same,
        "loss_world": w["loss"], "loss_one_rank": one["loss"],
        "loss_fp64": r64["loss"],
        "loss_rel_diff": abs(w["loss"] - one["loss"]) / abs(one["loss"]),
        "negatives_equal": bool(torch.equal(w["neg"], one["neg"])),
        "n_triplets": [w["n"], one["n"]],
        "update_rel_err_world_vs_fp64": update_rel_err(w["sd"], r64["sd"],
                                                       init),
        "update_rel_err_one_rank_vs_fp64": update_rel_err(one["sd"],
                                                          r64["sd"], init),
        "update_rel_err_world_vs_one_rank": update_rel_err(w["sd"],
                                                           one["sd"], init),
        "bn_stat_max_abs_diff_world_vs_fp64": max_state_diff(
            w["sd"], r64["sd"], True),
        "bn_stat_max_abs_diff_one_rank_vs_fp64": max_state_diff(
            one["sd"], r64["sd"], True),
        "bf16_step_ms": {"one_rank": one_rank["step_ms"],
                         "world_2_gloo_per_rank": [r["bf16"]["step_ms"]
                                                   for r in ranks],
                         "world_1_nccl": nccl["step_ms"]},
        "bf16_step_ms_all": {"one_rank": one_rank["step_ms_all"],
                             "world_2_gloo_rank0":
                             ranks[0]["bf16"]["step_ms_all"],
                             "world_1_nccl": nccl["step_ms_all"]},
        "bf16_losses": {"one_rank": one_rank["losses"],
                        "world_2_gloo": ranks[0]["bf16"]["losses"],
                        "world_1_nccl": nccl["losses"]},
        "clips_per_step": one_rank["clips_per_step"],
        "timing_note": "a check of the path, not a scaling number: both "
                       "ranks share one card and all-reduce ~135 MB of "
                       "R3D-18 gradients a step over loopback gloo",
        "cluster_bank": [DIST_BANK, 128],
        "cluster_s_per_rank": [r["cluster_s"] for r in ranks],
        "nn1_cosine_launches_per_rank": [r["launches"] for r in ranks],
        "cluster_labels_equal_across_ranks": all(
            np.array_equal(ranks[0]["labels"], r["labels"])
            for r in ranks[1:]),
        "n_clusters": int(len(np.unique(ranks[0]["labels"]))),
        "cli_world_1_nccl": cli,
        "nvidia_smi": smi}
    emit("dist", **out)
    check(same, "dist: parameters and statistics bit-identical across ranks")
    check(out["loss_rel_diff"] <= 1e-4, "dist: the world-2 fp32 loss equals "
          f"the 1-rank loss within 1e-4 relative ({out['loss_rel_diff']})")
    check(out["negatives_equal"] and w["n"] == one["n"] > 0,
          "dist: the same mined negatives and n_triplets as 1 rank")
    err, err_one = (out["update_rel_err_world_vs_fp64"],
                    out["update_rel_err_one_rank_vs_fp64"])
    check(err <= 3 * err_one + 1e-5, f"dist: the world-2 update is within "
          f"{err} of fp64's, the 1-rank fp32 update within {err_one}")
    bn, bn_one = (out["bn_stat_max_abs_diff_world_vs_fp64"][0],
                  out["bn_stat_max_abs_diff_one_rank_vs_fp64"][0])
    check(bn <= 3 * bn_one + 1e-6, f"dist: the world-2 BatchNorm statistics "
          f"are within {bn} of fp64's, the 1-rank fp32 ones within {bn_one}")
    for name, losses in out["bf16_losses"].items():
        check(all(np.isfinite(losses)), f"dist: finite bf16 losses ({name})")
    check(out["nn1_cosine_launches_per_rank"] == [1] * DIST_WORLD,
          "dist: each rank's FINCH over 24,000 rows launches nn1_cosine once")
    check(out["cluster_labels_equal_across_ranks"],
          "dist: the ranks' cluster labels are equal")
    return out["nn1_cosine_launches_per_rank"]


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
    stem_rows = run("stem", phase_stem, smi, sass)
    wgrad_row = run("stem_wgrad", phase_stem_wgrad, smi, sass)
    model, cfg, emb4096, cache, embed_launches = run("embed", phase_embed)
    finch_launches = run("cluster", phase_cluster, bank, bank_lbl, emb4096)
    run("retrieval", phase_retrieval, model, cfg, cache, bank)
    check(fused_knn.LAUNCHES == 0, "retrieval launches no 1-NN kernel")
    backend = run("host", phase_host)
    ucf, paths, train_loader, train_ds = run("data", phase_data, backend)
    ucf_model, emb = run("embed_loader", phase_embed_loader, ucf,
                         train_loader, backend)
    run("cluster_step", phase_cluster_step, ucf, ucf_model, train_loader,
        train_ds, backend)
    run("kmeans", phase_kmeans, bank, bank_lbl, ucf, ucf_model, train_loader,
        train_ds)
    del bank, bank_lbl
    run("cli", phase_cli, ucf, paths, ucf_model, emb)
    del ucf_model, train_loader
    step_rate, step_launches = run("train_step", phase_train_step)
    run("train_cli", phase_train_cli, paths, step_rate)
    tools_launches = run("tools", phase_tools, paths)
    run("train_options", phase_train_options)
    run("contrastive", phase_contrastive, paths)
    fused_knn.LAUNCHES = 0
    cls_rates, cls_wgrad_launches = run("classify_step", phase_classify_step,
                                        smi)
    check(fused_knn.LAUNCHES == 0, "the classifier step launches no 1-NN "
          "kernel")
    run("classify_cli", phase_classify_cli, cls_rates)
    lmdb_launches = run("lmdb", phase_lmdb, cls_rates)
    iic_launches = run("iic", phase_iic, smi)
    run("slowfast", phase_slowfast, smi)
    moco_wgrad_launches = run("moco", phase_moco, paths)
    dist_launches = run("dist", phase_dist, smi, paths)
    emit("timing", seconds=seconds, total_s=sum(seconds.values()),
         notes="the data phase reads 3 epochs of the eval train loader "
               "(5 before the train_step and train_cli phases); train_cli "
               "trains 1 epoch and a resumed second (2 and a third before "
               "the slice-5 phases) on 20 of the synthetic set's 40 "
               "classes, the "
               "contrastive CLI on 10; classify_cli writes its own "
               "20-class set of 64-frame videos")

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
        "shape": main_shape["shape"], "shapes": shapes,
        "dist_launches_per_rank": dist_launches,
        "lmdb_launches": lmdb_launches, "iic_launches": iic_launches,
        "tools_launches": tools_launches}, {
        "name": "stem_conv3d", "route": "cuda",
        "source": KERNELS["stem_conv3d"][0],
        "replaces": KERNELS["stem_conv3d"][1],
        "launches": {"embed": embed_launches,
                     f"train_step ({TIMED_STEPS} steps)": step_launches},
        "ms": stem_rows[-1]["ms"],
        "plain_ms": stem_rows[-1]["plain_ms"],
        "bound_ms": stem_rows[-1]["bound_ms"],
        "bound_by": stem_rows[-1]["bound_by"],
        "library_ms": stem_rows[-1]["library_ms"],
        "max_abs_err": max(r["max_abs_err"] for r in stem_rows),
        "sass": key_opcodes(sass["stem_conv3d"]),
        "shape": stem_rows[-1]["shape"], "shapes": stem_rows}, {
        "name": "stem_wgrad_f32", "route": "cuda",
        "source": KERNELS["stem_wgrad_f32"][0],
        "replaces": KERNELS["stem_wgrad_f32"][1],
        "launches": {f"moco ({TIMED_STEPS} steps)": moco_wgrad_launches,
                     f"classify_step ({TIMED_STEPS} steps)":
                     cls_wgrad_launches}, "ms": wgrad_row["ms"],
        "plain_ms": wgrad_row["plain_ms"],
        "bound_ms": wgrad_row["bound_ms"],
        "bound_by": wgrad_row["bound_by"],
        "library_ms": wgrad_row["library_ms"],
        "err_vs_fp64": wgrad_row["err_vs_fp64"],
        "cudnn_err_vs_fp64": wgrad_row["cudnn_err_vs_fp64"],
        "sass": wgrad_row["sass"], "shape": wgrad_row["shape"]}]}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
