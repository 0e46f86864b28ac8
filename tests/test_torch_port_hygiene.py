"""Rules the PyTorch port keeps: no JAX anywhere in it (its ``parallel``
package included) or in chip_smoke.py, no scikit-learn or matplotlib
either (the card's machine has neither), no silent fall back to the CPU (the
serving, clustering, training, contrastive, MoCo and classification entry
points alike) nor to one process (a training launch over several ranks
whose rendezvous fails raises within its timeout), its own copy of the
native decoder, and (on a CUDA machine only) the CUDA 1-NN kernel agrees
with its plain version, the pinned side-stream upload delivers the host
batches, the triplet and MoCo steps on the card equal the steps on the
CPU, and a world-1 NCCL step equals the step with no process group."""

import argparse
import ast
import os
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "video_similarity_search_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "video_similarity_search_tpu")
HOST_ONLY = ("sklearn", "matplotlib")  # absent on the card's machine


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


def test_port_and_chip_smoke_import_no_sklearn_or_matplotlib():
    """chip_smoke.py's host phase probes for both packages by name, without
    importing them."""
    files = _port_sources()
    assert len(files) > 20
    bad = [(os.path.relpath(f, ROOT), m) for f in files
           for m in _imported_roots(f) if m in HOST_ONLY]
    assert not bad, f"scikit-learn / matplotlib imports in the port: {bad}"


def test_parallel_package_imports_no_jax():
    files = [f for f in _port_sources()
             if os.sep + "parallel" + os.sep in f]
    assert {os.path.basename(f) for f in files} >= {"__init__.py", "dist.py"}
    bad = [(os.path.relpath(f, ROOT), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN]
    assert not bad, f"JAX-side imports in the port's parallel package: {bad}"


def test_num_shards_with_an_unreachable_rendezvous_raises(monkeypatch,
                                                          tmp_path):
    """``--num_shards 2 --shard_id 1`` against a localhost port where no
    rank 0 listens: the CLI raises within the rendezvous timeout (cut to 5
    s here) instead of training alone."""
    from datetime import timedelta

    from video_similarity_search_tpu_torch import parallel
    from video_similarity_search_tpu_torch.cli import online_train
    from video_similarity_search_tpu_torch.parallel import dist as pdist

    port = parallel.free_port()  # nobody listens on it
    monkeypatch.setattr(pdist, "DEFAULT_TIMEOUT", timedelta(seconds=5))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rendezvous .* failed"):
        online_train.main(["--num_shards", "2", "--shard_id", "1",
                           "--ip_address_port", f"tcp://127.0.0.1:{port}",
                           "--device", "cpu", "--output", str(tmp_path)])
    assert time.monotonic() - t0 < 60
    assert not parallel.is_active()
    assert not os.listdir(tmp_path)  # it trained nothing


def test_entry_points_without_device_raise_on_a_box_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    from video_similarity_search_tpu_torch.cluster import (FINCH, fit_cluster,
                                                           kmeans)
    from video_similarity_search_tpu_torch.evaluation import (
        get_embeddings_and_labels, topk_retrieval_acc)
    x = np.random.default_rng(0).normal(size=(8, 4)).astype(np.float32)
    y = np.zeros(8, np.int64)
    from video_similarity_search_tpu_torch.cli import evaluate
    from video_similarity_search_tpu_torch.config import get_cfg
    from video_similarity_search_tpu_torch.data import (PrefetchLoader,
                                                        build_data_loader,
                                                        collate_videos)
    from video_similarity_search_tpu_torch.cli import (coclr_classify,
                                                       online_train)
    from video_similarity_search_tpu_torch.evaluation import (
        plot_exemplar_retrievals, temporal_heat_map, test_10crop,
        test_retrieval, tsne_plot, validate)
    from video_similarity_search_tpu_torch.cli import tsne as tsne_cli
    from video_similarity_search_tpu_torch.models import (LinearClassifier,
                                                          model_selector)
    from video_similarity_search_tpu_torch.train import (
        make_classify_optimizer, make_classify_train_step, make_lr_schedule,
        make_optimizer, make_triplet_train_step)
    from video_similarity_search_tpu_torch.train.driver import (
        iterative_cluster_step, train)
    from video_similarity_search_tpu_torch.train.steps import (
        make_banks, make_contrastive_train_step, make_moco_train_step)
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs",
                                     "resnet_ucf_itercluster_flow.yaml"))
    assert cfg.TPU.PREFETCH_DEVICE_PUT  # the config asks for the upload
    calls = [lambda: FINCH(x, verbose=False),
             lambda: fit_cluster(x, method="finch", verbose=False),
             lambda: fit_cluster(x, method="kmeans", k=2, verbose=False),
             lambda: fit_cluster(x, method="spherical_kmeans", k=2,
                                 verbose=False),
             lambda: kmeans(x, 2),
             lambda: topk_retrieval_acc(x, y, x, y),
             lambda: get_embeddings_and_labels(None, None, []),
             lambda: iterative_cluster_step(None, cfg, []),
             lambda: PrefetchLoader([], 4, shuffle=False, drop_last=False,
                                    collate=collate_videos,
                                    device_upload=True),
             lambda: build_data_loader("train", cfg, triplets=False),
             lambda: evaluate.main([
                 "--cfg", os.path.join(ROOT, "configs",
                                       "resnet_ucf_itercluster_flow.yaml")]),
             lambda: online_train.main([
                 "--cfg", os.path.join(ROOT, "configs",
                                       "resnet_ucf_itercluster_flow.yaml"),
                 "--iterative_cluster"]),
             lambda: train(argparse.Namespace(), cfg),
             lambda: make_triplet_train_step(cfg, model, *opt),
             lambda: make_contrastive_train_step(nce_cfg, model, *opt,
                                                 make_banks(nce_cfg, 8)["nce"]),
             lambda: train(argparse.Namespace(), nce_cfg),
             lambda: make_moco_train_step(moco_cfg, moco, *moco_opt,
                                          make_banks(moco_cfg, 8,
                                                     moco)["moco"]),
             lambda: train(argparse.Namespace(), moco_cfg),
             lambda: validate(model, cfg, []),
             lambda: coclr_classify.main([]),
             lambda: make_classify_train_step(s3d_cfg, classifier, *cls_opt),
             lambda: test_10crop(classifier, s3d_cfg, []),
             lambda: test_retrieval(classifier, s3d_cfg, [], []),
             lambda: fit_cluster(x, method="Agglomerative", verbose=False),
             lambda: fit_cluster(x, method="DBSCAN", verbose=False),
             lambda: fit_cluster(x, method="OPTICS", verbose=False),
             lambda: tsne_plot(x, y),
             lambda: temporal_heat_map(model, cfg, None, exemplar_idx=0,
                                       test_idx=1),
             lambda: plot_exemplar_retrievals(x, x, [{}], [{}], "x.png"),
             lambda: tsne_cli.main([
                 "--cfg", os.path.join(ROOT, "configs",
                                       "resnet_ucf_itercluster_flow.yaml")])]
    model = model_selector(cfg)
    opt = make_optimizer(cfg, model.parameters())
    nce_cfg = cfg.clone()
    nce_cfg.LOSS.TYPE = "contrastive"
    moco_cfg = cfg.clone()
    moco_cfg.MODEL.ARCH, moco_cfg.LOSS.TYPE = "uber_nce", "UberNCE"
    moco = model_selector(moco_cfg)
    moco_opt = make_optimizer(moco_cfg, moco.parameters())
    s3d_cfg = get_cfg()
    s3d_cfg.MODEL.ARCH = "s3d"
    classifier = LinearClassifier(num_class=5)
    cls_opt = make_classify_optimizer(
        classifier, "last", make_lr_schedule(1e-3, 1, [], False, 1), 1e-3)
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_native_decoder_is_the_ports_own_copy():
    from video_similarity_search_tpu_torch.data import native_loader
    jax_src = os.path.join(ROOT, "video_similarity_search_tpu", "native",
                           "vss_loader.cpp")
    assert os.path.dirname(native_loader.SRC) == os.path.join(PORT, "native")
    with open(native_loader.SRC, "rb") as f, open(jax_src, "rb") as g:
        assert f.read() == g.read()  # copied unchanged
    assert native_loader.BUILD_DIR.startswith(PORT + os.sep)
    assert native_loader.library_path().startswith(
        native_loader.BUILD_DIR + os.sep)
    if native_loader.available():  # the library mapped is the port's build
        assert native_loader.LIB_PATH.startswith(
            native_loader.BUILD_DIR + os.sep)
        with open("/proc/self/maps") as f:
            mapped = {ln.split()[-1] for ln in f if "libvss_loader" in ln}
        assert native_loader.LIB_PATH in mapped


@pytest.mark.gpu
def test_nn1_cosine_kernel_matches_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from video_similarity_search_tpu_torch.ops import fused_knn
    from video_similarity_search_tpu_torch.ops.pdist import (l2_normalize,
                                                              nearest_neighbor)
    rng = np.random.default_rng(0)
    # D=20 takes the padding to the kernel's 32-wide chunk; D=256 streams
    # the query rows through the ring instead of keeping them resident
    for m, n, d, self_q in [(37, 37, 16, True), (37, 53, 16, False),
                            (1000, 1000, 128, True), (37, 53, 20, False),
                            (300, 300, 256, True)]:
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


@pytest.mark.gpu
def test_pinned_side_stream_upload_delivers_the_host_batches():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the upload copies to the card")
    from video_similarity_search_tpu_torch.data import (PrefetchLoader,
                                                        collate_triplets,
                                                        collate_videos)
    from video_similarity_search_tpu_torch.evaluation.embed import _pad_clips

    class Videos:  # 1-4 windows a video: ragged multi-window test batches
        def __len__(self):
            return 11

        def __getitem__(self, i):
            rng = np.random.default_rng(i)
            w = 1 + i % 4
            return {"clip": rng.integers(0, 256, (w, 4, 32, 32, 3), np.uint8),
                    "target": i % 3, "index": i}

    class Triplets:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            rng = np.random.default_rng(100 + i)
            clip = lambda: rng.integers(0, 256, (8, 32, 32, 3), np.uint8)  # noqa: E731
            return {"anchor": clip(), "positive": clip(), "extra": clip(),
                    "targets": (i, i + 1), "index": i}

    for ds, collate, bs, accum in ((Videos(), collate_videos, 3, 1),
                                   (Triplets(), collate_triplets, 4, 1),
                                   (Triplets(), collate_triplets, 4, 2)):
        kw = dict(shuffle=False, drop_last=False, collate=collate,
                  num_workers=2, prefetch_depth=1)
        host = list(PrefetchLoader(ds, bs, **kw))
        up = PrefetchLoader(ds, bs, device_upload=True, **kw)
        up.upload_microbatch = accum
        for _ in range(2):  # the second pass refills the pinned ring
            dev = list(up)
            assert len(dev) == len(host)
            for h, d in zip(host, dev):
                assert h.keys() == d.keys()
                for k, v in h.items():
                    if isinstance(v, np.ndarray) and v.nbytes >= 1 << 16:
                        assert d[k].is_cuda
                        want = torch.from_numpy(v)
                        if accum > 1 and v.ndim >= 4:
                            want = want.reshape(accum, -1, *v.shape[1:])
                        assert torch.equal(d[k].cpu(), want), k
                    else:  # small leaves stay on the host
                        np.testing.assert_array_equal(np.asarray(d[k]), v)
        assert len(up.copy_events) == len(host)
    # the embedding pass takes an uploaded batch without copying it again
    clips = dev[0]["anchor"]  # (2, 2, 8, 32, 32, 3): 4 x 24 KiB uploaded
    assert clips.is_cuda
    same = torch.as_tensor(clips).to(torch.device("cuda"))
    assert same.data_ptr() == clips.data_ptr()
    padded, n = _pad_clips(clips, clips.shape[0])
    assert padded is clips and n == clips.shape[0]


@pytest.mark.gpu
def test_triplet_step_on_the_card_matches_the_cpu():
    """One fp32 step on the card and on the CPU from the same weights,
    augmentation draws and Gumbel draws: the same loss (1e-4 relative) and
    negatives, and parameter updates within 1e-2 (relative) of an fp64 CPU
    step's. cuDNN's fp32 convolutions sum in other orders than the CPU's
    (their update sits ~100x further from fp64 on this net, whose stem
    weight gradient cancels heavily); TF32 convolutions, run here as the
    control, land beyond the bar."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the step runs on the card")
    from video_similarity_search_tpu_torch.config import get_cfg
    from video_similarity_search_tpu_torch.data.augment import train_augment
    from video_similarity_search_tpu_torch.losses.triplet import gumbel
    from video_similarity_search_tpu_torch.models import model_selector
    from video_similarity_search_tpu_torch.train import (
        make_optimizer, make_triplet_train_step)
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.ARCH", "3dresnet", "RESNET.MODEL_DEPTH", 10,
                         "RESNET.NO_MAX_POOl", True, "RESNET.HIDDEN_LAYER",
                         32, "RESNET.OUT_DIM", 8, "DATA.SAMPLE_DURATION", 4,
                         "DATA.SAMPLE_SIZE", 32, "TPU.COMPUTE_DTYPE",
                         "float32", "LOSS.LOCAL_LOCAL_CONTRAST", True,
                         "DATASET.SAMPLING_STRATEGY", "random_semi_hard",
                         "OPTIM.LR", 0.1])
    torch.manual_seed(0)
    init = model_selector(cfg).state_dict()
    rng = np.random.default_rng(0)
    clips = {k: torch.from_numpy(rng.integers(0, 256, (4, 4, 40, 40, 3),
                                              np.uint8))
             for k in ("anchor", "positive", "extra")}
    noise = gumbel(torch.Generator().manual_seed(1), (8, 8, 8))
    out = {}
    for name, dev, dtype in (("cpu", "cpu", torch.float32),
                             ("cpu64", "cpu", torch.float64),
                             ("cuda", "cuda", torch.float32),
                             ("cuda_tf32", "cuda", torch.float32)):
        model = model_selector(cfg)
        model.load_state_dict(init)
        step = make_triplet_train_step(cfg, model,
                                       *make_optimizer(cfg, model.parameters()),
                                       device=dev)
        model.to(dtype)
        gen = torch.Generator().manual_seed(2)  # augmentation draws on the CPU
        batch = {k: train_augment(v, gen, 32).to(dev, dtype)
                 for k, v in clips.items()}
        batch["targets"] = torch.tensor([0, 0, 1, 1] * 2, device=dev)
        torch.backends.cudnn.allow_tf32 = name == "cuda_tf32"
        try:
            met = step(batch, noise=noise.to(dev))
        finally:
            torch.backends.cudnn.allow_tf32 = False
        out[name] = (float(met["loss"]), met["negatives"].cpu(),
                     {k: v.detach().cpu().double()
                      for k, v in model.state_dict().items()})

    def update_err(name):
        num = den = 0.0
        for k, p in init.items():
            if k.endswith(("running_mean", "running_var",
                           "num_batches_tracked")):
                continue
            u = out[name][2][k] - p.double()
            ref = out["cpu64"][2][k] - p.double()
            num += float(((u - ref) ** 2).sum())
            den += float((ref ** 2).sum())
        return (num / den) ** 0.5

    errs = {k: update_err(k) for k in ("cpu", "cuda", "cuda_tf32")}
    print("fp32 update, relative distance from fp64:", errs)
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    assert errs["cpu"] <= 1e-3 and errs["cuda"] <= 1e-2 < errs["cuda_tf32"]


@pytest.mark.gpu
def test_moco_step_on_the_card_matches_the_cpu():
    """One fp32 UberNCE step (S3D, 4 anchors of 32x64x64, K 8) on the card
    from the same weights, queue and batch as on the CPU, held to an fp64
    run on the card: the loss within 1e-4 relative, the pointer and labels
    equal (and equal to the CPU's), the enqueued keys within 1e-3, and the
    query and key parameters' update no further from the card's fp64
    update than 3x the CPU's fp32 update is from the CPU's fp64 one
    (chip_smoke.py's bar). The size: in train mode each BatchNorm
    normalizes a channel over batch x T' x H' x W' values, at 8x32x32
    only 4 in S3D's Mixed_5 blocks, and there the fp32 update follows each
    device's summation order (the card's sits ~75x further from fp64 than
    the CPU's while the two fp64 runs agree; ``utils/moco_precision.py``
    sweeps the sizes). 32x64x64, 64 values a channel, is the smallest of
    the swept sizes where every bar holds with room: from 8 values on the
    card's update sits within 1.5x of the CPU's, and at 16x64x64 the loss
    came within 2% of its bar. One step: at random init S3D amplifies the
    first update's rounding ~1e5 fold in the second
    (tests/test_torch_port_moco.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the step runs on the card")
    from video_similarity_search_tpu_torch.models import model_selector
    from video_similarity_search_tpu_torch.utils import moco_precision as mp

    assert mp.bn_values_per_channel(model_selector(mp.moco_cfg()),
                                    32, 64, 4) == 64
    init, out = mp.moco_step_runs(32, 64, 4)
    errs = {k: mp.update_distance(init, out, k, k + "64")
            for k in ("cpu", "cuda")}
    print("fp32 MoCo update, relative distance from fp64 on its device:",
          errs, "card fp64 vs CPU fp64:",
          mp.update_distance(init, out, "cuda64", "cpu64"))
    loss, loss64 = out["cuda"][0], out["cuda64"][0]
    assert abs(loss - loss64) <= 1e-4 * abs(loss64)
    for k in ("bank.queue_ptr", "bank.queue_labels"):
        assert torch.equal(out["cuda"][1][k], out["cuda64"][1][k]), k
        assert torch.equal(out["cuda"][1][k], out["cpu"][1][k]), k
    assert float((out["cuda"][1]["bank.queue"]
                  - out["cuda64"][1]["bank.queue"]).abs().max()) <= 1e-3
    assert errs["cpu"] <= 0.05 and errs["cuda"] <= 3 * errs["cpu"] + 1e-5


@pytest.mark.gpu
def test_world_1_nccl_step_matches_the_step_without_a_group():
    """One fp32 triplet step on the card inside a world-1 NCCL group (the
    synced BatchNorm, the gathers and the gradient all-reduce all run)
    and without a group, from the same weights and draws: the same loss
    (1e-4 relative), negatives and n_triplets, BatchNorm statistics within
    1e-4 (relative above 1), and updates within 1e-4 of each other
    (relative; 4.8e-6 measured on an H100): the synced BatchNorm sums in
    another order than cuDNN's, and the stem's update sums terms that
    mostly cancel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the step runs on the card")
    from video_similarity_search_tpu_torch import parallel
    from video_similarity_search_tpu_torch.config import get_cfg
    from video_similarity_search_tpu_torch.data.augment import train_augment
    from video_similarity_search_tpu_torch.losses.triplet import gumbel
    from video_similarity_search_tpu_torch.models import model_selector
    from video_similarity_search_tpu_torch.train import (
        make_optimizer, make_triplet_train_step)
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.ARCH", "3dresnet", "RESNET.MODEL_DEPTH", 10,
                         "RESNET.NO_MAX_POOl", True, "RESNET.HIDDEN_LAYER",
                         32, "RESNET.OUT_DIM", 8, "DATA.SAMPLE_DURATION", 4,
                         "DATA.SAMPLE_SIZE", 32, "TPU.COMPUTE_DTYPE",
                         "float32", "LOSS.LOCAL_LOCAL_CONTRAST", True,
                         "DATASET.SAMPLING_STRATEGY", "random_semi_hard",
                         "OPTIM.LR", 0.1])
    torch.manual_seed(0)
    init = model_selector(cfg).state_dict()
    rng = np.random.default_rng(0)
    clips = {k: torch.from_numpy(rng.integers(0, 256, (4, 4, 40, 40, 3),
                                              np.uint8))
             for k in ("anchor", "positive", "extra")}
    noise = gumbel(torch.Generator().manual_seed(1), (8, 8, 8))
    gen = torch.Generator().manual_seed(2)
    batch = {k: train_augment(v, gen, 32).cuda() for k, v in clips.items()}
    batch["targets"] = torch.tensor([0, 0, 1, 1] * 2, device="cuda")
    port = parallel.free_port()
    out = {}
    for name in ("plain", "nccl"):
        model = model_selector(cfg)
        model.load_state_dict(init)
        step = make_triplet_train_step(cfg, model,
                                       *make_optimizer(cfg, model.parameters()),
                                       device="cuda")
        if name == "nccl":
            torch.cuda.set_device(0)
            parallel.initialize_distributed(f"tcp://127.0.0.1:{port}", 1, 0,
                                            backend="nccl")
        try:
            met = step(batch, noise=noise.cuda())
            out[name] = (float(met["loss"]), met["negatives"].cpu(),
                         int(met["n_triplets"]),
                         {k: v.detach().cpu().double()
                          for k, v in model.state_dict().items()})
        finally:
            parallel.destroy()
    (lp, negp, np_, sdp), (ln, negn, nn_, sdn) = out["plain"], out["nccl"]
    assert abs(ln - lp) <= 1e-4 * abs(lp)
    assert torch.equal(negn, negp) and nn_ == np_ > 0
    num = den = 0.0
    for k, p in init.items():
        if k.endswith(("running_mean", "running_var")):
            scale = max(1.0, float(sdp[k].abs().max()))
            assert float((sdn[k] - sdp[k]).abs().max()) <= 1e-4 * scale, k
        elif not k.endswith("num_batches_tracked"):
            num += float(((sdn[k] - sdp[k]) ** 2).sum())
            den += float(((sdp[k] - p.double()) ** 2).sum())
    print("world-1 NCCL update, relative distance from the plain step:",
          (num / den) ** 0.5)
    assert (num / den) ** 0.5 <= 1e-4


NCCL_CLI_MODEL = {
    "r3d": ("MODEL:\n  ARCH: 3dresnet\nRESNET:\n  MODEL_DEPTH: 10\n"
            "  NO_MAX_POOl: true\n  HIDDEN_LAYER: 32\n  OUT_DIM: 8\n"
            "DATA:\n  SAMPLE_SIZE: 32\n  SAMPLE_DURATION: 4\n"),
    "s3d": ("MODEL:\n  ARCH: uber_nce\n"
            "DATA:\n  SAMPLE_SIZE: 32\n  SAMPLE_DURATION: 8\n")}
NCCL_CLI_LOSS = {  # the driver's loss-side banks, by checkpoint name
    "mem_triplet": ("r3d", "LOSS:\n  MEM_TRIPLET: true\n  MEM_TRIPLET_K: 16\n"
                           "DATASET:\n  SAMPLING_STRATEGY: random_negative\n"),
    "nce": ("r3d", "LOSS:\n  TYPE: contrastive\n  K: 6\n  FEAT_DIM: 8\n"
                   "  INTRA_NEGATIVE: true\n"),
    "memory_moco": ("r3d", "LOSS:\n  TYPE: contrastive\n  K: 8\n"
                           "  FEAT_DIM: 8\n  MOCO: true\n"),
    "moco": ("s3d", "LOSS:\n  TYPE: UberNCE\n  K: 8\n")}


@pytest.mark.gpu
@pytest.mark.parametrize("bank", sorted(NCCL_CLI_LOSS))
def test_world_1_nccl_training_cli_with_a_bank(bank, tmp_path):
    """The training CLI's ``_run`` on card 0 inside a world-1 NCCL group,
    for each kind of loss-side bank: the driver's broadcast of the model
    and the bank, its checkpoint agreement, the synced BatchNorm and the
    steps' gathers all go through NCCL, which takes CUDA tensors only. An
    epoch ends with a finite loss and a checkpoint that holds the bank."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: NCCL runs on the card")
    import sys

    from video_similarity_search_tpu_torch import parallel
    from video_similarity_search_tpu_torch.cli import online_train
    from video_similarity_search_tpu_torch.config import arg_parser

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from synthetic_data import make_synthetic_ucf

    vid, ann = make_synthetic_ucf(str(tmp_path / "data"))
    model, loss = NCCL_CLI_LOSS[bank]
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(
        NCCL_CLI_MODEL[model] + loss
        + "TRAIN:\n  DATASET: ucf101\n  BATCH_SIZE: 4\n  EPOCHS: 1\n"
        "  NUM_DATA_WORKERS: 2\n  LOG_INTERVAL: 100\n"
        "  RETRIEVAL_INTERVAL: 1\nVAL:\n  BATCH_SIZE: 4\n"
        "OPTIM:\n  LR: 0.01\nTPU:\n  COMPUTE_DTYPE: float32\n")
    out = str(tmp_path / "out")
    args = arg_parser().parse_args(
        ["--cfg", str(cfg_path), "--output", out, "--device", "cuda",
         "--gpu", "0", "DATASET.VID_PATH", vid,
         "DATASET.ANNOTATION_PATH", ann])
    torch.cuda.set_device(0)
    parallel.initialize_distributed(f"tcp://127.0.0.1:{parallel.free_port()}",
                                    1, 0, backend="nccl")
    try:
        cfg, _, _ = online_train._run(args)
    finally:
        parallel.destroy()
    logs = os.path.join(out, "tnet_checkpoints")
    with open(os.path.join(logs, "train_loss_and_acc.txt")) as f:
        lines = f.read().splitlines()
    assert len(lines) == 1 and np.isfinite(float(lines[0].split()[-1]))
    saved = torch.load(os.path.join(logs, cfg.MODEL.ARCH,
                                    "checkpoint.pth.tar"),
                       map_location="cpu", weights_only=False)
    assert saved["epoch"] == 1 and set(saved["banks"]) == {bank}
