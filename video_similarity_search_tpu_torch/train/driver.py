"""Self-supervised pretrain driver on one device (port of the JAX package's
``train/driver.py``; reference ``online_train.train``,
online_train.py:441-776).

Per epoch:
  * every ITERCLUSTER.INTERVAL epochs after WARMUP_EPOCHS: embed the whole
    train set, cluster it, log NMI/AMI against the true labels, optionally
    set the positive sampling p to 1 - NMI, write ``vid_clusters.txt`` and
    rebuild the triplet loader on the pseudo-labels
    (``iterative_cluster_step``, reference online_train.py:599-667);
  * the triplet, contrastive or UberNCE (MoCo) epoch (``LOSS.TYPE``):
    device augmentation, one train step a batch (``train/steps.py``),
    metrics read on the host only at log points;
  * validation, retrieval every TRAIN.RETRIEVAL_INTERVAL epochs (it
    decides ``is_best``), and checkpoints, with ``--vector``'s
    every-epoch copy at the stable ``--checkpoint_path`` root.

The random draws (augmentation, triplet mining, NCE negatives, shuffled
views) come from one ``torch.Generator`` on the device, reseeded per step
from 1234 (the JAX driver's ``base_key``), the epoch and the batch index,
so a resumed run draws what an uninterrupted one would. Its stream is not
``jax.random``'s (ROADMAP hazard H2): the two packages train on different
draws. The loss-side banks (``LOSS.MEM_TRIPLET``, the NCE banks, the
MemoryMoCo queue, UberNCE's ``moco`` key encoder and queue) are saved with
each checkpoint and restored on resume.

Not ported: more than one device (``--num_shards > 1``, a TPU.MESH_SHAPE
over several devices; ROADMAP item 10) raises ``NotImplementedError``.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..cluster import fit_cluster
from ..data import build_data_loader, write_cluster_labels
from ..data.augment import normalize_only, train_augment
from ..evaluation import get_embeddings_and_labels, validate
from ..evaluation.knn import k_nearest_embeddings
from ..utils.cluster_metrics import (adjusted_mutual_info,
                                     normalized_mutual_info)
from ..utils.device import resolve_device
from ..utils.meters import AverageMeter, append_metric_line
from ..utils.metrics_sink import MetricsSink
from ..utils.profiling import StepProfiler, Throughput

BASE_SEED = 1234  # the JAX driver's jax.random.key(1234)
CLIP_LEAVES = ("anchor", "positive", "extra", "negative")


def _microbatch_leaf(name: str, x, accum: int):
    """Host leaf (B, ...) -> (A, B/A, ...) for gradient accumulation.

    The triplet collate's ``targets`` is (2B,) laid out [anchor targets
    (B); positive targets (B)], so each microbatch keeps its own
    [anchors_a; positives_a] halves rather than a contiguous run. Leaves
    the loader already uploaded (reshaped to (A, B/A, ...) by its
    ``upload_microbatch``) pass through."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    if x.ndim == 0:
        return x
    if name == "targets" and x.shape[0] % (2 * accum) == 0:
        half = x.shape[0] // 2
        return (x.reshape((2, accum, half // accum) + x.shape[1:])
                .transpose(1, 0, 2).reshape((accum, -1) + x.shape[1:]))
    if x.shape[0] % accum != 0:
        raise ValueError(f"batch leaf {name!r} (dim0={x.shape[0]}) must "
                         f"divide TRAIN.ACCUM_STEPS={accum}")
    return x.reshape((accum, x.shape[0] // accum) + x.shape[1:])


def _to_device(x, dev: torch.device) -> torch.Tensor:
    """A loader leaf on ``dev``: an uploaded tensor stays where it is."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def _device_batch(batch, cfg, generator: Optional[torch.Generator],
                  train: bool, device, accum: int = 1) -> dict:
    """uint8 host (or uploaded) batch -> normalized device batch, the
    train clips augmented on the device. ``accum > 1``: clip leaves are
    (A, b, T, H, W, C), augmented per microbatch and restacked."""
    dev = resolve_device(device)
    dataset = cfg.TRAIN.DATASET
    pre_cropped = bool(cfg.TPU.HOST_RRC)
    size = cfg.DATA.SAMPLE_SIZE
    out = {}
    for name in [k for k in CLIP_LEAVES if k in batch]:
        leaf = batch[name]
        if accum > 1:
            leaf = _microbatch_leaf(name, leaf, accum)
        clips = _to_device(leaf, dev)
        if not train:
            out[name] = normalize_only(clips, dataset=dataset)
        elif accum > 1:
            out[name] = torch.stack([
                train_augment(clips[a], generator, size, dataset=dataset,
                              pre_cropped=pre_cropped)
                for a in range(accum)])
        else:
            out[name] = train_augment(clips, generator, size,
                                      dataset=dataset,
                                      pre_cropped=pre_cropped)
    for name in ("targets", "index"):
        if name in batch:
            leaf = batch[name]
            if accum > 1:
                leaf = _microbatch_leaf(name, leaf, accum)
            out[name] = _to_device(leaf, dev).long()
    return out


def step_seed(epoch: int, batch_idx: int) -> int:
    """The generator's seed for one step (the JAX driver folds
    ``epoch * 100000 + batch_idx`` into its base key)."""
    return BASE_SEED * 1_000_003 + epoch * 100000 + batch_idx


def _drain(pending, meter_updates) -> None:
    """Read deferred device metrics on the host. Reading each step would
    make the host wait for the card every step."""
    for metrics, bsz in pending:
        meter_updates(metrics, bsz)
    pending.clear()


def triplet_train_epoch(step_fn, train_loader, cfg, epoch: int,
                        generator: torch.Generator, is_master: bool = True,
                        sink=None, device="cuda") -> float:
    """One triplet epoch (reference online_train.py:245-434) -> mean
    loss."""
    losses = AverageMeter("loss")
    n_triplets = AverageMeter("n_triplets")
    start = time.time()
    profiler = StepProfiler(cfg.TPU.PROFILE_DIR if epoch == 0 else "")
    thru = Throughput()
    pending = []

    def update(metrics, bsz):
        losses.update(float(metrics["loss"]), bsz)
        n_triplets.update(float(metrics["n_triplets"]))

    accum = max(1, int(cfg.TRAIN.ACCUM_STEPS))
    for batch_idx, batch in enumerate(train_loader):
        profiler.step(batch_idx)
        generator.manual_seed(step_seed(epoch, batch_idx))
        dev_batch = _device_batch(batch, cfg, generator, train=True,
                                  device=device, accum=accum)
        metrics = step_fn(dev_batch, generator)
        pending.append((metrics, batch["__size__"]))
        thru.tick(batch["__size__"])
        if is_master and (batch_idx + 1) % cfg.TRAIN.LOG_INTERVAL == 0:
            _drain(pending, update)
            print(f"Train Epoch: {epoch} [{losses.count}]\t"
                  f"Loss: {losses.val:.4f} ({losses.avg:.4f})\t"
                  f"N_Triplets: {n_triplets.avg:.1f}\t"
                  f"{thru.items_per_sec:.1f} clips/s")
            if sink:
                it = epoch * len(train_loader) + batch_idx
                sink.add_scalar("train/loss", losses.val, it)
                sink.add_scalar("train/clips_per_sec", thru.items_per_sec,
                                it)
    _drain(pending, update)
    profiler.close()
    if is_master:
        runtime_h = (time.time() - start) / 3600
        print(f"\nTrain set: Average loss: {losses.avg:.4f} "
              f"({thru.items_per_sec:.1f} clips/s steady-state)")
        append_metric_line(cfg.OUTPUT_PATH, "train_loss_and_acc.txt",
                           f"epoch:{epoch} runtime:{round(runtime_h, 2)} "
                           f"{losses.avg:.4f}")
        if sink:
            sink.add_scalar("epoch/train_loss", losses.avg, epoch)
    return losses.avg


def contrastive_train_epoch(step_fn, train_loader, cfg, epoch: int,
                            generator: torch.Generator,
                            is_master: bool = True, sink=None,
                            device="cuda") -> float:
    """One contrastive (NCE) epoch (reference contrastive_train_epoch,
    online_train.py:136-225) -> mean loss. The two views are the triplet
    loader's anchor and positive clips; with ``DATASET.MODALITY`` other
    than ``rgb`` (the ``res`` rule of the JAX driver) the second view is
    the frame residual of the first, taken in the step, and the positive
    clip is dropped before its upload and augmentation."""
    modality = contrastive_modality(cfg)
    losses = AverageMeter("loss")
    v1_loss = AverageMeter("view1_loss")
    v2_loss = AverageMeter("view2_loss")
    start = time.time()
    thru = Throughput()
    pending = []

    def update(metrics, bsz):
        losses.update(float(metrics["loss"]), bsz)
        v1_loss.update(float(metrics["view1_loss"]), bsz)
        v2_loss.update(float(metrics["view2_loss"]), bsz)

    accum = max(1, int(cfg.TRAIN.ACCUM_STEPS))
    for batch_idx, batch in enumerate(train_loader):
        generator.manual_seed(step_seed(epoch, batch_idx))
        if modality == "res":
            batch = {k: v for k, v in batch.items() if k != "positive"}
        dev_batch = _device_batch(batch, cfg, generator, train=True,
                                  device=device, accum=accum)
        step_batch = {"view1": dev_batch["anchor"],
                      "index": dev_batch["index"]}
        if modality != "res":
            step_batch["view2"] = dev_batch["positive"]
        metrics = step_fn(step_batch, generator)
        pending.append((metrics, batch["__size__"]))
        thru.tick(batch["__size__"])
        if is_master and (batch_idx + 1) % cfg.TRAIN.LOG_INTERVAL == 0:
            _drain(pending, update)
            print(f"Train Epoch: {epoch} [{losses.count}]\t"
                  f"Loss: {losses.val:.4f} ({losses.avg:.4f})\t"
                  f"{thru.items_per_sec:.1f} clips/s")
            if sink:
                it = epoch * len(train_loader) + batch_idx
                sink.add_scalar("train/loss", losses.val, it)
                sink.add_scalar("train/view1_loss", v1_loss.val, it)
                sink.add_scalar("train/view2_loss", v2_loss.val, it)
    _drain(pending, update)
    if is_master:
        runtime_h = (time.time() - start) / 3600
        print(f"\nTrain set: Average loss: {losses.avg:.4f} "
              f"({thru.items_per_sec:.1f} clips/s steady-state)")
        append_metric_line(cfg.OUTPUT_PATH, "train_loss_and_acc.txt",
                           f"epoch:{epoch} runtime:{round(runtime_h, 2)} "
                           f"{losses.avg:.4f}")
        if sink:
            sink.add_scalar("epoch/train_loss", losses.avg, epoch)
    return losses.avg


def ubernce_train_epoch(step_fn, train_loader, cfg, epoch: int,
                        generator: torch.Generator, is_master: bool = True,
                        sink=None, device="cuda") -> float:
    """One MoCo InfoNCE / UberNCE epoch (reference UberNCE_train_epoch,
    online_train.py:60-133; the JAX ``ubernce_train_epoch``) -> mean loss.
    The triplet loader's anchor and positive clips, augmented on the
    device, are the two views ``x1`` / ``x2``; the anchors' targets are
    the labels."""
    losses = AverageMeter("loss")
    top1 = AverageMeter("top1")
    top5 = AverageMeter("top5")
    start = time.time()
    thru = Throughput()
    pending = []

    def update(metrics, bsz):
        losses.update(float(metrics["loss"]), bsz)
        top1.update(float(metrics["top1"]), bsz)
        top5.update(float(metrics["top5"]), bsz)

    for batch_idx, batch in enumerate(train_loader):
        generator.manual_seed(step_seed(epoch, batch_idx))
        dev_batch = _device_batch(batch, cfg, generator, train=True,
                                  device=device)
        b = dev_batch["anchor"].shape[0]
        metrics = step_fn({"x1": dev_batch["anchor"],
                           "x2": dev_batch["positive"],
                           "label": dev_batch["targets"][:b]}, generator)
        pending.append((metrics, batch["__size__"]))
        thru.tick(batch["__size__"])
        if is_master and (batch_idx + 1) % cfg.TRAIN.LOG_INTERVAL == 0:
            _drain(pending, update)
            print(f"Train Epoch: {epoch} [{losses.count}]\t"
                  f"Loss: {losses.val:.4f} ({losses.avg:.4f})  "
                  f"Top1:{top1.val:.4f} Top5:{top5.val:.4f}\t"
                  f"{thru.items_per_sec:.1f} clips/s")
            if sink:
                it = epoch * len(train_loader) + batch_idx
                sink.add_scalar("train/loss", losses.val, it)
                sink.add_scalar("train/top1", top1.val, it)
                sink.add_scalar("train/top5", top5.val, it)
    _drain(pending, update)
    if is_master:
        runtime_h = (time.time() - start) / 3600
        print(f"\nTrain set: Average loss: {losses.avg:.4f} "
              f"({thru.items_per_sec:.1f} clips/s steady-state)")
        append_metric_line(cfg.OUTPUT_PATH, "train_loss_and_acc.txt",
                           f"epoch:{epoch} runtime:{round(runtime_h, 2)} "
                           f"{losses.avg:.4f}")
        if sink:
            sink.add_scalar("epoch/train_loss", losses.avg, epoch)
    return losses.avg


def contrastive_modality(cfg) -> str:
    """``rgb`` when ``DATASET.MODALITY`` says so, else ``res`` (the JAX
    driver's rule; the default ``False`` gives ``res``)."""
    return "rgb" if str(cfg.DATASET.MODALITY) == "rgb" else "res"


def make_train_step(cfg, model, optimizer, schedule, banks, device="cuda"):
    """LOSS.TYPE dispatch (reference online_train.py:675-720; the JAX
    driver's ``_make_step_and_state``): the step of ``cfg``'s loss over
    ``banks`` (``steps.make_banks``) -> (step, epoch function)."""
    from .steps import (make_contrastive_train_step, make_moco_train_step,
                        make_triplet_train_step)

    if cfg.LOSS.TYPE == "UberNCE":
        return (make_moco_train_step(cfg, model, optimizer, schedule,
                                     banks["moco"],
                                     uber=cfg.MODEL.ARCH == "uber_nce",
                                     device=device),
                ubernce_train_epoch)

    if cfg.LOSS.TYPE == "triplet":
        kw = {"bank": banks["mem_triplet"]} if banks else {}
        return (make_triplet_train_step(cfg, model, optimizer, schedule,
                                        device=device, **kw),
                triplet_train_epoch)
    intra_neg = bool(cfg.LOSS.INTRA_NEGATIVE)
    use_moco = "memory_moco" in banks
    step = make_contrastive_train_step(
        cfg, model, optimizer, schedule,
        banks["memory_moco" if use_moco else "nce"],
        modality=contrastive_modality(cfg), intra_neg=intra_neg,
        use_moco=use_moco, device=device)
    return step, contrastive_train_epoch


def iterative_cluster_step(model, cfg, eval_train_loader,
                           is_master: bool = True, sink=None,
                           epoch: int = 0,
                           device="cuda") -> Optional[np.ndarray]:
    """Embed train set -> cluster -> NMI/AMI logs -> vid_clusters.txt
    (reference online_train.py:599-667). Returns labels in dataset order.

    ``ITERCLUSTER.ADAPTIVEP`` sets ``DATASET.POSITIVE_SAMPLING_P`` to
    1 - NMI. NMI and AMI are computed without scikit-learn
    (``utils/cluster_metrics.py``)."""
    dev = resolve_device(device)
    t0 = time.time()
    emb, true_labels, indices = get_embeddings_and_labels(
        model, cfg, eval_train_loader, split="train", verbose=is_master,
        device=dev)
    if is_master:
        print(f"embedding pass: {time.time() - t0:.1f}s")

    t0 = time.time()
    labels = fit_cluster(emb, method=cfg.ITERCLUSTER.METHOD,
                         k=cfg.ITERCLUSTER.K,
                         l2normalize=cfg.ITERCLUSTER.L2_NORMALIZE,
                         finch_partition=cfg.ITERCLUSTER.FINCH_PARTITION,
                         verbose=is_master, device=dev)
    if is_master:
        print(f"clustering: {time.time() - t0:.1f}s")

    # restore dataset order (loader iterates unshuffled, but be safe)
    order = np.argsort(indices)
    labels = labels[order]
    true = true_labels[order]

    nmi = normalized_mutual_info(true, labels)
    ami = adjusted_mutual_info(true, labels)
    if is_master:
        print(f"NMI: {nmi:.4f} AMI: {ami:.4f}")
        append_metric_line(cfg.OUTPUT_PATH, "NMIs.txt", f"{nmi:.6f}")
        append_metric_line(cfg.OUTPUT_PATH, "AMIs.txt", f"{ami:.6f}")
        if sink:
            sink.add_scalar("cluster/nmi", nmi, epoch)
            sink.add_scalar("cluster/ami", ami, epoch)
        cluster_file = os.path.join(cfg.OUTPUT_PATH, "vid_clusters.txt")
        write_cluster_labels(cluster_file, labels)

    if cfg.ITERCLUSTER.ADAPTIVEP:
        # adaptive positive sampling p = 1 - NMI (reference :645-646)
        cfg.DATASET.POSITIVE_SAMPLING_P = float(1.0 - nmi)
    return labels


def _check_supported(args, cfg) -> None:
    if cfg.LOSS.TYPE not in ("triplet", "contrastive", "UberNCE"):
        raise AssertionError(f"Loss Type:{cfg.LOSS.TYPE} not recognized "
                             "(reference online_train.py:719-720)")
    mesh = [int(d) for d in (cfg.TPU.MESH_SHAPE or [])]
    if int(getattr(args, "num_shards", 1) or 1) > 1 \
            or int(np.prod(mesh or [1])) > 1:
        raise NotImplementedError(
            "training on more than one device: not ported yet (ROADMAP.md, "
            "queue 1, item 10: torch.distributed with DDP)")


def train(args, cfg, device="cuda"):
    """The pretrain loop on one device, triplet, contrastive or UberNCE
    (reference online_train.train, :441-776). -> (model, optimizer,
    schedule, banks)."""
    from ..models import model_selector
    from .checkpoint import (load_checkpoint, load_encoder_state,
                             load_torch_checkpoint, merge_pretrained,
                             resolve_checkpoint, restore_train_state,
                             save_checkpoint)
    from .state import make_optimizer
    from .steps import make_banks

    _check_supported(args, cfg)
    dev = resolve_device(device)
    is_master = True
    accum = max(1, int(cfg.TRAIN.ACCUM_STEPS))
    if accum > 1 and cfg.LOSS.TYPE == "UberNCE":
        # the momentum-encoder step has no accumulation path (JAX driver)
        print("WARN: TRAIN.ACCUM_STEPS ignored for LOSS.TYPE=UberNCE")
        cfg.TRAIN.ACCUM_STEPS = accum = 1
    if accum > 1 and cfg.TRAIN.BATCH_SIZE % accum != 0:
        raise ValueError(f"TRAIN.BATCH_SIZE={cfg.TRAIN.BATCH_SIZE} must "
                         f"divide ACCUM_STEPS={accum}")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)  # the JAX driver initializes from key(0)
        model = model_selector(cfg)
    iter_cluster = bool(getattr(args, "iterative_cluster", False))
    vector = bool(getattr(args, "vector", False))

    # resolve and read the checkpoint before anything that depends on the
    # start epoch: a resume re-enables the pseudo-labels at once
    ckpt_path = resolve_checkpoint(getattr(args, "checkpoint_path", None),
                                   cfg.MODEL.ARCH, allow_missing=vector)
    payload = load_checkpoint(ckpt_path) if ckpt_path else None
    start_epoch, best_prec1 = 0, 0.0
    if payload is not None:
        start_epoch = int(payload.get("epoch", 0))
        best_prec1 = float(payload.get("best_prec1", 0.0))
    if getattr(args, "start_epoch", None) is not None:
        start_epoch = args.start_epoch
    cluster_labels = None
    if iter_cluster and start_epoch >= cfg.ITERCLUSTER.WARMUP_EPOCHS:
        cluster_file = os.path.join(cfg.OUTPUT_PATH, "vid_clusters.txt")
        if os.path.exists(cluster_file):
            cfg.DATASET.CLUSTER_PATH = cluster_file
            # the run trained on cluster labels before it stopped
            cfg.DATASET.TARGET_TYPE_T = "cluster_label"
        else:
            print(f"resume: {cluster_file} not found; using true labels "
                  "until the next clustering step")

    def make_train_loader():
        loader, _ = build_data_loader("train", cfg, is_master, triplets=True,
                                      cluster_labels=cluster_labels,
                                      device=dev)
        if accum > 1:
            # uploaded clip leaves arrive (A, b, ...) already
            loader.upload_microbatch = accum
        return loader

    train_loader = make_train_loader()
    val_loader, _ = build_data_loader("val", cfg, is_master, triplets=True,
                                      negative_sampling=True, device=dev)
    eval_train_loader, _ = build_data_loader(
        "train", cfg, is_master, triplets=False, req_train_shuffle=False,
        drop_last=False, device=dev)
    eval_val_loader, _ = build_data_loader(
        "val", cfg, is_master, triplets=False, val_sample=None,
        drop_last=False, device=dev)

    model.to(dev)
    if dev.type == "cuda":
        model.to(memory_format=torch.channels_last_3d)
    optimizer, schedule = make_optimizer(cfg, model.parameters(),
                                         steps_per_epoch=len(train_loader))
    with torch.random.fork_rng(devices=[]):
        banks = make_banks(cfg, len(train_loader.dataset), model)

    # --pretrain_path: weights only, no epoch or optimizer resume
    # (reference load_pretrained_model, models/model_utils.py:148-156); a
    # Caffe2 .pkl too, a 2-D one inflated with SLOWFAST.CHECKPOINT_INFLATE
    inflate = bool(cfg.SLOWFAST.CHECKPOINT_INFLATE)
    pretrain_path = getattr(args, "pretrain_path", None)
    if pretrain_path:
        load_encoder_state(model, load_torch_checkpoint(
            pretrain_path)["torch_state_dict"], verbose=is_master,
            inflate_temporal=inflate)
    if payload is not None and "torch_state_dict" in payload:
        # a Caffe2 .pkl as --checkpoint_path: weights by name and shape,
        # as the JAX driver merges a converted checkpoint
        merge_pretrained(model, payload["torch_state_dict"],
                         verbose=is_master, inflate_temporal=inflate)
    elif payload is not None:
        restore_train_state(model, optimizer, schedule, payload,
                            verbose=is_master, banks=banks)

    step_fn, epoch_fn = make_train_step(cfg, model, optimizer, schedule,
                                        banks, device=dev)
    generator = torch.Generator(device=dev)
    sink = MetricsSink(os.path.join(cfg.OUTPUT_PATH, "metrics"),
                       enabled=bool(cfg.TRAIN.METRICS_SINK) and is_master)

    for epoch in range(start_epoch, cfg.TRAIN.EPOCHS):
        print(f"\nEpoch {epoch}/{cfg.TRAIN.EPOCHS - 1}")
        if (iter_cluster and epoch >= cfg.ITERCLUSTER.WARMUP_EPOCHS
                and (epoch - cfg.ITERCLUSTER.WARMUP_EPOCHS)
                % cfg.ITERCLUSTER.INTERVAL == 0):
            cluster_labels = iterative_cluster_step(
                model, cfg, eval_train_loader, is_master, sink=sink,
                epoch=epoch, device=dev)
            cfg.DATASET.CLUSTER_PATH = os.path.join(cfg.OUTPUT_PATH,
                                                    "vid_clusters.txt")
            cfg.DATASET.TARGET_TYPE_T = "cluster_label"
            train_loader = make_train_loader()

        train_loader.set_epoch(epoch)
        epoch_fn(step_fn, train_loader, cfg, epoch, generator, is_master,
                 sink=sink, device=dev)

        acc, topk = validate(model, cfg, val_loader, epoch, is_master,
                             device=dev)
        if sink.enabled:
            sink.add_scalar("val/triplet_acc", acc, epoch)
            for k, v in (topk or {}).items():
                sink.add_scalar(f"val/top{k}", v, epoch)

        # every-RETRIEVAL_INTERVAL-epochs global retrieval drives is_best
        # (reference online_train.py:736-746; its cadence is hardcoded 10)
        is_best = False
        if epoch % max(1, cfg.TRAIN.RETRIEVAL_INTERVAL) == 0:
            retr = k_nearest_embeddings(model, cfg, eval_train_loader,
                                        eval_val_loader, epoch=epoch,
                                        is_master_proc=is_master,
                                        device=dev)
            top1 = retr.get(1, 0.0)
            if sink.enabled:
                for k, v in retr.items():
                    sink.add_scalar(f"retrieval/top{k}", v, epoch)
            is_best = top1 > best_prec1
            best_prec1 = max(best_prec1, top1)

        # --vector: OUTPUT_PATH only on milestone epochs, and always the
        # stable root (reference online_train.py:756-776)
        if not vector or (epoch % 100 == 0 or is_best
                          or epoch == cfg.TRAIN.EPOCHS - 1):
            save_checkpoint(cfg.OUTPUT_PATH, cfg.MODEL.ARCH, model,
                            optimizer, schedule, epoch, best_prec1,
                            is_best=is_best, banks=banks)
        if vector and getattr(args, "checkpoint_path", None):
            save_checkpoint(args.checkpoint_path, cfg.MODEL.ARCH, model,
                            optimizer, schedule, epoch, best_prec1,
                            banks=banks)
    sink.close()
    return model, optimizer, schedule, banks
