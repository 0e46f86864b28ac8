"""Finetune / linear-probe / test entry point of the port (mirrors the JAX
package's ``cli/coclr_classify.py``; reference coclr_classify.py:125-922).

    python -m video_similarity_search_tpu_torch.cli.coclr_classify \\
        --vid_path <jpg> --annotation_path <json> --train_what last|ft|all \\
        [--net s3d|s3dg] [--output <dir>] [--device cuda]
    ... --checkpoint_path <model_best.pth.tar> [--retrieval]

    ... --lmdb_root <dir> [--dataset ucf101|hmdb51|k400] ...

The JAX CLI's flags plus ``--device`` (default ``cuda``; without CUDA it
raises, and ``--device cpu`` runs the plain PyTorch path). Trains the
``LinearClassifier`` with cross-entropy on the frame-JPEG pipeline (or,
with ``--lmdb_root``, on CoCLR's msgpack-in-LMDB stores), the
``--train_what`` groups and the step-indexed schedule of
``train/state.py``; validates every epoch and writes
``<output>/tnet_checkpoints/<net>/model_best.pth.tar`` when validation
top-1 improves, with the scalars under ``<output>/metrics``. With
``--checkpoint_path`` it runs the ten-crop test (decode buffer 1.14x the
crop) or, with ``--retrieval``, feature retrieval, and exits.

As in the JAX CLI: ``MODEL.ARCH`` is forced to ``s3d``, the whole path
runs in float32 (``TPU.COMPUTE_DTYPE`` is forced to it), training on the
frame path gets no augmentation (the loader's buffer is the crop, so only
``normalize_only`` runs), and ``--resume`` is parsed and never read. The
LMDB path (``data/lmdb_data.py``) trains on a ``2 x --img_dim`` buffer
that ``train_augment`` crops on the device, validates on a buffer of the
crop, runs the ten-crop test on ``int(1.14 x --img_dim)`` and embeds the
``train`` and ``test`` stores for ``--retrieval``.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("coclr_classify")
    parser.add_argument("--cfg", dest="cfg_file", default=None)
    parser.add_argument("--net", default="s3d")
    parser.add_argument("--dataset", default="ucf101")
    parser.add_argument("--lmdb_root", default=None)
    parser.add_argument("--vid_path", default=None)
    parser.add_argument("--annotation_path", default=None)
    parser.add_argument("--train_what", default="last",
                        choices=["last", "ft", "all"])
    parser.add_argument("--epochs", type=int, default=150)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--schedule", type=int, nargs="*", default=[60, 100])
    parser.add_argument("--cosine", action="store_true")
    parser.add_argument("--wd", type=float, default=1e-3)
    parser.add_argument("--dropout", type=float, default=0.9)
    parser.add_argument("--num_class", type=int, default=101)
    parser.add_argument("--seq_len", type=int, default=32)
    parser.add_argument("--img_dim", type=int, default=128)
    parser.add_argument("--pretrain", default=None,
                        help="pretrained backbone checkpoint (.pth.tar)")
    parser.add_argument("--resume", default=None)
    parser.add_argument("--checkpoint_path", default=None,
                        help="run test path (10-crop / retrieval) and exit")
    parser.add_argument("--retrieval", action="store_true")
    parser.add_argument("--ten_crop", action="store_true")
    parser.add_argument("--output", default="coclr_out")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda, cuda:1, cpu)")
    return parser


def main(argv: Optional[List[str]] = None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from ..config import get_cfg
    from ..data import build_data_loader
    from ..data.augment import normalize_only, train_augment
    from ..data.lmdb_data import build_lmdb_loader
    from ..evaluation.classify import test_10crop, test_retrieval
    from ..models.heads import LinearClassifier
    from ..train.checkpoint import (load_checkpoint, load_torch_checkpoint,
                                    merge_pretrained, restore_train_state,
                                    save_checkpoint)
    from ..train.driver import _drain, step_seed
    from ..train.state import (make_classify_optimizer, make_lr_schedule,
                               piecewise_constant)
    from ..train.steps import make_classify_train_step, make_embed_step
    from ..utils.device import resolve_device
    from ..utils.meters import AverageMeter
    from ..utils.metrics_sink import MetricsSink
    from ..utils.profiling import Throughput

    dev = resolve_device(args.device)
    cfg = get_cfg()
    if args.cfg_file:
        cfg.merge_from_file(args.cfg_file)
    cfg.TRAIN.DATASET = args.dataset
    if args.vid_path:
        cfg.DATASET.VID_PATH = args.vid_path
    if args.annotation_path:
        cfg.DATASET.ANNOTATION_PATH = args.annotation_path
    cfg.DATA.SAMPLE_DURATION = args.seq_len
    cfg.DATA.SAMPLE_SIZE = args.img_dim
    cfg.OUTPUT_PATH = args.output
    cfg.MODEL.ARCH = "s3d"
    # the JAX CLI builds LinearClassifier in float32 and never reads
    # TPU.COMPUTE_DTYPE, so no autocast here either (ROADMAP.md, queue 3)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    os.makedirs(args.output, exist_ok=True)

    torch.manual_seed(0)
    model = LinearClassifier(
        num_class=args.num_class, network=args.net,
        dropout=args.dropout, use_dropout=args.dropout > 0,
        use_l2_norm=args.train_what == "last",
        use_final_bn=args.train_what == "last",
    )
    if args.pretrain:
        # a MoCo/CoCLR checkpoint's encoder_q.0. arrives as backbone.
        # (reference coclr_classify.py:244-252, coclr_utils/utils.py:93-118)
        merge_pretrained(model,
                         load_torch_checkpoint(args.pretrain)["torch_state_dict"])

    print(f"coclr_classify: net={args.net} train_what={args.train_what} "
          f"epochs={args.epochs}")

    # ---- test-only path (reference coclr_classify.py:231-290) ----------
    if args.checkpoint_path:
        optimizer, schedule = make_classify_optimizer(
            model, args.train_what, piecewise_constant(args.lr), args.wd)
        payload = load_checkpoint(args.checkpoint_path)
        if "state_dict" in payload:
            restore_train_state(model, optimizer, schedule, payload)
        if args.lmdb_root:
            def lmdb(split, **kw):
                return build_lmdb_loader(args.dataset, args.lmdb_root, split,
                                         cfg, args.batch_size, device=dev,
                                         **kw)[0]
            if args.retrieval:
                return test_retrieval(model, cfg, lmdb("train"),
                                      lmdb("test"), device=dev)
            return test_10crop(model, cfg, lmdb(
                "val", buffer_size=int(1.14 * cfg.DATA.SAMPLE_SIZE)),
                device=dev)
        if args.retrieval:
            train_loader, _ = build_data_loader(
                "train", cfg, triplets=False, req_train_shuffle=False,
                drop_last=False, device=dev)
            test_loader, _ = build_data_loader(
                "test", cfg, triplets=False, drop_last=False, batch_size=1,
                device=dev)
            return test_retrieval(model, cfg, train_loader, test_loader,
                                  device=dev)
        # decode buffer 1.14x the crop so the five crops differ
        # (reference Scale(1.14*img_dim) before FiveCrop, :528-534)
        test_loader, _ = build_data_loader(
            "val", cfg, triplets=False, drop_last=False,
            buffer_size=int(1.14 * cfg.DATA.SAMPLE_SIZE), device=dev)
        return test_10crop(model, cfg, test_loader, device=dev)

    # ---- training loop (reference coclr_classify.py:366-389) -----------
    if not cfg.DATASET.ANNOTATION_PATH and not args.lmdb_root:
        print("no dataset configured (set --annotation_path/--vid_path "
              "or --lmdb_root); exiting after setup")
        return model, None

    if args.lmdb_root:
        train_loader, _ = build_lmdb_loader(
            args.dataset, args.lmdb_root, "train", cfg, args.batch_size,
            device=dev)
        val_loader, _ = build_lmdb_loader(
            args.dataset, args.lmdb_root, "val", cfg, args.batch_size,
            buffer_size=cfg.DATA.SAMPLE_SIZE, device=dev)
    else:
        cfg.DATA.TEMPORAL_CROP = "random"
        train_loader, _ = build_data_loader(
            "train", cfg, triplets=False, req_train_shuffle=True,
            drop_last=True, batch_size=args.batch_size, device=dev)
        cfg_val = cfg.clone()
        cfg_val.DATA.TEMPORAL_CROP = "center"
        val_loader, _ = build_data_loader(
            "val", cfg_val, triplets=False, drop_last=False,
            batch_size=args.batch_size, device=dev)

    steps_per_epoch = max(len(train_loader), 1)
    lr_schedule = make_lr_schedule(args.lr, args.epochs, args.schedule,
                                   args.cosine, steps_per_epoch)
    optimizer, schedule = make_classify_optimizer(model, args.train_what,
                                                  lr_schedule, args.wd)
    step_fn = make_classify_train_step(cfg, model, optimizer, schedule,
                                       device=dev)
    val_forward = make_embed_step(cfg, model, device=dev)  # logits
    sink = MetricsSink(os.path.join(args.output, "metrics"))
    dataset = cfg.TRAIN.DATASET
    size = cfg.DATA.SAMPLE_SIZE
    gen = torch.Generator(device=dev)

    best_acc = 0.0
    for epoch in range(args.epochs):
        lr = lr_schedule(epoch * steps_per_epoch)
        meters = {k: AverageMeter(k) for k in ("loss", "top1", "top5")}
        thru = Throughput()
        train_loader.set_epoch(epoch)
        # device metrics are read after the first step and the epoch: a
        # per-step float() would make the host wait for the card every step
        pending = []

        def update(m, n):
            for k in meters:
                meters[k].update(float(m[k]), n)

        for i, batch in enumerate(train_loader):
            gen.manual_seed(step_seed(epoch, i))
            clips = torch.as_tensor(batch["clip"]).to(dev)
            clips = (train_augment(clips, gen, size, dataset=dataset)
                     if clips.shape[2] > size else
                     normalize_only(clips, dataset=dataset))
            label = torch.as_tensor(np.asarray(batch["target"])).to(dev).long()
            m = step_fn({"clips": clips, "label": label}, generator=gen)
            pending.append((m, len(batch["target"])))
            if i == 0:
                thru.done(_drain(pending, update))
        thru.done(_drain(pending, update))
        print(f"epoch {epoch}: lr {lr:.5f} loss {meters['loss'].avg:.4f} "
              f"top1 {meters['top1'].avg:.4f} "
              f"({thru.items_per_sec:.1f} clips/s)")
        sink.add_scalar("train/lr", lr, epoch)
        for name in meters:
            sink.add_scalar(f"train/{name}", meters[name].avg, epoch)
        # validation (loader-padded tail rows sliced off, __size__ contract)
        model.eval()
        v_top1 = AverageMeter("v1")
        for batch in val_loader:
            logits = val_forward(normalize_only(
                torch.as_tensor(batch["clip"]).to(dev), dataset=dataset))
            n = int(batch.get("__size__", len(batch["target"])))
            pred = logits.argmax(dim=1).cpu().numpy()[:n]
            v_top1.update(float(np.mean(pred == np.asarray(batch["target"])[:n])),
                          n)
        print(f"  val top1 {v_top1.avg:.4f}")
        sink.add_scalar("val/top1", v_top1.avg, epoch)
        if v_top1.avg > best_acc:
            best_acc = v_top1.avg
            save_checkpoint(args.output, args.net, model, optimizer, schedule,
                            epoch, best_acc, is_best=True)
    sink.close()
    return model, optimizer


if __name__ == "__main__":
    main()
