"""IIC-protocol clip retrieval entry point of the port (mirrors the JAX
package's ``cli/iic_retrieve_clips.py``; reference
iic_retrieve_clips.py:334-354).

    python -m video_similarity_search_tpu_torch.cli.iic_retrieve_clips \\
        --cfg configs/resnet_ucf_itercluster_flow.yaml \\
        --dataset ucf101 --root_dir <dir> [--checkpoint_path <.pth.tar>] \\
        [--feature_dir features] [--device cuda]

Decodes each video of the train and test splits whole (OpenCV), takes
``--sample_num`` evenly spaced clips of ``--clip_len`` frames resized to
``DATA.SAMPLE_SIZE``, embeds them as one batch on the card and caches the
features as ``<feature_dir>/{split}_features.npy`` (N, sample_num, D) and
``{split}_classes.npy``; then the mean-clip cosine top-k (k in
{1, 5, 10, 20, 50}) goes to ``<feature_dir>/topk_correct.json``. The JAX
CLI's flags plus ``--device`` (default ``cuda``; without CUDA it raises,
and ``--device cpu`` runs the plain PyTorch path). A ``.pth.tar`` loads by
name into the encoder (``load_encoder_state``), as the evaluate CLI does.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional


def extract_features(model, cfg, dataset, feature_dir: str, split: str,
                     device="cuda"):
    """Each video's ``sample_num`` clips through the embed step as one
    batch -> (features (N, sample_num, D), classes (N,)), read from the
    ``feature_dir`` cache when it holds them. Prints the split's host
    decode seconds and the feature pass's clips/s."""
    import numpy as np
    import torch

    from ..data.augment import normalize_only
    from ..train.steps import make_embed_step

    feat_path = os.path.join(feature_dir, f"{split}_features.npy")
    cls_path = os.path.join(feature_dir, f"{split}_classes.npy")
    if os.path.exists(feat_path):
        return np.load(feat_path), np.load(cls_path)

    embed = make_embed_step(cfg, model, device=device)
    feats, classes = [], []
    decode_s = embed_s = 0.0
    n_clips = 0
    for i in range(len(dataset)):
        t0 = time.perf_counter()
        item = dataset[i]
        t1 = time.perf_counter()
        clips = torch.from_numpy(item["clips"]).to(device)  # (n, T, H, W, 3)
        x = normalize_only(clips, dataset=cfg.TRAIN.DATASET)
        feats.append(embed(x).cpu().numpy())  # (n, D)
        embed_s += time.perf_counter() - t1
        decode_s += t1 - t0
        n_clips += clips.shape[0]
        classes.append(item["label"])
        if (i + 1) % 50 == 0:
            print(f"[{split}] {i + 1}/{len(dataset)}")
    feats = np.stack(feats)
    classes = np.asarray(classes)
    print(f"[{split}] {len(dataset)} videos: decode {decode_s:.3f} s, "
          f"features {embed_s:.3f} s ({n_clips / max(embed_s, 1e-9):.1f} "
          "clips/s)")
    os.makedirs(feature_dir, exist_ok=True)
    np.save(feat_path, feats)
    np.save(cls_path, classes)
    return feats, classes


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("iic_retrieve_clips")
    parser.add_argument("--cfg", dest="cfg_file", required=True)
    parser.add_argument("--checkpoint_path", default=None)
    # explicit-list mode (any dataset)
    parser.add_argument("--video_dir", default=None)
    parser.add_argument("--train_list", default=None)
    parser.add_argument("--test_list", default=None)
    parser.add_argument("--class_index", default=None)
    # layout mode (reference directory conventions): --dataset + --root_dir
    parser.add_argument("--dataset", default=None,
                        choices=[None, "ucf101", "hmdb51"],
                        help="use the reference split layout under "
                             "--root_dir (ucf101: split/+videos/; hmdb51: "
                             "prev_split/+avi/, iic_datasets/hmdb51.py:41-50)")
    parser.add_argument("--root_dir", default=None)
    parser.add_argument("--which_split", default="1")
    parser.add_argument("--feature_dir", default="features")
    parser.add_argument("--clip_len", type=int, default=16)
    parser.add_argument("--sample_num", type=int, default=10)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda, cuda:1, cpu)")
    return parser


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.dataset and not (args.video_dir and args.train_list
                                 and args.test_list and args.class_index):
        parser.error("pass either --dataset+--root_dir or the explicit "
                     "--video_dir/--train_list/--test_list/--class_index")

    import torch

    from ..config import get_cfg
    from ..data.iic_data import (ClipRetrievalDataset,
                                 UCF101ClipRetrievalDataset, parse_split_file)
    from ..evaluation.retrieval import iic_retrieval_acc
    from ..models import model_selector
    from ..train.checkpoint import load_encoder_state, load_torch_checkpoint
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = get_cfg()
    cfg.merge_from_file(args.cfg_file)
    torch.manual_seed(0)
    model = model_selector(cfg)
    if args.checkpoint_path:
        load_encoder_state(
            model, load_torch_checkpoint(args.checkpoint_path)[
                "torch_state_dict"])

    if args.dataset:
        def mk_split(train):
            return UCF101ClipRetrievalDataset(
                args.root_dir, args.clip_len, sample_num=args.sample_num,
                train=train, split=args.which_split,
                sample_size=cfg.DATA.SAMPLE_SIZE, layout=args.dataset)
        train_ds, test_ds = mk_split(True), mk_split(False)
    else:
        def mk_list(lst):
            return ClipRetrievalDataset(
                args.video_dir, parse_split_file(lst, args.class_index),
                clip_len=args.clip_len, sample_num=args.sample_num,
                sample_size=cfg.DATA.SAMPLE_SIZE)
        train_ds, test_ds = mk_list(args.train_list), mk_list(args.test_list)
    train_feats, train_cls = extract_features(
        model, cfg, train_ds, args.feature_dir, "train", device=dev)
    test_feats, test_cls = extract_features(
        model, cfg, test_ds, args.feature_dir, "test", device=dev)

    topk = iic_retrieval_acc(test_feats, test_cls, train_feats, train_cls,
                             device=dev)
    out = {str(k): v for k, v in topk.items()}
    with open(os.path.join(args.feature_dir, "topk_correct.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
