"""Retrieval evaluation entry point of the port (mirrors the JAX package's
``cli/evaluate.py``; reference evaluate.py:486-585).

    python -m video_similarity_search_tpu_torch.cli.evaluate \\
        --cfg configs/resnet_ucf_itercluster_flow.yaml \\
        --checkpoint_path <ckpt.pth.tar> --output <dir> [--device cuda]

Builds the encoder, loads a reference-format torch checkpoint (or a
pyslowfast Caffe2 ``.pkl``), embeds the
train and test splits (test = sliding-window averaged, or one center clip
with ``--crop center``), and reports top-1/5/10/20 cosine retrieval. It
writes ``train_embeddings.pkl``, ``test_embeddings.pkl`` and
``tnet_checkpoints/global_retrieval_acc.txt`` under OUTPUT_PATH, as the
JAX CLI does; ``--heatmap EX,TEST`` also writes ``temporal_heat_map.png``
and ``--plot`` ``exemplar_retrievals.png`` there (drawn with Pillow).
``--device`` defaults to ``cuda`` and raises without CUDA;
``--device cpu`` runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional


def arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("evaluate")
    parser.add_argument("--cfg", dest="cfg_file", required=True)
    parser.add_argument("--checkpoint_path", default=None)
    parser.add_argument("--output", default=None)
    parser.add_argument("--gpu", default=None, help="ignored; use --device")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda, cuda:1, cpu)")
    parser.add_argument("--crop", default="avg",
                        help="center|avg (test window handling)")
    parser.add_argument("--heatmap", default=None, metavar="EX_IDX,TEST_IDX",
                        help="write a temporal similarity heat-map PNG for "
                             "exemplar/test video indices (the intended "
                             "behavior of reference evaluate.py:402-483)")
    parser.add_argument("--plot", action="store_true",
                        help="write exemplar retrieval frames PNG "
                             "(reference evaluate.py:241-275,376-394)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser


def main(argv: Optional[List[str]] = None) -> Dict[int, float]:
    args = arg_parser().parse_args(argv)
    if args.checkpoint_path and os.path.isdir(args.checkpoint_path):
        raise ValueError(
            f"{args.checkpoint_path} is a directory (an orbax checkpoint of "
            "the JAX package); the port reads torch .pth.tar checkpoints "
            "only, since orbax cannot be read without JAX")

    from ..config import get_cfg
    from ..data import build_data_loader
    from ..evaluation.knn import k_nearest_embeddings
    from ..models import model_selector
    from ..train.checkpoint import load_encoder_state, load_torch_checkpoint
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = get_cfg()
    cfg.merge_from_file(args.cfg_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    if args.output:
        cfg.OUTPUT_PATH = args.output
    os.makedirs(cfg.OUTPUT_PATH, exist_ok=True)

    start = time.time()
    model = model_selector(cfg)
    if args.checkpoint_path:
        payload = load_torch_checkpoint(args.checkpoint_path)  # or a .pkl
        load_encoder_state(model, payload["torch_state_dict"],
                           inflate_temporal=bool(
                               cfg.SLOWFAST.CHECKPOINT_INFLATE))

    train_loader, (train_dataset, _) = build_data_loader(
        "train", cfg, triplets=False, req_train_shuffle=False,
        drop_last=False, device=dev)
    # --crop center: one center clip per test video; avg (default): mean
    # over sliding windows (reference evaluate.py:89-143)
    test_loader, (test_dataset, _) = build_data_loader(
        "test", cfg, triplets=False, drop_last=False, batch_size=1,
        test_windows=args.crop != "center", device=dev)

    if args.heatmap:
        from ..evaluation.heatmap import temporal_heat_map

        ex_idx, test_idx = (int(v) for v in args.heatmap.split(","))
        out_png = os.path.join(cfg.OUTPUT_PATH, "temporal_heat_map.png")
        temporal_heat_map(model, cfg, test_dataset, exemplar_idx=ex_idx,
                          test_idx=test_idx, out_png=out_png, device=dev)
        print(f"wrote {out_png}")

    topk = k_nearest_embeddings(model, cfg, train_loader, test_loader,
                                cache_dir=cfg.OUTPUT_PATH, device=dev)

    if args.plot:
        from ..evaluation.embed import load_cached_embeddings
        from ..evaluation.knn import plot_exemplar_retrievals

        test_emb, _, _ = load_cached_embeddings(
            os.path.join(cfg.OUTPUT_PATH, "test_embeddings.pkl"))
        train_emb, _, _ = load_cached_embeddings(
            os.path.join(cfg.OUTPUT_PATH, "train_embeddings.pkl"))
        png = plot_exemplar_retrievals(
            test_emb, train_emb, test_dataset.samples, train_dataset.samples,
            os.path.join(cfg.OUTPUT_PATH, "exemplar_retrievals.png"),
            device=dev)
        print(f"wrote {png}")

    print(f"total runtime: {time.time() - start:.1f}s")
    return topk


if __name__ == "__main__":
    main()
