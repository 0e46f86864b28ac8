"""t-SNE visualization entry point of the port (mirrors the JAX package's
``cli/tsne.py``; reference tsne.py:24-220).

    python -m video_similarity_search_tpu_torch.cli.tsne \\
        --cfg configs/resnet_ucf_itercluster_flow.yaml \\
        --checkpoint_path <ckpt.pth.tar> --output tsne.png [--split val] \\
        [--n_classes 20] [--device cuda]

Embeds the split with the encoder of any ``MODEL.ARCH`` (a ``.pth.tar``
loads by name through ``load_encoder_state``), then PCA and t-SNE on the
device and a scatter PNG of 1500 x 1200 pixels (``evaluation/tsne.py``).
The JAX CLI's flags plus ``--device`` (default ``cuda``; without CUDA it
raises, and ``--device cpu`` runs the plain PyTorch path). Flags go before
any trailing ``KEY VALUE`` config overrides.
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("tsne")
    parser.add_argument("--cfg", dest="cfg_file", required=True)
    parser.add_argument("--checkpoint_path", default=None)
    parser.add_argument("--output", default="tsne.png")
    parser.add_argument("--split", default="val")
    parser.add_argument("--n_classes", type=int, default=20)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda, cuda:1, cpu)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return parser


def main(argv: Optional[List[str]] = None) -> str:
    args = arg_parser().parse_args(argv)

    from ..config import get_cfg
    from ..data import build_data_loader
    from ..evaluation.embed import get_embeddings_and_labels
    from ..evaluation.tsne import tsne_plot
    from ..models import model_selector
    from ..train.checkpoint import load_encoder_state, load_torch_checkpoint
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = get_cfg()
    cfg.merge_from_file(args.cfg_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    model = model_selector(cfg)
    if args.checkpoint_path:
        payload = load_torch_checkpoint(args.checkpoint_path)
        load_encoder_state(model, payload["torch_state_dict"],
                           inflate_temporal=bool(
                               cfg.SLOWFAST.CHECKPOINT_INFLATE))

    loader, (_, idx_to_class) = build_data_loader(
        args.split, cfg, triplets=False, drop_last=False, device=dev)
    emb, labels, _ = get_embeddings_and_labels(model, cfg, loader,
                                               split=args.split, device=dev)
    out = tsne_plot(emb, labels, out_path=args.output,
                    n_classes=args.n_classes, idx_to_class=idx_to_class,
                    device=dev)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
