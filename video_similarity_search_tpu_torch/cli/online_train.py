"""Self-supervised pretrain entry point of the port (mirrors the JAX
package's ``cli/online_train.py``; reference online_train.py:779-837).

    python -m video_similarity_search_tpu_torch.cli.online_train \\
        --cfg configs/resnet_ucf_itercluster_flow.yaml --iterative_cluster \\
        [--output <dir>] [--device cuda] [KEY VALUE ...]

The same flags as the JAX CLI plus ``--device`` (default ``cuda``; without
CUDA it raises, and ``--device cpu`` runs the plain PyTorch path). Trains
on one device: ``--gpu`` and ``--compute_canada`` are accepted and
ignored, ``--num_shards > 1`` raises (ROADMAP.md, queue 1, item 10). Writes the JAX CLI's files under
OUTPUT_PATH, with ``tnet_checkpoints/<arch>/checkpoint.pth.tar`` where the
JAX package writes an orbax directory.
"""

from __future__ import annotations

import os
from typing import List, Optional


def main(argv: Optional[List[str]] = None):
    from ..config import arg_parser, load_config
    from ..train.driver import train
    from ..utils.device import resolve_device

    args = arg_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = load_config(args)
    os.makedirs(cfg.OUTPUT_PATH, exist_ok=True)
    os.makedirs(os.path.join(cfg.OUTPUT_PATH, "tnet_checkpoints"),
                exist_ok=True)
    model, optimizer, _, _ = train(args, cfg, device=dev)
    return cfg, model, optimizer


if __name__ == "__main__":
    main()
