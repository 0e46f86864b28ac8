"""Self-supervised pretrain entry point of the port (mirrors the JAX
package's ``cli/online_train.py``; reference online_train.py:779-837).

    python -m video_similarity_search_tpu_torch.cli.online_train \\
        --cfg configs/resnet_ucf_itercluster_flow.yaml --iterative_cluster \\
        [--output <dir>] [--device cuda] [KEY VALUE ...]

The same flags as the JAX CLI plus ``--device`` (default ``cuda``; without
CUDA it raises, and ``--device cpu`` runs the plain PyTorch path). Writes
the JAX CLI's files under OUTPUT_PATH, with
``tnet_checkpoints/<arch>/checkpoint.pth.tar`` where the JAX package
writes an orbax directory.

More than one GPU, one process each (``train/driver.py`` keeps the JAX
package's global-batch semantics):

* ``--gpu 0,1,2,3`` on one node starts one process per listed card, as
  the reference's launcher does; with ``--num_shards N --shard_id s`` on
  each of N nodes, the world is N x the listed cards and node s holds
  ranks s x len(gpu) onward. The group meets at ``--ip_address_port``
  (``tcp://host:port``, node 0's address); ``--compute_canada`` takes
  the node index from ``$SLURM_NODEID``.
* ``--num_shards N --shard_id s`` without ``--gpu``: one process per node
  on ``--device``.
* ``torchrun --nproc_per_node=G -m video_similarity_search_tpu_torch.cli.online_train
  ...``: the group from torchrun's environment, rank ``LOCAL_RANK`` on
  card ``LOCAL_RANK`` (or on ``--gpu``'s entry of that index).

NCCL runs between cards; ``--device cpu`` uses gloo (``--gpu 0,1 --device
cpu`` is two CPU ranks, as the tests run it). A rendezvous that fails
raises; nothing falls back to one process.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional


def _local_cards(args) -> List[str]:
    return [g.strip() for g in (args.gpu or "").split(",") if g.strip()]


def _rank_device(args, local: int):
    """This process's device: ``--gpu``'s entry ``local`` or, under
    torchrun without ``--gpu``, card ``local``; else ``--device``."""
    import torch

    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    if dev.type != "cuda":
        return dev
    cards = _local_cards(args)
    if cards:
        dev = torch.device("cuda", int(cards[local]))
    elif "WORLD_SIZE" in os.environ:
        dev = torch.device("cuda", local)
    if dev.index is not None:  # NCCL takes the current card
        torch.cuda.set_device(dev)
    return dev


def _run(args, local: int = 0):
    """Join the group this launch describes (if any), then train."""
    from ..config import load_config
    from ..parallel import (destroy, initialize_distributed, local_rank,
                            maybe_auto_initialize)
    from ..train.driver import train

    torchrun = "WORLD_SIZE" in os.environ
    if torchrun:
        local = local_rank()
    dev = _rank_device(args, local)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    n_local = max(1, len(_local_cards(args)))
    world = args.num_shards * n_local
    if torchrun:
        joined = maybe_auto_initialize(backend)
    elif world > 1:
        initialize_distributed(args.ip_address_port, world,
                               args.shard_id * n_local + local, backend)
        joined = True
    else:
        joined = False
    try:
        cfg = load_config(args)
        os.makedirs(cfg.OUTPUT_PATH, exist_ok=True)
        os.makedirs(os.path.join(cfg.OUTPUT_PATH, "tnet_checkpoints"),
                    exist_ok=True)
        model, optimizer, _, _ = train(args, cfg, device=dev)
    finally:
        if joined:
            destroy()
    return cfg, model, optimizer


def _spawned(local: int, argv: List[str]) -> None:
    """One local process of a ``--gpu`` launch."""
    from ..config import arg_parser

    args = arg_parser().parse_args(argv)
    _run(_with_node(args), local)


def _with_node(args):
    if args.compute_canada:
        # the node index from SLURM (reference online_train.py:806-812)
        args.shard_id = int(os.environ.get("SLURM_NODEID", args.shard_id))
    return args


def main(argv: Optional[List[str]] = None):
    """Train; -> (cfg, model, optimizer) of this process, or None when it
    started one process per ``--gpu`` card (they return nothing)."""
    from ..config import arg_parser

    argv = list(sys.argv[1:] if argv is None else argv)
    args = _with_node(arg_parser().parse_args(argv))
    if len(_local_cards(args)) > 1 and "WORLD_SIZE" not in os.environ:
        import torch.multiprocessing as mp

        mp.start_processes(_spawned, args=(argv,),
                           nprocs=len(_local_cards(args)),
                           start_method="spawn")
        return None
    return _run(args)


if __name__ == "__main__":
    main()
