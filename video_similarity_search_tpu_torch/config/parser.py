"""CLI argument parsing and config assembly (port of the JAX package's
``config/parser.py``).

Same CLI surface and the same precedence as the reference
(config/m_parser.py:10-174): defaults -> ``--cfg`` YAML -> trailing
``opts`` pairs -> explicit flags. The port adds ``--device`` (default
``cuda``); it selects where the entry point runs and is not a config key.
The launch flags are the JAX CLI's: ``--num_shards`` / ``--shard_id`` /
``--ip_address_port`` (``--compute_canada``: the shard id from
``$SLURM_NODEID``), and ``--gpu`` lists the local cards, one process each,
as in the reference (default: one process on ``--device``).
"""

from __future__ import annotations

import argparse

from .defaults import get_cfg
from .node import ConfigNode


def arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("Video Similarity Search Training Script (PyTorch)")
    parser.add_argument("--start_epoch", default=None, type=int,
                        help="overwrite start epoch")
    parser.add_argument("--pretrain_path", default=None, type=str,
                        help="Path to pretrained encoder")
    parser.add_argument("--checkpoint_path", default=None, type=str,
                        help="Path to checkpoint")
    parser.add_argument("--cfg", "-cfg", default=None, dest="cfg_file", type=str,
                        help="Path to the config file")
    parser.add_argument("--gpu", default=None, type=str,
                        help="local cards, one training process each (e.g. "
                             "0,1); with --device cpu, the number of local "
                             "CPU ranks; default: one process on --device")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device to run on (cuda, cuda:1, cpu)")
    parser.add_argument("--output", default=None, type=str,
                        help="output path, overwrites OUTPUT_PATH")
    parser.add_argument("--batch_size", default=None, type=int)
    parser.add_argument("--epoch", default=None, type=int)
    parser.add_argument("--num_data_workers", default=None, type=int)
    parser.add_argument("--sample_size", default=None, type=int)
    parser.add_argument("--n_classes", default=None, type=int)
    parser.add_argument("--shard_id", default=0, type=int,
                        help="this node's index among --num_shards nodes")
    parser.add_argument("--num_shards", default=1, type=int,
                        help="number of nodes (each runs --gpu's processes)")
    parser.add_argument("--ip_address_port", "-ip", default="tcp://localhost:9999",
                        type=str, help="torch.distributed init address")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="KEY VALUE override pairs, e.g. TRAIN.BATCH_SIZE 64")
    parser.add_argument("--compute_canada", "-cc", action="store_true")
    parser.add_argument("--sampling_strategy", default=None, type=str,
                        help="Triplet sampling strategy")
    parser.add_argument("--val_metric", default=None, type=str,
                        help="global, local_batch ...")
    parser.add_argument("--val_batch_size", default=None, type=str)
    parser.add_argument("--iterative_cluster", "-ic", action="store_true",
                        help="Iterative clustering for pseudo-label assignment")
    parser.add_argument("--vector", action="store_true",
                        help="preemptible-cluster checkpointing mode")
    return parser


def overwrite_default_configs(cfg: ConfigNode, args) -> None:
    """Explicit-flag overrides (reference config/m_parser.py:133-160)."""
    if args.batch_size:
        cfg.TRAIN.BATCH_SIZE = args.batch_size
    if args.epoch:
        cfg.TRAIN.EPOCHS = args.epoch
    if args.output:
        cfg.OUTPUT_PATH = args.output
    if args.num_data_workers:
        cfg.TRAIN.NUM_DATA_WORKERS = args.num_data_workers
    if args.sample_size:
        cfg.DATA.SAMPLE_SIZE = args.sample_size
    if args.sampling_strategy:
        cfg.DATASET.SAMPLING_STRATEGY = args.sampling_strategy
    if args.val_metric:
        cfg.VAL.METRIC = args.val_metric
    if args.val_batch_size:
        cfg.VAL.BATCH_SIZE = int(args.val_batch_size)
    if args.n_classes:
        if cfg.MODEL.ARCH == "3dresnet":
            cfg.RESNET.N_CLASSES = args.n_classes
        else:
            print("n_classes override only implemented for 3dresnet")


def load_config(args) -> ConfigNode:
    """defaults -> YAML -> opts -> flags (reference config/m_parser.py:164-174)."""
    cfg = get_cfg()
    if getattr(args, "cfg_file", None) is not None:
        cfg.merge_from_file(args.cfg_file)
    if getattr(args, "opts", None):
        cfg.merge_from_list(args.opts)
    overwrite_default_configs(cfg, args)
    return cfg
