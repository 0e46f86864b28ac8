"""Running metric meters and append-only txt logs (the port's copy of the
JAX package's ``utils/meters.py``; reference AverageMeter,
models/model_utils.py:214-229, and the txt metric logs
train_loss_and_acc.txt / val_loss_and_acc.txt / NMIs.txt / AMIs.txt /
global_retrieval_acc.txt)."""

from __future__ import annotations

import os


class AverageMeter:
    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def append_metric_line(output_path: str, filename: str, line: str) -> None:
    """Append to <out>/tnet_checkpoints/<filename> like the reference logs."""
    log_dir = os.path.join(output_path, "tnet_checkpoints")
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, filename), "a") as f:
        f.write(line.rstrip("\n") + "\n")
