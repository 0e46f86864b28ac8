"""Append-only txt metric logs (counterpart of the JAX package's
``utils/meters.py::append_metric_line``)."""

from __future__ import annotations

import os


def append_metric_line(output_path: str, filename: str, line: str) -> None:
    """Append to <out>/tnet_checkpoints/<filename> like the reference logs."""
    log_dir = os.path.join(output_path, "tnet_checkpoints")
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, filename), "a") as f:
        f.write(line.rstrip("\n") + "\n")
