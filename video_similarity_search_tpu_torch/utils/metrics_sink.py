"""Live scalar-metrics sink: CSV per step, tensorboard events when a writer
is importable (the port's copy of the JAX package's
``utils/metrics_sink.py``; reference PlotterThread,
coclr_utils/tensorboard_utils.py:7-31, written synchronously here)."""

from __future__ import annotations

import importlib
import os
from typing import Optional


class MetricsSink:
    """Append ``(step, tag, value)`` scalars to ``<logdir>/scalars.csv``
    (and tensorboard events when tensorboardX or
    torch.utils.tensorboard imports). A disabled sink does nothing, so
    call sites never branch."""

    def __init__(self, logdir: Optional[str], enabled: bool = True):
        self.enabled = bool(enabled and logdir)
        self._tb = None
        self._csv = None
        if not self.enabled:
            return
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(logdir, "scalars.csv")
        new = not os.path.exists(path)
        self._csv = open(path, "a", buffering=1)  # line-buffered
        if new:
            self._csv.write("step,tag,value\n")
        for mod in ("tensorboardX", "torch.utils.tensorboard"):
            try:
                self._tb = importlib.import_module(mod).SummaryWriter(logdir)
                break
            except Exception:  # noqa: BLE001 — a missing or broken backend
                continue

    def add_scalar(self, tag: str, value, step: int) -> None:
        if not self.enabled:
            return
        self._csv.write(f"{int(step)},{tag},{float(value):.6g}\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def close(self) -> None:
        if self._csv is not None:
            self._csv.close()
        if self._tb is not None:
            self._tb.close()
