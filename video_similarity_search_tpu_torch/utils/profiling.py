"""Step tracing and throughput (port of the JAX package's
``utils/profiling.py``, with ``torch.profiler`` in place of
``jax.profiler``).

``span(name)`` marks where the port's work happens: the train steps'
ranges (``train/steps.py::RANGES``), the batch's upload and augmentation
and the host's read of the deferred step metrics (``train/driver.py``),
the embedding pass's upload, forward and read-back
(``evaluation/embed.py``) and the stems of the 3-D ResNets and SlowFast
(``models/``). A span is a ``record_function`` range while a profiler is
recording, so it sits on the profiler's clock beside the kernels and
copies it launched; otherwise it costs one check.

Set ``TPU.PROFILE_DIR`` and the epoch loop of every loss
(``train/driver.py::_train_epoch``) traces epoch 0's steps 5-9 (host and,
on a CUDA machine, device activity, with the spans) into a Chrome trace
under that directory; the epoch logs carry the clips/s of
``Throughput``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range called ``name`` while a profiler is
    recording, else one shared null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


class StepProfiler:
    """Traces steps [start, start + num) with ``torch.profiler``. No-op
    when ``out_dir`` is empty. Call ``step(idx)`` before each train step;
    the trace starts before step ``start`` and is written after step
    ``start + num - 1`` (or at ``close()``) as
    ``<out_dir>/trace_steps<start>-<end>.json``."""

    def __init__(self, out_dir: Optional[str], start: int = 5, num: int = 5):
        self.out_dir = out_dir or ""
        self.start = start
        self.num = num
        self._prof = None
        self._done = False

    def step(self, idx: int) -> None:
        if not self.out_dir or self._done:
            return
        if self._prof is None and idx == self.start:
            import torch.profiler as tp

            os.makedirs(self.out_dir, exist_ok=True)
            activities = [tp.ProfilerActivity.CPU]
            if tp.ProfilerActivity.CUDA in tp.supported_activities():
                activities.append(tp.ProfilerActivity.CUDA)
            self._prof = tp.profile(activities=activities)
            self._prof.__enter__()
        elif self._prof is not None and idx >= self.start + self.num:
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self._prof.export_chrome_trace(os.path.join(
            self.out_dir,
            f"trace_steps{self.start}-{self.start + self.num - 1}.json"))
        self._prof = None
        self._done = True


class Throughput:
    """Per-epoch items/s of the steps the card has finished. Call
    ``done(n)`` where the host has read back the metrics of steps that
    hold ``n`` items (``n`` 0: none were read). The first call starts the clock and its items are
    not counted: the epochs read their first step back alone, so the
    rate leaves out that step (it builds cuDNN plans and warms the
    allocator) and is the steady one."""

    def __init__(self):
        self.t0: Optional[float] = None
        self.t: Optional[float] = None
        self.items = 0

    def done(self, n_items: int) -> None:
        if not n_items:
            return
        now = time.perf_counter()
        if self.t0 is None:
            self.t0 = now
            return
        self.items += n_items
        self.t = now

    @property
    def items_per_sec(self) -> float:
        if self.t is None or self.t <= self.t0:
            return 0.0
        return self.items / (self.t - self.t0)
