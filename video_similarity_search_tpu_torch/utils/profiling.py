"""Step tracing and throughput (port of the JAX package's
``utils/profiling.py``, with ``torch.profiler`` in place of
``jax.profiler``).

Set ``TPU.PROFILE_DIR`` and the train driver traces epoch 0's steps 5-9
(host and, on a CUDA machine, device activity) into a Chrome trace under
that directory; the epoch logs carry the clips/s of ``Throughput``.
"""

from __future__ import annotations

import os
import time
from typing import Optional


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
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self._prof.export_chrome_trace(os.path.join(
            self.out_dir,
            f"trace_steps{self.start}-{self.start + self.num - 1}.json"))
        self._prof = None
        self._done = True


class Throughput:
    """Per-epoch items/s, the first step excluded (it builds
    cuDNN plans and warms the allocator), so the rate is the steady one."""

    def __init__(self):
        self.t0: Optional[float] = None
        self.steps = 0
        self.items = 0

    def tick(self, n_items: int) -> None:
        if self.t0 is None:
            self.t0 = time.perf_counter()
            return
        self.steps += 1
        self.items += n_items

    @property
    def items_per_sec(self) -> float:
        if self.t0 is None or self.steps == 0:
            return 0.0
        return self.items / (time.perf_counter() - self.t0)
