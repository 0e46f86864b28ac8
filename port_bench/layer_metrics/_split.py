"""Device time of the kernels launched inside named host spans.

Copied from ``chip_smoke.py::device_split_ms`` at commit
f61503500a14f114e7bf022962bdb138585f8add: each kernel goes to the span
whose host-time interval holds the start of the op that launched it
(autograd runs the backward's ops on its own thread, inside the host span
of the step's backward range). ``RANGES`` are the program's step ranges
(``train/steps.py::RANGES`` at that commit).
"""

from __future__ import annotations

from typing import Optional, Sequence

RANGES = ("step.forward_loss", "step.backward", "step.optimizer")


def _inside(t: float, spans) -> bool:
    return any(a <= t < b for a, b in spans)


def device_ms(trace: dict, names: Sequence[str],
              exclude: Sequence[str] = ()) -> Optional[float]:
    """Device ms a step of the kernels (copies left out) whose launching
    op starts inside a span of ``names`` and inside none of ``exclude``;
    None when the traced sub-window holds no step or no device work."""
    if not trace["steps"] or not trace["device"]:
        return None
    spans = [s for n in names for s in trace["spans"].get(n, ())]
    skip = [s for n in exclude for s in trace["spans"].get(n, ())]
    if not spans:
        return None
    total = 0.0
    for start, kernels in trace["ops"]:
        if _inside(start, spans) and not _inside(start, skip):
            total += sum(us for name, us in kernels
                         if not name.startswith("Memcpy"))
    return total / 1e3 / trace["steps"]


def idle_pct(trace: dict) -> Optional[float]:
    """Share of the traced sub-window in which no kernel or copy ran."""
    from port_bench.common import busy_s

    if not trace["device"] or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - busy_s(trace) / trace["window_s"])


def mfu(trace: dict, flops_per_item: float, items_per_step: float):
    """Model FLOPs of the steps outside the traced sub-window over their
    host seconds, as a share of the card's dense bf16 peak."""
    from port_bench.flops import bf16_peak

    kind = trace.get("device_kind", "")
    if "H100" not in kind or trace["outside_s"] <= 0:
        return None
    rate = flops_per_item * items_per_step * trace["outside_steps"] \
        / trace["outside_s"]
    return 100.0 * rate / bf16_peak(kind)
