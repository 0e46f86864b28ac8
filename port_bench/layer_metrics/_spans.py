"""What the readers of the program's own spans share: the host intervals
of named spans, the device time of the copies launched inside them, the
device's idle gaps charged to the span the host was in when each opened,
and the runtime calls made inside spans. Each reader keeps its own frozen
copy of the span names it reads; each returns None where the traced
sub-window holds no step, no device work or none of its spans (a program
without them)."""

from __future__ import annotations

from collections import Counter
from typing import Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]


def spans(trace: dict, names: Sequence[str] = (),
          suffix: Optional[str] = None) -> List[Interval]:
    """Host (start_us, end_us) of every span named in ``names`` or whose
    name ends in ``suffix``."""
    return [iv for name, ivs in trace["spans"].items()
            if name in names or (suffix is not None and name.endswith(suffix))
            for iv in ivs]


def _inside(t: float, ivs: Iterable[Interval]) -> bool:
    return any(a <= t < b for a, b in ivs)


def _usable(trace: dict, ivs: List[Interval]) -> bool:
    return bool(trace["steps"] and trace["device"] and ivs)


def copy_ms(trace: dict, ivs: List[Interval],
            prefix: str) -> Optional[float]:
    """Device ms a step of the copies whose name starts with ``prefix``
    and whose launching op starts inside one of ``ivs``. The profiler
    can link one copy to two nested host ops; a copy of a given name and
    duration counts at most as often as the device timeline holds it."""
    if not _usable(trace, ivs):
        return None
    linked = Counter((name, us) for start, kernels in trace["ops"]
                     if _inside(start, ivs)
                     for name, us in kernels if name.startswith(prefix))
    ran = Counter((name, e - s) for name, s, e in trace["device"]
                  if name.startswith(prefix))
    total = sum(key[1] * min(n, ran[key]) for key, n in linked.items())
    return total / 1e3 / trace["steps"]


def idle_gaps(trace: dict) -> List[Interval]:
    """The device's idle gaps: the spaces between the merged busy
    intervals of the traced sub-window (as ``common.breakdown`` forms
    them)."""
    from port_bench.common import union_us

    busy = union_us((s, e) for _, s, e in trace["device"])
    return [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]


def gap_ms(trace: dict, ivs: List[Interval]) -> Optional[float]:
    """Device-idle ms a step in the gaps that open while the host is
    inside one of ``ivs``: where the card ran out of work, the span the
    host was in is what left it idle."""
    if not _usable(trace, ivs):
        return None
    total = sum(e - s for s, e in idle_gaps(trace) if _inside(s, ivs))
    return total / 1e3 / trace["steps"]


def calls_inside(trace: dict, calls: Sequence[str],
                 ivs: List[Interval]) -> Optional[float]:
    """Host calls named in ``calls`` a step whose whole host interval lies
    inside one of ``ivs``."""
    if not _usable(trace, ivs):
        return None
    n = sum(1 for name in calls for s, e in trace["spans"].get(name, ())
            if any(a <= s and e <= b for a, b in ivs))
    return n / trace["steps"]
