"""What every traffic module shares: the configuration, seeded weights, the
window's loader, the benchmark's spans, the profiler and its reduction to
device time, and the comparison of norms that decides ``correct``.

Nothing here imports the program at module level: the program is
imported by the traffic modules, inside their functions.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# the last BatchNorm of a bottleneck starts at zero scale (Goyal et al.,
# 2017; pyslowfast's ZERO_INIT_FINAL_BN), so each residual branch starts
# as nothing
ZERO_SCALE = "branch2.c_bn.weight"

# spans the benchmark opens around its calls into the program (traced runs)
LOADER_SPAN = "loader.next"
# a traced run profiles TRACE_N steps or batches from the TRACE_AT-th on
TRACE_AT, TRACE_N = 2, 4


def load_json(*parts: str) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


@dataclass
class Ctx:
    """One run: the cell, its configuration, the seed and the device.
    ``scale`` overrides traffic parameters (the CPU tests' tiny sizes)."""

    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    scale: dict = field(default_factory=dict)
    t_start: float = field(default_factory=time.perf_counter)

    def param(self, key: str):
        return self.scale.get(key, self.workload["traffic_params"][key])


def port_cfg(ctx: Ctx):
    """The program's config: ``get_cfg()``'s defaults, then the
    configuration file's ``overrides`` and the scale's (``cfg.<KEY>``),
    with OUTPUT_PATH under the run's temporary directory."""
    from video_similarity_search_tpu_torch.config import get_cfg

    cfg = get_cfg()
    opts = list(ctx.config["overrides"])
    for k, v in ctx.scale.items():
        if k.startswith("cfg."):
            opts += [k[4:], v]
    out = os.path.join(tempfile.gettempdir(), "port_bench_output")
    cfg.merge_from_list([str(v) for v in opts] + ["OUTPUT_PATH", out])
    return cfg


# --------------------------------------------------------------------------
# weights from the seed

def seeded_state(state: Dict[str, torch.Tensor], seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """A state dict with ``state``'s keys and shapes, drawn on ``device``
    from ``seed`` in one normal draw: convolutions He-normal over their
    fan-out, dense layers normal over 1 / sqrt(fan-in), BatchNorm scales
    1 + 0.1 z and shifts 0.1 z, running means 0.1 z and variances
    exp(0.2 z), other biases 0.01 z. Every float32 leaf is drawn; the
    rest (batch counters) keep their values. The last BatchNorm of each
    bottleneck (``ZERO_SCALE``) starts at zero scale, so its branch's
    earlier convolutions and BatchNorms get no gradient in the first
    step; R3D-18's basic blocks have no such leaf."""
    floats = [k for k, v in state.items() if v.is_floating_point()]
    total = sum(state[k].numel() for k in floats)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    z = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, off = {}, 0
    for k, v in state.items():
        if k not in floats:
            out[k] = v.to(device)
            continue
        leaf = z[off:off + v.numel()].view(v.shape)
        off += v.numel()
        prefix = k.rsplit(".", 1)[0]
        is_bn = prefix + ".running_mean" in state
        if k.endswith("running_mean"):
            leaf = 0.1 * leaf
        elif k.endswith("running_var"):
            leaf = torch.exp(0.2 * leaf)
        elif is_bn and k.endswith(ZERO_SCALE):
            leaf = 0.0 * leaf
        elif is_bn and k.endswith("weight"):
            leaf = 1.0 + 0.1 * leaf
        elif is_bn and k.endswith("bias"):
            leaf = 0.1 * leaf
        elif k.endswith("bias"):
            leaf = 0.01 * leaf
        elif v.dim() == 5:
            fan_out = v.shape[0] * v[0, 0].numel()
            leaf = leaf * math.sqrt(2.0 / fan_out)
        else:
            leaf = leaf / math.sqrt(v[0].numel())
        out[k] = leaf.contiguous()
    return out


def uint8_pool(shape, labels, classes: int, seed: int,
               device: torch.device, pin: bool) -> List[torch.Tensor]:
    """One uint8 tensor of ``shape`` for each row of ``labels`` (the class
    of each clip), drawn on ``device`` from ``seed`` and kept in (pinned)
    host memory: every clip is its class's colour, drawn once in [30, 225]
    a channel, under uniform noise of +-60 levels a pixel. Clips of one
    class then share their mean colour, as videos of one action share a
    scene, and stay apart from other classes' after the network's pooling."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) + 1)
    colors = torch.randint(30, 226, (classes, 3), generator=g, device=device,
                           dtype=torch.int16)
    out = []
    for row in labels:
        lab = torch.as_tensor(row, device=device).long()
        x = torch.randint(-60, 61, shape, generator=g, device=device,
                          dtype=torch.int16)
        x += colors[lab].view(-1, *([1] * (len(shape) - 2)), 3)
        host = torch.empty(shape, dtype=torch.uint8, pin_memory=pin)
        host.copy_(x.clamp_(0, 255).to(torch.uint8))
        out.append(host)
    return out


def cpu_seconds() -> float:
    """CPU seconds this process has used (user and system)."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# --------------------------------------------------------------------------
# the window

class Span:
    """A ``record_function`` range opened and closed by hand (traced runs
    only; a no-op otherwise)."""

    def __init__(self, on: bool):
        self.on, self.rf = on, None

    def open(self, name: str) -> None:
        self.close()
        if self.on:
            self.rf = torch.profiler.record_function(name)
            self.rf.__enter__()

    def close(self) -> None:
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None


class Window:
    """The iterable the benchmark hands the program's epoch or pass: it
    yields ``source(i)`` for i = 0, 1, ... until ``seconds`` have passed
    since the first request, then stops. The host time of each request is
    kept (``waits``), as are the request times (``stamps``). With a
    ``profiler``, a traced sub-window of TRACE_N items starts at item
    TRACE_AT and stops when the next one is asked for, each edge after a
    device synchronisation. ``step_span`` names the span
    the host is in between two requests."""

    def __init__(self, source: Callable[[int], dict], seconds: float,
                 device: torch.device, step_span: str,
                 profiler=None, limit: Optional[int] = None):
        self.source, self.seconds, self.device = source, seconds, device
        self.step_span, self.profiler = step_span, profiler
        self.limit = limit
        self.span = Span(profiler is not None)
        self.waits: List[float] = []
        self.stamps: List[float] = []
        self.t0: Optional[float] = None
        self.prof_t: List[float] = []  # [start, stop] of the sub-window
        self.paused = 0.0  # host seconds the profiler took to start, stop
        self.count = 0
        self.n_profiled = 0

    def _edge(self, i: int) -> None:
        if self.profiler is None:
            return
        if i == TRACE_AT and not self.prof_t:
            synchronize(self.device)
            t = time.perf_counter()
            self.profiler.start()
            self.prof_t.append(time.perf_counter())
            self.paused += self.prof_t[0] - t
        elif i == TRACE_AT + TRACE_N and len(self.prof_t) == 1:
            self.stop_profiler(TRACE_N)

    def stop_profiler(self, n: int) -> None:
        if len(self.prof_t) == 1:
            synchronize(self.device)
            self.prof_t.append(time.perf_counter())
            self.span.close()
            self.profiler.stop()
            self.n_profiled = n
            self.paused += time.perf_counter() - self.prof_t[1]

    def __iter__(self):
        i = 0
        while True:
            self.span.open(LOADER_SPAN)
            t = time.perf_counter()
            if self.t0 is None:
                self.t0 = t
            if t - self.t0 - self.paused >= self.seconds or i == self.limit:
                break
            batch = self.source(i)
            self.waits.append(time.perf_counter() - t)
            self.stamps.append(t)
            self._edge(i)
            self.span.open(self.step_span)
            self.count = i + 1
            yield batch
            i += 1
        self.span.close()


def run_window(win: Window, drive: Callable[[Window], object]):
    """Drive the program over ``win``, synchronise, and -> (its return,
    seconds from the first request to the synchronisation after the last
    item's work, less the profiler's own start and stop)."""
    out = drive(win)
    synchronize(win.device)
    t_end = time.perf_counter()
    paused = win.paused
    if win.profiler is not None:
        win.stop_profiler(win.count - TRACE_AT)
    t0 = win.t0 if win.t0 is not None else t_end
    return out, t_end - t0 - paused


def outside(win: Window, elapsed: float) -> dict:
    """The items, host seconds and loader waits of the window outside its
    traced sub-window (rates in a traced run are taken there)."""
    inside = (win.prof_t[1] - win.prof_t[0]) if len(win.prof_t) == 2 else 0
    lo, hi = TRACE_AT, TRACE_AT + win.n_profiled
    return {"outside_steps": win.count - win.n_profiled,
            "outside_s": elapsed - inside,
            "outside_waits_s": win.waits[:lo] + win.waits[hi:]}


def step_percentiles(stamps: List[float], t_end: float) -> dict:
    """Host ms between requests: median and 90th percentile."""
    d = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:] + [t_end])]
    if len(d) < 2:
        return {"steps": len(d)}
    q = statistics.quantiles(d, n=10)
    return {"steps": len(d), "p50_ms": statistics.median(d), "p90_ms": q[8]}


# --------------------------------------------------------------------------
# the profiler and its reduction

def make_profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def reduce_profile(prof, win: Window, extra: dict) -> dict:
    """The traced sub-window as plain data for the per-layer readers:
    ``spans`` {name: [(start_us, end_us)]} of every ``record_function``
    range, ``ops`` [(start_us, [(kernel name, us)])] of each CPU op that
    launched device work, ``device`` [(name, start_us, end_us)] of every
    device event (kernels, copies, sets), ``steps`` the items inside the
    sub-window, ``window_s`` its host seconds, and ``extra`` (the run's
    counts and rates)."""
    from torch.autograd import DeviceType

    spans, ops, dev = defaultdict(list), [], []
    for e in (prof.events() if len(win.prof_t) == 2 else ()):
        tr = e.time_range
        if e.device_type == DeviceType.CPU:
            if e.kernels:
                ops.append((tr.start, [(k.name, k.duration)
                                       for k in e.kernels]))
            spans[e.name].append((tr.start, tr.end))
        else:
            dev.append((e.name, tr.start, tr.end))
    # the device timeline also carries each host range as an annotation
    # over the kernels it launched: those are not device work
    dev = [d for d in dev if d[0] not in spans]
    window_s = win.prof_t[1] - win.prof_t[0] if len(win.prof_t) == 2 else 0.0
    out = {"spans": dict(spans), "ops": ops, "device": dev,
           "steps": win.n_profiled, "window_s": window_s}
    out.update(extra)
    return out


def union_us(intervals) -> List[tuple]:
    """Merged (start, end) intervals."""
    merged: List[list] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def busy_s(trace: dict) -> float:
    return sum(e - s for s, e in union_us(
        (s, e) for _, s, e in trace["device"])) / 1e6


def breakdown(trace: dict, host_spans) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps of the device, each named by the benchmark span the host was
    in at its midpoint."""
    per = defaultdict(float)
    for name, s, e in trace["device"]:
        per[name] += (e - s) / 1e6
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    busy = union_us((s, e) for _, s, e in trace["device"])
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    named = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = (s + e) / 2
        name = "other"
        for span in host_spans:
            if any(a <= mid < b for a, b in trace["spans"].get(span, ())):
                name = span
                break
        named.append([name, (e - s) / 1e6])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}


# --------------------------------------------------------------------------
# the comparison

def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep) -> Dict[str, float]:
    """Each leaf's |prog norm - ref norm| / max(ref norm, median ref
    norm), over the leaves in ``keep``."""
    med = statistics.median(ref[k] for k in keep)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep}


def device_info(device: torch.device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": peak}


def nvidia_smi() -> Optional[str]:
    """The card's name, power limit and draw, SM clock and temperature."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None
