#!/usr/bin/env python3
"""Run one cell of the benchmark of ``video_similarity_search_tpu_torch``
on the card this machine holds.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``. Its data file
``port_bench/workloads/<cell>.json`` names the configuration and the
traffic kind, whose module ``port_bench/traffic/<kind>.py`` sets the cell up
and runs the window; each per-layer metric is read by
``port_bench/layer_metrics/<metric>.py``. With ``--trace 0`` the result
carries the cell's end-to-end metrics, with ``--trace 1`` its per-layer
ones, read from a profiled sub-window.

The last line of standard output is the result's JSON object; earlier
lines carry the step-time percentiles, the peak memory, the card's clock
and power and the counts. The numbers that decide ``correct``, each beside
its limit, are the last lines of standard error and the result's last key.
Without a CUDA card the run fails and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
# top-level module names that may not be loaded in the process that
# prints the result (the JAX package is the port's reference, not the
# program)
FORBIDDEN = ("jax", "jaxlib", "flax", "video_similarity_search_tpu")


def set_environment() -> None:
    """Kernel and build caches at fixed places inside the checkout."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(CACHE, "inductor")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def metric_file(name: str) -> str:
    """The reader of a per-layer metric: ``layer_metrics/<name>.py``, else
    that of the name less its last dotted part, and so on, so that
    ``device_idle_pct.embed`` is read by ``device_idle_pct.py`` unless a
    file of its own is there."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        path = os.path.join(HERE, "layer_metrics",
                            ".".join(parts[:n]) + ".py")
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(f"no reader for the metric {name!r} under "
                            f"{os.path.join(HERE, 'layer_metrics')}")


def load_metric(name: str):
    """The module that reads ``name`` (``metric_file``)."""
    path = metric_file(name)
    spec = importlib.util.spec_from_file_location(
        "port_bench.layer_metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The cell's ``end_to_end`` or ``per_layer`` entries."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in reported
                             else [])]


def run_cell(bench: dict, cell: str, seed: int, seconds: float,
             trace: bool, device, scale=None) -> dict:
    """One run -> {"result": the result's object, "info": the earlier
    line's}. ``scale`` overrides traffic parameters (tests)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from port_bench import common

    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    workload = common.load_json("workloads", cell + ".json")
    conf_entry = next(c for c in bench["configs"]
                      if c["name"] == entry["config"])
    with open(os.path.join(ROOT, conf_entry["file"])) as f:
        config = json.load(f)
    traffic = importlib.import_module(
        "port_bench.traffic." + workload["traffic"])
    ctx = common.Ctx(workload=workload, config=config, seed=seed,
                     seconds=seconds, trace=trace, device=device,
                     scale=dict(scale or {}), t_start=T0)
    smi_before = common.nvidia_smi() if device.type == "cuda" else None
    cpu_before = common.cpu_seconds()
    out = traffic.run(ctx)
    cpu_s = common.cpu_seconds() - cpu_before
    limits = workload["limits"]
    numbers = {k: v for k, v in out["numbers"].items()
               if not k.startswith("_")}
    correct = all(math.isfinite(numbers[k]) and numbers[k] <= lim
                  for k, lim in limits.items())
    dev_info = common.device_info(device, int(out["peak"]))
    metrics, brk = {}, None
    if not trace:
        for m in cell_metrics(bench, cell, "end_to_end"):
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    else:
        win = out["window"]["win"]
        tr = common.reduce_profile(out["window"]["prof"], win,
                                   {**out["trace_extra"],
                                    "device_kind": dev_info["kind"]})
        for m in cell_metrics(bench, cell, "per_layer"):
            value = load_metric(m["name"]).read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info["busy_s"] = common.busy_s(tr)
        dev_info["window_s"] = tr["window_s"]
        brk = common.breakdown(tr, [common.LOADER_SPAN,
                                    workload["step_span"]])
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": dev_info}
    if brk is not None:
        result["breakdown"] = brk
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in limits}
    info = {"cell": cell, "seed": seed, "trace": bool(trace),
            "nvidia_smi_before": smi_before,
            "nvidia_smi_after": (common.nvidia_smi()
                                 if device.type == "cuda" else None),
            "memory_peak_gib": int(out["peak"]) / 2 ** 30,
            "host_cpu_s": cpu_s, "torch_threads": torch.get_num_threads(),
            "numbers_detail": out["numbers"].get("_leaves"),
            **out["info"]}
    return {"result": result, "info": info}


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    set_environment()
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = [w for w in bench["workloads"] if w["name"] == args.workload]
    if not entry:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < entry[0]["chips"]):
        print(f"{args.workload} needs {entry[0]['chips']} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ": no result", file=sys.stderr)
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda", 0))
    leaked = forbidden_modules()
    if leaked:
        print(f"modules that the benchmark may not load are loaded: "
              f"{leaked}; no result", file=sys.stderr)
        return 3
    print(json.dumps({"info": out["info"]}), flush=True)
    for name, c in out["result"]["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
