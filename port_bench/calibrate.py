#!/usr/bin/env python3
"""Readings that a cell's limits are set from, in one process: the
program's numbers against the plain reference on each of ``--seeds``, and
the control's (the reference computed in fp8 against the float32
reference) on each of ``--control-seeds``. One JSON line a seed.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3

The benchmark's own runs never run the control.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="a traffic parameter, or cfg.<KEY> of the program's "
                        "config, for every seed (a look at another "
                        "precision or size)")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import importlib

    import torch

    from port_bench import common, run

    run.set_environment()
    if not torch.cuda.is_available():
        print("calibration needs a CUDA card", file=sys.stderr)
        return 2
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next(w for w in bench["workloads"] if w["name"] == args.workload)
    workload = common.load_json("workloads", args.workload + ".json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    traffic = importlib.import_module("port_bench.traffic."
                                      + workload["traffic"])
    scale = dict(kv.split("=", 1) for kv in args.set)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in seeds + sorted(controls - set(seeds)):
        t = time.perf_counter()
        ctx = common.Ctx(workload=workload, config=config, seed=seed,
                         seconds=0.0, trace=False,
                         device=torch.device("cuda", 0), scale=scale)
        out = traffic.calibrate(ctx, control=seed in controls)
        if seed not in seeds:
            out.pop("program")
        print(json.dumps({"cell": args.workload, "seed": seed, "set": scale,
                          "seconds": time.perf_counter() - t, **out}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
