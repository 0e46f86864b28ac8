"""Every traffic module runs a whole cell on the CPU at a tiny size, and
the harness refuses to run without a card."""

import json
import subprocess
import sys

import pytest
import torch

from port_bench import run
from port_bench.tests._tiny import CELLS, FED, bench_for, run_tiny


@pytest.mark.parametrize("cell", CELLS + [FED])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_on_the_cpu(cell, trace):
    out = run_tiny(cell, trace=trace)
    res = out["result"]
    assert res["correct"], res["checks"]
    assert res["attempted"] == 8 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "cpu"
    bench = bench_for(cell)
    want = {m["name"] for m in run.cell_metrics(bench, cell, "end_to_end")}
    if not trace:
        assert set(res["metrics"]) == want
        assert all(m["value"] > 0 for m in res["metrics"].values())
    else:
        # no device trace on the CPU: only host readings come back
        assert "breakdown" in res
        assert res["device"]["busy_s"] == 0.0
        assert set(res["metrics"]) <= {m["name"] for m in run.cell_metrics(
            bench, cell, "per_layer")}
    json.dumps(res)


def test_same_seed_same_inputs():
    a = run_tiny("r3d18.triplet_step", steps=2)["info"]["checked_losses"]
    b = run_tiny("r3d18.triplet_step", steps=2)["info"]["checked_losses"]
    c = run_tiny("r3d18.triplet_step", steps=2,
                 seed=7)["info"]["checked_losses"]
    assert a == b and a != c


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal is not reachable")
    proc = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr
