"""Tiny sizes at which every cell runs on the CPU in seconds."""

import json
import os

import torch

from port_bench import run

with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)

SCALE = {
    "r3d18.triplet_step": {"cfg.TRAIN.BATCH_SIZE": 4,
                           "cfg.DATA.SAMPLE_DURATION": 4,
                           "cfg.DATA.SAMPLE_SIZE": 16, "frame_hw": 16,
                           "pool_batches": 4, "classes": 3},
    "slowfast50.triplet_step": {"cfg.TRAIN.BATCH_SIZE": 4,
                                "cfg.DATA.SAMPLE_DURATION": 8,
                                "cfg.DATA.SAMPLE_SIZE": 32, "frame_hw": 48,
                                "pool_batches": 4, "classes": 3},
    "r3d18.fed_epoch": {"cfg.TRAIN.BATCH_SIZE": 4,
                        "cfg.DATA.SAMPLE_DURATION": 4,
                        "cfg.DATA.SAMPLE_SIZE": 16, "store_name": "ucf_tiny",
                        "store": {"classes": 4, "videos_per_class": 3,
                                  "height": 48, "width": 64,
                                  "train_frames": 8, "test_frames": 16}},
    "r3d18.embed_pass": {"cfg.DATA.SAMPLE_DURATION": 4,
                         "cfg.DATA.SAMPLE_SIZE": 16, "batch": 4,
                         "clips_per_pass": 10, "pool_batches": 3,
                         "classes": 3},
}
CELLS = [w["name"] for w in BENCH["workloads"]]

# the fed cell's files are in place but it is no cell of BENCHMARK.json
# (its host-bound runs spread by more than any bound may hold: PERF.md);
# its entries, as a later benchmark change would add them
FED = "r3d18.fed_epoch"
FED_ENTRIES = {
    "workloads": [{"name": FED, "config": "r3d18_slic",
                   "traffic": "fed_epoch", "chips": 1,
                   "why": "96 clips a step decoded from JPEGs by the "
                          "program's loader"}],
    "end_to_end": [{"name": "fed_train_clips_per_s", "unit": "clips/s",
                    "better": "higher", "bound": 0.25,
                    "source": "host_clock", "workloads": [FED]}],
    "per_layer": [
        {"name": "loader_wait_ms", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "host loader",
         "moves": "fed_train_clips_per_s", "workloads": [FED]},
        {"name": "device_idle_pct.fed", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "device",
         "moves": "fed_train_clips_per_s", "workloads": [FED]}],
}


def bench_for(cell: str) -> dict:
    if cell in CELLS:
        return BENCH
    assert cell == FED
    return {k: v + FED_ENTRIES.get(k, []) if isinstance(v, list) else v
            for k, v in BENCH.items()}
SEED = 2 ** 31 + 12345  # larger than 32 signed bits hold


def run_tiny(cell: str, trace: bool = False, steps: int = 8,
             seed: int = SEED) -> dict:
    torch.set_num_threads(4)
    scale = dict(SCALE[cell], window_steps=steps)
    return run.run_cell(bench_for(cell), cell, seed, 600.0, trace,
                        torch.device("cpu"), scale=scale)
