"""Whole runs of the harness on the CPU (its look for a card skipped) with
the timed path broken underneath: ``correct`` has to come out false, once
for each fault a cell can have. Beside them, the control: the reference
computed in fp8 fails one of each training cell's limits."""

import json
import os

import pytest
import torch

from port_bench import common, run
from port_bench.tests._tiny import BENCH, FED, SCALE, SEED, run_tiny

STEP_CELLS = ["r3d18.triplet_step", "slowfast50.triplet_step", FED]


def _false(cell):
    res = run_tiny(cell, steps=2)["result"]
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", STEP_CELLS)
def test_state_left_unchanged(cell, monkeypatch):
    monkeypatch.setattr(torch.optim.SGD, "step",
                        lambda self, closure=None: None)
    _false(cell)


@pytest.mark.parametrize("cell", STEP_CELLS)
def test_half_of_the_batch_left_out(cell, monkeypatch):
    from video_similarity_search_tpu_torch.train import driver

    real = driver._device_batch

    def half(batch, cfg, generator, train, device, accum=1):
        out = real(batch, cfg, generator, train, device, accum)
        b = out["anchor"].shape[0]
        h = b // 2
        for k in ("anchor", "positive", "extra"):
            if k in out:
                out[k] = out[k][:h]
        t = out["targets"]
        out["targets"] = torch.cat([t[:h], t[b:b + h]])
        return out

    monkeypatch.setattr(driver, "_device_batch", half)
    _false(cell)


@pytest.mark.parametrize("cell", STEP_CELLS)
def test_the_miners_answer_altered(cell, monkeypatch):
    """Each pair's negative moved to the next candidate where the miner
    picks it."""
    from video_similarity_search_tpu_torch.losses import triplet

    real = triplet.select_negative_indices

    def moved(pair_loss, *args, **kwargs):
        return (real(pair_loss, *args, **kwargs) + 1) % pair_loss.shape[-1]

    monkeypatch.setattr(triplet, "select_negative_indices", moved)
    _false(cell)


def test_a_decoded_clip_altered(monkeypatch):
    """Each RGB clip the loader crops comes out at half its levels."""
    from video_similarity_search_tpu_torch.data import datasets

    real = datasets.ClipReader._read_rgb_rrc
    monkeypatch.setattr(datasets.ClipReader, "_read_rgb_rrc",
                        lambda self, *a: real(self, *a) // 2)
    _false(FED)


def _embed_fault(monkeypatch, alter):
    from video_similarity_search_tpu_torch.evaluation import embed

    real = embed.make_embed_step

    def make(cfg, model, device="cuda"):
        step = real(cfg, model, device)
        return lambda clips: alter(step(clips))

    monkeypatch.setattr(embed, "make_embed_step", make)
    _false("r3d18.embed_pass")


def test_an_embedding_altered(monkeypatch):
    def alter(e):
        e = e.clone()
        e[0] = -e[0]
        return e
    _embed_fault(monkeypatch, alter)


def test_half_of_the_embedding_batch_left_out(monkeypatch):
    def alter(e):
        e = e.clone()
        e[e.shape[0] // 2:] = e[:e.shape[0] - e.shape[0] // 2].mean(0)
        return e
    _embed_fault(monkeypatch, alter)


def _ctx(cell):
    workload = common.load_json("workloads", cell + ".json")
    conf = next(c for c in BENCH["configs"]
                if c["name"] == workload["config"])
    with open(os.path.join(run.ROOT, conf["file"])) as f:
        config = json.load(f)
    return common.Ctx(workload=workload, config=config, seed=SEED,
                      seconds=0.0, trace=False, device=torch.device("cpu"),
                      scale=dict(SCALE[cell]))


@pytest.mark.parametrize("cell", STEP_CELLS + ["r3d18.embed_pass"])
def test_the_control_fails_a_limit(cell):
    """The reference in fp8 in the program's place: at least one number
    over its limit (on the card the readings are taken at the cell's own
    size: PERF.md)."""
    import importlib

    torch.set_num_threads(4)
    ctx = _ctx(cell)
    traffic = importlib.import_module("port_bench.traffic."
                                      + ctx.workload["traffic"])
    out = traffic.calibrate(ctx, control=True)
    limits = ctx.workload["limits"]
    assert all(out["program"][k] <= v for k, v in limits.items())
    assert any(out["control"][k] > v for k, v in limits.items()), \
        out["control"]
