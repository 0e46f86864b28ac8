"""The cell ``s3d.moco_ubernce_step`` and the held four-card cell
``r3d18.triplet_step_dp4`` on the CPU at tiny sizes: each traffic kind
runs end to end (the data-parallel one on 2 gloo ranks, which take the
same number of steps), each fault that the check is there to catch (the
MoCo step's, and the exchanges between the cards left out) turns a run's
``correct`` false, the fp8 control fails a limit, and the readers of the
new spans (``key_fwd_ms``, ``momentum_ms``, ``momentum_launches``,
``grad_allreduce_ms``, ``bn_allreduce_ms``) give numbers on traces in
``common.reduce_profile``'s form, and None on a program without the spans.

Importing this module gives ``_tiny.SCALE`` the MoCo cell's tiny sizes, so
that the whole-harness tests of ``test_port_bench_traffic.py`` run it too
when the folder is collected.
"""

import copy
import importlib
import json
import os

import pytest
import torch

from port_bench import common, run
from port_bench.tests import _tiny
from port_bench.tests._tiny import BENCH, SEED, run_tiny

MOCO, DP = "s3d.moco_ubernce_step", "r3d18.triplet_step_dp4"
_tiny.SCALE.setdefault(MOCO, {
    "cfg.TRAIN.BATCH_SIZE": 4, "cfg.DATA.SAMPLE_DURATION": 8,
    "cfg.DATA.SAMPLE_SIZE": 32, "cfg.LOSS.K": 16, "frame_hw": 32,
    "pool_batches": 4, "classes": 3})
DP_SCALE = {
    "cfg.DATA.SAMPLE_DURATION": 4, "cfg.DATA.SAMPLE_SIZE": 16,
    "frame_hw": 16, "pool_batches": 4, "classes": 3,
    "anchors_per_rank": 2, "ranks": 2, "rank_timeout_s": 120, "threads": 2}

# the four-card cell's files are in place but it is no cell of
# BENCHMARK.json (two sets of its runs have yet to show a spread within
# train_clips_per_s's bound: PERF.md); its entries, as a later change
# would add them
DP_ENTRIES = {
    "workloads": [{"name": DP, "config": "r3d18_slic",
                   "traffic": "triplet_step_dp", "chips": 4,
                   "why": "SLIC pretraining on one 4-GPU node"}],
    "per_layer": [
        {"name": name, "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "collectives",
         "moves": "train_clips_per_s", "workloads": [DP]}
        for name in ("grad_allreduce_ms", "bn_allreduce_ms")],
}
DP_SHARED = ("train_clips_per_s", "augment_ms", "forward_loss_ms",
             "backward_ms", "train_step_mfu", "device_idle_pct.train",
             "upload_ms", "idle_wait_ms", "host_waits", "stem_fwd_ms",
             "augment_span_ms")


def bench_with_dp() -> dict:
    bench = copy.deepcopy(BENCH)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in DP_SHARED:
            m["workloads"].append(DP)
    for key, entries in DP_ENTRIES.items():
        bench[key] += copy.deepcopy(entries)
    return bench


def run_dp(steps: int, trace: bool = False, **scale) -> dict:
    torch.set_num_threads(2)
    return run.run_cell(bench_with_dp(), DP, SEED, 600.0, trace,
                        torch.device("cpu"),
                        scale={**DP_SCALE, "window_steps": steps, **scale})


def _scale(cell):
    return dict(_tiny.SCALE[cell] if cell == MOCO else DP_SCALE)


def _ctx(cell):
    workload = common.load_json("workloads", cell + ".json")
    conf = next(c for c in BENCH["configs"]
                if c["name"] == workload["config"])
    with open(os.path.join(run.ROOT, conf["file"])) as f:
        config = json.load(f)
    return common.Ctx(workload=workload, config=config, seed=SEED,
                      seconds=0.0, trace=False, device=torch.device("cpu"),
                      scale=_scale(cell))


@pytest.mark.parametrize("cell", [MOCO, DP])
def test_cell_runs_end_to_end(cell):
    res = (run_tiny(cell, steps=3) if cell == MOCO
           else run_dp(steps=3))["result"]
    assert res["correct"], res["checks"]
    assert res["attempted"] == 3
    assert set(res["metrics"]) == {"train_clips_per_s", "setup_s"}


def test_held_cell_traced_reads_only_its_metrics():
    bench = bench_with_dp()
    res = run_dp(steps=3, trace=True)["result"]
    assert res["correct"], res["checks"]
    assert "breakdown" in res and res["device"]["busy_s"] == 0.0
    assert set(res["metrics"]) <= {
        m["name"] for m in run.cell_metrics(bench, DP, "per_layer")}
    assert {m["name"] for m in run.cell_metrics(bench, DP, "end_to_end")} \
        == {"train_clips_per_s", "setup_s"}
    json.dumps(res)


def test_ranks_take_the_same_number_of_steps():
    from port_bench.traffic import triplet_step_dp as dp

    torch.set_num_threads(2)
    ctx = _ctx(DP)
    ctx.seconds, ctx.scale["window_steps"] = 600.0, 4
    out = dp.drive(ctx, window=True)
    assert out["steps_agree"] and out["window"]["steps"] == 4
    assert out["window"]["clips"] == 2 * 2 * 3  # ranks x anchors x views


# --------------------------------------------------------------------------
# the faults

@pytest.mark.parametrize("fault", ["grad_sum_skipped", "bn_local_stats"])
def test_exchange_between_the_cards_left_out(fault):
    """Every rank's gradients left unsummed, or BatchNorm on each rank's
    own statistics: the data-parallel check fails."""
    res = run_dp(steps=2, fault=fault)["result"]
    assert not res["correct"], res["checks"]


def test_a_planted_fault_is_taken_out_again():
    from video_similarity_search_tpu_torch.models import layers
    from video_similarity_search_tpu_torch.train import steps

    from port_bench.traffic import triplet_step_dp as dp

    before = steps.sum_gradients, layers.pdist
    for fault in dp.FAULTS:
        with dp.planted(fault):
            assert (steps.sum_gradients, layers.pdist) != before
        assert (steps.sum_gradients, layers.pdist) == before


def _false():
    res = run_tiny(MOCO, steps=2)["result"]
    assert not res["correct"], res["checks"]


def test_momentum_update_skipped(monkeypatch):
    from video_similarity_search_tpu_torch.models import moco

    monkeypatch.setattr(moco.MoCoBank, "momentum_update",
                        lambda self, query, m=0.999: None)
    _false()


def test_enqueue_skipped(monkeypatch):
    from video_similarity_search_tpu_torch.models import moco

    monkeypatch.setattr(moco.MoCoBank, "dequeue_and_enqueue",
                        lambda self, keys, labels=None: None)
    _false()


def test_enqueue_at_the_wrong_slot(monkeypatch):
    from video_similarity_search_tpu_torch.models import moco

    real = moco.MoCoBank.dequeue_and_enqueue

    def shifted(self, keys, labels=None):  # each batch a batch further on
        real(self, keys, labels)
        self.queue_ptr.copy_((self.queue_ptr + keys.shape[0])
                             % self.queue.shape[0])

    monkeypatch.setattr(moco.MoCoBank, "dequeue_and_enqueue", shifted)
    _false()


def test_keys_from_the_query_encoder(monkeypatch):
    from video_similarity_search_tpu_torch.models import moco

    real = moco.infonce_forward

    def query_keys(encoder, bank, x1, x2, T=0.07):
        logits, labels, _ = real(encoder, bank, x1, x2, T)
        with torch.no_grad():
            k = moco._l2norm(encoder(x2).float())
        l_pos = (moco._l2norm(encoder(x1).float()) * k).sum(1, keepdim=True)
        return torch.cat([l_pos, logits[:, 1:]], dim=1), labels, k

    monkeypatch.setattr(moco, "infonce_forward", query_keys)
    _false()


def test_queue_labels_ignored(monkeypatch):
    from video_similarity_search_tpu_torch.train import steps

    real = steps.ubernce_forward

    def infonce(encoder, bank, x1, x2, batch_labels, T=0.07):
        logits, mask, k = real(encoder, bank, x1, x2, batch_labels, T)
        only = torch.zeros_like(mask)
        only[:, 0] = True
        return logits, only, k

    monkeypatch.setattr(steps, "ubernce_forward", infonce)
    _false()


@pytest.mark.parametrize("cell", [MOCO, DP])
def test_the_control_fails_a_limit(cell):
    """The reference in fp8 in the program's place: at least one number
    over its limit, the program's own within every limit."""
    torch.set_num_threads(4)
    ctx = _ctx(cell)
    traffic = importlib.import_module("port_bench.traffic."
                                      + ctx.workload["traffic"])
    out = traffic.calibrate(ctx, control=True)
    limits = ctx.workload["limits"]
    assert all(out["program"][k] <= v for k, v in limits.items()), \
        out["program"]
    assert any(out["control"][k] > v for k, v in limits.items()), \
        out["control"]


# --------------------------------------------------------------------------
# the readers of the new spans

NEW = ("key_fwd_ms", "momentum_ms", "momentum_launches",
       "grad_allreduce_ms", "bn_allreduce_ms")
SPAN = {"key_fwd_ms": "moco.keys", "momentum_ms": "moco.momentum",
        "momentum_launches": "moco.momentum",
        "grad_allreduce_ms": "dist.sum_gradients",
        "bn_allreduce_ms": "dist.bn_stats"}


def _trace(spans, ops, device, steps=2):
    return {"spans": spans, "ops": list(ops), "device": list(device),
            "steps": steps, "window_s": 1e-3}


@pytest.mark.parametrize("name", NEW)
def test_reader_counts_what_its_span_launched(name):
    span = SPAN[name]
    k = "ncclKernel_AllReduce" if "allreduce" in name else "mul_kernel"
    copy = "Memcpy DtoD (Device -> Device)"
    spans = {"driver.step": [(0, 1000)], "step.forward_loss": [(0, 400)],
             span: [(100, 200), (600, 700)]}
    ops = [(110, [(k, 30.0)]), (150, [(k, 20.0), (copy, 5.0)]),
           (650, [(k, 10.0)]), (300, [(k, 400.0)])]  # the last outside
    device = [(k, 1000, 1030), (k, 1040, 1060), (copy, 1070, 1075),
              (k, 1080, 1090), (k, 1100, 1500)]
    got = run.load_metric(name).read(_trace(spans, ops, device))
    if name == "momentum_launches":
        assert got == pytest.approx(4 / 2)  # kernels and the copy
    else:
        assert got == pytest.approx((30 + 20 + 10) / 1e3 / 2)


@pytest.mark.parametrize("name", NEW)
def test_reader_is_silent_without_its_span(name):
    """The parent's program opens none of the new spans."""
    spans = {"driver.step": [(0, 1000)], "step.forward_loss": [(0, 400)]}
    tr = _trace(spans, [(10, [("k", 5.0)])], [("k", 0, 5)])
    assert run.load_metric(name).read(tr) is None


def test_moco_readers_on_a_recorded_step():
    """A tiny UberNCE step recorded by the profiler on the CPU, each host
    op that ran inside a span standing for a kernel of its own duration:
    the MoCo readers find their spans, once a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from port_bench.traffic import moco_ubernce_step as m

    torch.set_num_threads(2)
    s = m.Setup(_ctx(MOCO), warm=False)
    batches = [s.batch(i) for i in range(2)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s._run_epoch(batches, s.step_fn, 0)
    spans, ops, device = {}, [], []
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        r = e.time_range
        spans.setdefault(e.name, []).append((r.start, r.end))
        if e.name.startswith("aten::") and not e.cpu_children:
            ops.append((r.start, [(e.name, r.end - r.start)]))
            device.append((e.name, r.start, r.end))
    tr = _trace(spans, ops, device, steps=2)
    for name in ("moco.keys", "moco.momentum", "moco.enqueue"):
        assert len(spans[name]) == 2, name
    for name in ("key_fwd_ms", "momentum_ms", "momentum_launches"):
        assert run.load_metric(name).read(tr) > 0, name


def test_s3d_flops_near_the_published_count():
    """S3D's forward by hooks over the reference at 64x224x224 (the
    paper's input): within 10% of its 66.38 G multiply-adds (the hooks
    count 71.9 G, the head's 1.2 M included); a step's clip at 32x128x128
    counts the pair's query forward and backward and its key forward,
    halved."""
    from port_bench import flops
    from port_bench.reference import moco_s3d as r
    from port_bench.traffic import moco_ubernce_step as m

    with torch.device("meta"):
        model = r.MoCoS3D().eval()
        clip = torch.empty((1, 64, 224, 224, 3))
    c = flops.model_flops_per_clip(model, clip, r.stems(model))
    assert abs(c["forward"] / (2 * 66.38e9) - 1) < 0.1
    conf = _ctx(MOCO).config
    with torch.device("meta"):
        model = r.MoCoS3D().eval()
        small = flops.model_flops_per_clip(
            model, torch.empty((1, 32, 128, 128, 3)), r.stems(model))
    assert small["first"] > 0
    assert m.clip_flops(conf) == pytest.approx(
        (4 * small["forward"] - small["first"]) / 2)
