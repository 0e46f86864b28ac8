"""The port's spans (``utils/profiling.py::span``) on the CPU.

* Under ``torch.profiler`` a tiny R3D-18 and a tiny SlowFast triplet epoch
  through ``triplet_train_epoch`` record the batch's upload and
  augmentation, the step's three ranges, the metrics' read-back and the
  stem, each step's upload and augmentation before its forward; a tiny
  embedding pass records its upload, forward, read-back and stem once a
  batch.
* With no profiler recording, the program enters no ``record_function``
  of its own.
* ``Throughput`` counts the items of the steps whose metrics the host has
  read back, the first step left out.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from video_similarity_search_tpu_torch.config import get_cfg
from video_similarity_search_tpu_torch.evaluation import \
    get_embeddings_and_labels
from video_similarity_search_tpu_torch.models import model_selector
from video_similarity_search_tpu_torch.train import driver
from video_similarity_search_tpu_torch.train.state import make_optimizer
from video_similarity_search_tpu_torch.utils import profiling
from video_similarity_search_tpu_torch.utils.profiling import Throughput

STEP_SPANS = ("batch.upload", "batch.augment", "step.forward_loss",
              "step.backward", "step.optimizer", "metrics.drain",
              "model.stem")
EMBED_SPANS = ("embed.upload", "embed.forward", "embed.readback",
               "model.stem")
B, STEPS = 4, 3

# (overrides, views, frames on the host): R3D-18 takes pre-cropped clips
# and a third view for the local-local loss; SlowFast crops on the device
ARCHS = {
    "r3d18": (["MODEL.ARCH", "3dresnet", "RESNET.MODEL_DEPTH", 18,
               "RESNET.NO_MAX_POOl", True, "DATA.SAMPLE_SIZE", 16,
               "DATA.SAMPLE_DURATION", 4, "TPU.HOST_RRC", True,
               "LOSS.LOCAL_LOCAL_CONTRAST", True],
              ("anchor", "positive", "extra"), 16),
    "slowfast": (["MODEL.ARCH", "slowfast", "DATA.SAMPLE_SIZE", 32,
                  "DATA.SAMPLE_DURATION", 8],
                 ("anchor", "positive"), 48),
}


@pytest.fixture
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _cfg(arch: str):
    cfg = get_cfg()
    cfg.merge_from_list([str(v) for v in ARCHS[arch][0] + [
        "TRAIN.BATCH_SIZE", B, "TRAIN.LOG_INTERVAL", 2,
        "TRAIN.DATASET", "ucf101", "TPU.COMPUTE_DTYPE", "float32"]])
    return cfg


def _triplet_batches(arch: str, sizes):
    _, views, hw = ARCHS[arch]
    t = int(_cfg(arch).DATA.SAMPLE_DURATION)
    rng = np.random.default_rng(0)
    out = []
    for n in sizes:
        batch = {v: rng.integers(0, 256, (B, t, hw, hw, 3), np.uint8)
                 for v in views}
        labels = rng.integers(0, 2, B)
        batch["targets"] = np.concatenate([labels, labels])
        batch["__size__"] = n
        out.append(batch)
    return out


def _triplet_epoch(arch: str, sizes, out_dir):
    cfg = _cfg(arch)
    cfg.OUTPUT_PATH = str(out_dir)  # the epoch appends its loss line there
    torch.manual_seed(0)
    model = model_selector(cfg)
    opt, sched = make_optimizer(cfg, model.parameters())
    step_fn, epoch_fn = driver.make_train_step(cfg, model, opt, sched, {},
                                               device="cpu")
    assert epoch_fn is driver.triplet_train_epoch
    gen = torch.Generator(device="cpu")
    epoch_fn(step_fn, _triplet_batches(arch, sizes), cfg, 1, gen,
             device="cpu")


def _embed_pass(n_batches: int):
    cfg = _cfg("r3d18")
    torch.manual_seed(0)
    model = model_selector(cfg)
    rng = np.random.default_rng(1)
    batches = [{"clip": rng.integers(0, 256, (B, 4, 16, 16, 3), np.uint8),
                "target": np.zeros(B, np.int32),
                "index": np.arange(B, dtype=np.int32),
                "window_counts": np.ones(B, np.int32)}
               for _ in range(n_batches)]
    emb, _, _ = get_embeddings_and_labels(model, cfg, batches,
                                          verbose=False, device="cpu")
    assert emb.shape[0] == n_batches * B


def _profiled(fn, *args):
    """The (name, start_us, end_us) of every host event ``fn`` records
    under the profiler, by start."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(*args)
    return sorted((e.name, e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.device_type == DeviceType.CPU)


def _named(events, name):
    return [(s, e) for n, s, e in events if n == name]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_triplet_epoch_records_the_step_spans(arch, few_threads, tmp_path):
    events = _profiled(_triplet_epoch, arch, [B] * STEPS, tmp_path)
    views = ARCHS[arch][1]
    got = {name: _named(events, name) for name in STEP_SPANS}
    # each view and the targets uploaded, each view augmented
    assert len(got["batch.upload"]) == STEPS * (len(views) + 1)
    assert len(got["batch.augment"]) == STEPS * len(views)
    for name in ("step.forward_loss", "step.backward", "step.optimizer"):
        assert len(got[name]) == STEPS, name
    # read back: the first step alone, at the log interval (2), the rest
    assert len(got["metrics.drain"]) == 3
    # one forward over the views' concatenation a step
    assert len(got["model.stem"]) == STEPS
    fwd, opt = got["step.forward_loss"], got["step.optimizer"]
    for k in range(STEPS):
        after = opt[k - 1][1] if k else float("-inf")
        ups = [s for s in got["batch.upload"] if after <= s[0] < fwd[k][0]]
        augs = [s for s in got["batch.augment"]
                if after <= s[0] < fwd[k][0]]
        assert len(ups) == len(views) + 1 and len(augs) == len(views)
        assert all(e <= fwd[k][0] for _, e in ups + augs)
        assert fwd[k][0] <= got["model.stem"][k][0]
        assert got["model.stem"][k][1] <= fwd[k][1]


def test_embedding_pass_records_its_spans_once_a_batch(few_threads):
    n = 3
    events = _profiled(_embed_pass, n)
    got = {name: _named(events, name) for name in EMBED_SPANS}
    assert all(len(v) == n for v in got.values()), got
    for k in range(n):
        up, fwd, back = (got[name][k] for name in EMBED_SPANS[:3])
        assert up[1] <= fwd[0] and fwd[1] <= back[0]
        stem = got["model.stem"][k]
        assert fwd[0] <= stem[0] and stem[1] <= fwd[1]


def test_no_record_function_without_a_profiler(monkeypatch, few_threads,
                                               tmp_path):
    """Without a profiler no span enters ``record_function``; under one,
    the same count sees them (the patch catches them)."""
    entered = []
    rf = torch.autograd.profiler.record_function
    init = rf.__init__

    def counting(self, name, *args, **kwargs):
        entered.append(name)
        init(self, name, *args, **kwargs)

    monkeypatch.setattr(rf, "__init__", counting)
    program = set(STEP_SPANS + EMBED_SPANS)
    _triplet_epoch("r3d18", [B] * 2, tmp_path)
    _embed_pass(2)
    assert not program & set(entered), sorted(set(entered))
    _profiled(_embed_pass, 1)
    assert set(EMBED_SPANS) <= set(entered)


def test_throughput_counts_steps_read_back(monkeypatch):
    clock = iter([10.0, 12.0, 15.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    thru = Throughput()
    thru.done(0)  # nothing read back: no reading of the clock
    thru.done(8)  # the first step: starts the clock, not counted
    assert thru.items_per_sec == 0.0
    thru.done(16)
    thru.done(8)
    assert thru.items == 24 and thru.items_per_sec == 24 / 5.0


def test_epoch_counts_where_it_reads_back(monkeypatch, few_threads,
                                          tmp_path):
    """The epoch reads the first step back alone, then every
    ``TRAIN.LOG_INTERVAL`` (2) steps and at its end, and counts the items
    it read back each time."""
    calls = []

    class Recording(Throughput):
        def done(self, n_items):
            calls.append(n_items)
            super().done(n_items)

    monkeypatch.setattr(driver, "Throughput", Recording)
    _triplet_epoch("r3d18", [4, 3, 4, 2, 4], tmp_path)
    assert calls == [4, 3, 6, 4]
