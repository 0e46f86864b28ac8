"""The port's spans (``utils/profiling.py::span``) and its epoch loop
(``train/driver.py``) on the CPU.

* Under ``torch.profiler`` a tiny epoch of each loss (triplet over R3D-18
  and SlowFast, contrastive over R3D-10, UberNCE over S3D) records the
  batch's upload and augmentation, the step's three ranges, the metrics'
  read-back and the stem, each step's upload and augmentation before its
  forward; a tiny embedding pass records its upload, forward, read-back
  and stem once a batch.
* With no profiler recording, the program enters no ``record_function``
  of its own.
* ``Throughput`` counts the items of the steps whose metrics the host has
  read back, the first step left out, and every loss's epoch reads back
  at the same steps.
* Each loss's epoch hands its step the inputs it takes and writes its log
  lines, its ``train_loss_and_acc.txt`` line and its sink scalars.
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
from video_similarity_search_tpu_torch.train.steps import make_banks
from video_similarity_search_tpu_torch.utils import profiling
from video_similarity_search_tpu_torch.utils.profiling import Throughput

STEP_SPANS = ("batch.upload", "batch.augment", "step.forward_loss",
              "step.backward", "step.optimizer", "metrics.drain",
              "model.stem")
EMBED_SPANS = ("embed.upload", "embed.forward", "embed.readback",
               "model.stem")
B, STEPS, N_DATA = 4, 3, 16

R3D18 = ["MODEL.ARCH", "3dresnet", "RESNET.MODEL_DEPTH", 18,
         "RESNET.NO_MAX_POOl", True, "DATA.SAMPLE_SIZE", 16,
         "DATA.SAMPLE_DURATION", 4, "TPU.HOST_RRC", True]
# (overrides, host views, frames on the host, views uploaded and
# augmented, model.stem a step): R3D-18 takes pre-cropped clips and a
# third view for the local-local loss; SlowFast crops on the device; the
# contrastive ``res`` view is the anchor's frame residual, so the positive
# is dropped before its upload; UberNCE's key forward opens a stem too
LOSSES = {
    "triplet-r3d18": (R3D18 + ["LOSS.LOCAL_LOCAL_CONTRAST", True],
                      ("anchor", "positive", "extra"), 16,
                      ("anchor", "positive", "extra"), 1),
    "triplet-slowfast": (["MODEL.ARCH", "slowfast", "DATA.SAMPLE_SIZE", 32,
                          "DATA.SAMPLE_DURATION", 8],
                         ("anchor", "positive"), 48,
                         ("anchor", "positive"), 1),
    "contrastive": (R3D18 + ["RESNET.MODEL_DEPTH", 10,
                             "RESNET.HIDDEN_LAYER", 32, "RESNET.OUT_DIM", 8,
                             "LOSS.FEAT_DIM", 8, "LOSS.TYPE", "contrastive",
                             "LOSS.K", 8],
                    ("anchor", "positive"), 16, ("anchor",), 2),
    "ubernce": (["MODEL.ARCH", "uber_nce", "LOSS.TYPE", "UberNCE",
                 "LOSS.K", 2 * B, "OPTIM.OPTIMIZER", "adam",
                 "DATA.SAMPLE_SIZE", 32, "DATA.SAMPLE_DURATION", 8,
                 "TPU.HOST_RRC", True],
                ("anchor", "positive"), 32, ("anchor", "positive"), 2),
}
EPOCH_FNS = {"triplet": "triplet_train_epoch",
             "contrastive": "contrastive_train_epoch",
             "UberNCE": "ubernce_train_epoch"}


@pytest.fixture
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _cfg(loss: str, *overrides):
    cfg = get_cfg()
    cfg.merge_from_list([str(v) for v in LOSSES[loss][0] + [
        "TRAIN.BATCH_SIZE", B, "TRAIN.LOG_INTERVAL", 2,
        "TRAIN.DATASET", "ucf101", "TPU.COMPUTE_DTYPE", "float32",
        *overrides]])
    return cfg


def _batches(loss: str, sizes):
    """Host batches of ``loss``'s views; the positives' targets differ
    from the anchors', and a contrastive batch carries its indices."""
    _, views, hw, _, _ = LOSSES[loss]
    t = int(_cfg(loss).DATA.SAMPLE_DURATION)
    rng = np.random.default_rng(0)
    out = []
    for n in sizes:
        batch = {v: rng.integers(0, 256, (B, t, hw, hw, 3), np.uint8)
                 for v in views}
        labels = rng.integers(0, 2, B)
        batch["targets"] = np.concatenate([labels, labels + 2])
        if loss == "contrastive":
            batch["index"] = rng.permutation(N_DATA)[:B]
        batch["__size__"] = n
        out.append(batch)
    return out


def _epoch(loss: str, sizes, out_dir):
    cfg = _cfg(loss)
    cfg.OUTPUT_PATH = str(out_dir)  # the epoch appends its loss line there
    torch.manual_seed(0)
    model = model_selector(cfg)
    opt, sched = make_optimizer(cfg, model.parameters())
    banks = make_banks(cfg, N_DATA, model)
    step_fn, epoch_fn = driver.make_train_step(cfg, model, opt, sched,
                                               banks, device="cpu")
    assert epoch_fn is getattr(driver, EPOCH_FNS[cfg.LOSS.TYPE])
    gen = torch.Generator(device="cpu")
    epoch_fn(step_fn, _batches(loss, sizes), cfg, 1, gen, device="cpu")


def _embed_pass(n_batches: int):
    cfg = _cfg("triplet-r3d18")
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
    """The (name, start_ns, end_ns) of every host event ``fn`` records
    under the profiler, by start (read from the profiler's raw events:
    building its ``events()`` tree takes seconds for an S3D epoch)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(*args)
    return sorted((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CPU)


def _named(events, name):
    return [(s, e) for n, s, e in events if n == name]


@pytest.mark.parametrize("loss", list(LOSSES))
def test_epoch_records_the_step_spans(loss, few_threads, tmp_path):
    events = _profiled(_epoch, loss, [B] * STEPS, tmp_path)
    _, _, _, views, stems = LOSSES[loss]
    leaves = len(views) + 1 + (loss == "contrastive")  # targets, index
    got = {name: _named(events, name) for name in STEP_SPANS}
    # each view and the targets (and indices) uploaded, each view augmented
    assert len(got["batch.upload"]) == STEPS * leaves
    assert len(got["batch.augment"]) == STEPS * len(views)
    for name in ("step.forward_loss", "step.backward", "step.optimizer"):
        assert len(got[name]) == STEPS, name
    # read back: the first step alone, at the log interval (2), the rest
    assert len(got["metrics.drain"]) == 3
    # the triplet step's one forward over the views' concatenation, the
    # contrastive step's forward a view, UberNCE's query and key forwards
    assert len(got["model.stem"]) == STEPS * stems
    fwd, opt = got["step.forward_loss"], got["step.optimizer"]
    for k in range(STEPS):
        after = opt[k - 1][1] if k else float("-inf")
        ups = [s for s in got["batch.upload"] if after <= s[0] < fwd[k][0]]
        augs = [s for s in got["batch.augment"]
                if after <= s[0] < fwd[k][0]]
        assert len(ups) == leaves and len(augs) == len(views)
        assert all(e <= fwd[k][0] for _, e in ups + augs)
        for stem in got["model.stem"][k * stems:(k + 1) * stems]:
            assert fwd[k][0] <= stem[0] and stem[1] <= fwd[k][1]


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
    _epoch("triplet-r3d18", [B] * 2, tmp_path)
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


@pytest.mark.parametrize("loss", ["triplet-r3d18", "contrastive",
                                  "ubernce"])
def test_epoch_counts_where_it_reads_back(loss, monkeypatch, few_threads,
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
    _epoch(loss, [4, 3, 4, 2, 4], tmp_path)
    assert calls == [4, 3, 6, 4]


# each loss's step inputs, its metrics over three steps (the first 1.0,
# 2.0, 3.0 the loss) and the log line, text file line and sink scalars
# its epoch writes from them at the log interval (2) and at its end
SIZES = [4, 3, 4]
LOGGED = {
    "triplet": (
        "triplet-r3d18", [], ("anchor", "extra", "positive", "targets"),
        {"n_triplets": [5.0, 7.0, 9.0]},
        # N_Triplets is the unweighted mean over the steps: (5 + 7) / 2
        "\tN_Triplets: 6.0",
        [("train/loss", 2.0), ("train/clips_per_sec", 3.0)]),
    "contrastive": (
        "contrastive", ["DATASET.MODALITY", "rgb"],
        ("index", "view1", "view2"),
        {"view1_loss": [0.25, 0.5, 0.75], "view2_loss": [1.5, 2.5, 3.5]},
        "", [("train/loss", 2.0), ("train/view1_loss", 0.5),
             ("train/view2_loss", 2.5)]),
    "ubernce": (
        "ubernce", [], ("label", "x1", "x2"),
        {"top1": [0.125, 0.25, 0.375], "top5": [0.5, 0.625, 0.75]},
        "  Top1:0.2500 Top5:0.6250",
        [("train/loss", 2.0), ("train/top1", 0.25), ("train/top5", 0.625)]),
}


@pytest.mark.parametrize("name", list(LOGGED))
def test_epoch_writes_its_log_metric_and_sink_lines(name, monkeypatch,
                                                    capsys, few_threads,
                                                    tmp_path):
    loss, overrides, inputs, metrics, line, scalars = LOGGED[name]
    cfg = _cfg(loss, *overrides)
    cfg.OUTPUT_PATH = str(tmp_path)
    batches = _batches(loss, SIZES)
    seen = []

    def step(batch, generator):
        seen.append(batch)
        i = len(seen) - 1
        return {"loss": torch.tensor(i + 1.0),
                **{k: torch.tensor(v[i]) for k, v in metrics.items()}}

    class Counted(Throughput):  # the rate: the items read back so far
        @property
        def items_per_sec(self):
            return float(self.items)

    class Sink:
        def __init__(self):
            self.scalars = []

        def add_scalar(self, tag, value, it):
            self.scalars.append((tag, pytest.approx(value), it))

    monkeypatch.setattr(driver, "Throughput", Counted)
    sink = Sink()
    epoch_fn = getattr(driver, EPOCH_FNS[cfg.LOSS.TYPE])
    mean = epoch_fn(step, batches, cfg, 1, torch.Generator(), sink=sink,
                    device="cpu")
    assert mean == pytest.approx(2.0)  # (4 x 1 + 3 x 2 + 4 x 3) / 11

    assert [tuple(sorted(b)) for b in seen] == [inputs] * len(SIZES)
    for batch, host in zip(seen, batches):
        assert all(v.shape[0] == B for k, v in batch.items()
                   if k != "targets")
        if name == "triplet":  # [anchor labels; positive labels]
            assert batch["targets"].tolist() == host["targets"].tolist()
        if name == "ubernce":  # the anchors' targets are the labels
            assert batch["label"].tolist() == host["targets"][:B].tolist()
        if name == "contrastive":
            assert batch["index"].tolist() == host["index"].tolist()
    printed = [s for s in capsys.readouterr().out.splitlines()
               if s.startswith("Train")]
    # after the second step: 7 clips, the loss 2 and (4 + 6) / 7 on average
    assert printed == [
        f"Train Epoch: 1 [7]\tLoss: 2.0000 (1.4286){line}\t3.0 clips/s",
        "Train set: Average loss: 2.0000 (7.0 clips/s steady-state)"]
    with open(tmp_path / "tnet_checkpoints" / "train_loss_and_acc.txt") as f:
        assert f.read() == "epoch:1 runtime:0.0 2.0000\n"
    # iteration 1 x 3 + 1; the epoch's mean loss under epoch 1
    assert sink.scalars == [(tag, v, 4) for tag, v in scalars] + [
        ("epoch/train_loss", 2.0, 1)]
