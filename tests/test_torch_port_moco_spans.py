"""The spans of the MoCo UberNCE step and of the data-parallel runtime
(``utils/profiling.py::span``) on the CPU, under ``torch.profiler``:

* ``model.stem`` opens once per S3D forward, around ``Conv_1a`` and its
  max-pool;
* ``moco.keys``, ``moco.momentum`` and ``moco.enqueue`` open once per
  UberNCE step, and the query and key forwards each open ``model.stem``;
* under a process group (world 1, gloo) ``dist.sum_gradients`` opens once
  per triplet step and ``dist.bn_stats`` twice per BatchNorm (the
  statistics' all-reduce in the forward, their gradients' in the
  backward); with no group neither opens;
* the triplet, contrastive and MoCo steps, with and without gradient
  accumulation, open ``step.forward_loss`` and ``step.backward`` once a
  microbatch and ``step.optimizer`` once, and sum the gradients once a
  step, through ``train/steps.py``'s ``sum_gradients``, inside the last
  microbatch's ``step.backward``.
"""

from collections import Counter
from datetime import timedelta

import pytest
import torch
from torch.autograd import DeviceType

from video_similarity_search_tpu_torch import parallel
from video_similarity_search_tpu_torch.config import get_cfg
from video_similarity_search_tpu_torch.models import layers, model_selector
from video_similarity_search_tpu_torch.models.s3d import S3D
from video_similarity_search_tpu_torch.train import steps as steps_module
from video_similarity_search_tpu_torch.train.state import make_optimizer
from video_similarity_search_tpu_torch.train.steps import (
    make_banks, make_contrastive_train_step, make_moco_train_step,
    make_triplet_train_step)
from video_similarity_search_tpu_torch.utils.profiling import span

B, T, S, STEPS = 2, 8, 32, 2


@pytest.fixture
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _events(fn):
    """The (name, start_ns, end_ns) of every host range that opens while
    ``fn`` runs under the profiler, by start (read from the profiler's raw
    events: building its ``events()`` tree takes seconds for S3D)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CPU)


def _counts(fn):
    """How often each host range opens while ``fn`` runs under the
    profiler."""
    return dict(Counter(name for name, _, _ in _events(fn)))


def test_s3d_stem_span_opens_once_per_forward(few_threads):
    torch.manual_seed(0)
    model = S3D().eval()
    x = torch.rand(B, T, S, S, 3)

    def forwards():
        with torch.no_grad():
            for _ in range(3):
                model(x)

    assert _counts(forwards).get("model.stem") == 3


def _moco_step():
    cfg = get_cfg()
    cfg.merge_from_list([str(v) for v in [
        "MODEL.ARCH", "uber_nce", "LOSS.TYPE", "UberNCE", "LOSS.K", 4 * B,
        "OPTIM.OPTIMIZER", "adam", "TPU.COMPUTE_DTYPE", "float32"]])
    torch.manual_seed(0)
    model = model_selector(cfg)
    bank = make_banks(cfg, 0, model)["moco"]
    opt, sched = make_optimizer(cfg, model.parameters())
    return make_moco_train_step(cfg, model, opt, sched, bank, uber=True,
                                device="cpu")


def test_moco_spans_open_once_per_step(few_threads):
    step = _moco_step()
    batch = {"x1": torch.rand(B, T, S, S, 3), "x2": torch.rand(B, T, S, S, 3),
             "label": torch.tensor([0, 1])}

    def steps():
        for _ in range(STEPS):
            step(batch)

    got = _counts(steps)
    for name in ("moco.keys", "moco.momentum", "moco.enqueue"):
        assert got.get(name) == STEPS, (name, got.get(name))
    assert got.get("model.stem") == 2 * STEPS  # the query and key forwards


def _r3d10(*overrides):
    cfg = get_cfg()
    cfg.merge_from_list([str(v) for v in [
        "MODEL.ARCH", "3dresnet", "RESNET.MODEL_DEPTH", 10,
        "RESNET.NO_MAX_POOl", True, "RESNET.HIDDEN_LAYER", 32,
        "RESNET.OUT_DIM", 8, "DATA.SAMPLE_DURATION", 4,
        "DATA.SAMPLE_SIZE", 16, "TPU.COMPUTE_DTYPE", "float32",
        *overrides]])
    torch.manual_seed(0)
    model = model_selector(cfg)
    return cfg, model, *make_optimizer(cfg, model.parameters())


def _triplet_step(accum: int = 1):
    cfg, model, opt, sched = _r3d10("TRAIN.ACCUM_STEPS", accum)
    step = make_triplet_train_step(cfg, model, opt, sched, device="cpu")
    n_bn = sum(isinstance(m, layers._FlaxRunningVar) for m in model.modules())
    batch = {"anchor": torch.rand(B * accum, 4, 16, 16, 3),
             "positive": torch.rand(B * accum, 4, 16, 16, 3),
             "targets": torch.tensor([0, 1, 0, 1])}
    if accum > 1:  # (A, B, ...) leaves, each targets [anchors; positives]
        batch = {k: v.reshape(accum, B, *v.shape[1:]) for k, v in
                 batch.items() if k != "targets"}
        batch["targets"] = torch.tensor([[0, 1, 0, 1]] * accum)
    gen = torch.Generator().manual_seed(0)

    def steps():
        for _ in range(STEPS):
            step(batch, gen)

    return steps, n_bn


@pytest.mark.parametrize("group", [False, True])
def test_dist_spans_open_only_under_a_group(few_threads, group):
    steps, n_bn = _triplet_step()
    if group:
        parallel.initialize_distributed(
            f"tcp://127.0.0.1:{parallel.free_port()}", 1, 0,
            backend="gloo", timeout=timedelta(seconds=60))
    try:
        got = _counts(steps)
    finally:
        parallel.destroy()
    if group:
        assert got.get("dist.sum_gradients") == STEPS
        assert got.get("dist.bn_stats") == 2 * n_bn * STEPS
    else:
        assert "dist.sum_gradients" not in got
        assert "dist.bn_stats" not in got


def _contrastive_step(accum: int = 1):
    cfg, model, opt, sched = _r3d10("TRAIN.ACCUM_STEPS", accum,
                                    "LOSS.TYPE", "contrastive",
                                    "LOSS.FEAT_DIM", 8, "LOSS.K", 4)
    bank = make_banks(cfg, 8, model)["nce"]
    step = make_contrastive_train_step(cfg, model, opt, sched, bank,
                                       modality="rgb", device="cpu")
    batch = {"view1": torch.rand(B * accum, 4, 16, 16, 3),
             "view2": torch.rand(B * accum, 4, 16, 16, 3),
             "index": torch.arange(B * accum)}
    if accum > 1:  # (A, B, ...) leaves
        batch = {k: v.reshape(accum, B, *v.shape[1:])
                 for k, v in batch.items()}
    gen = torch.Generator().manual_seed(0)

    def steps():
        for _ in range(STEPS):
            step(batch, gen)

    return steps


def _moco_steps():
    step = _moco_step()
    batch = {"x1": torch.rand(B, T, S, S, 3), "x2": torch.rand(B, T, S, S, 3),
             "label": torch.tensor([0, 1])}

    def steps():
        for _ in range(STEPS):
            step(batch)

    return steps


# case: (steps, microbatches a step)
SUMMED = {"triplet": (lambda: _triplet_step()[0], 1),
          "triplet_accum2": (lambda: _triplet_step(2)[0], 2),
          "contrastive": (_contrastive_step, 1),
          "contrastive_accum2": (lambda: _contrastive_step(2), 2),
          "moco": (_moco_steps, 1)}


@pytest.mark.parametrize("case", list(SUMMED))
def test_step_sums_gradients_once_through_the_steps_module(
        case, monkeypatch, few_threads):
    make, accum = SUMMED[case]
    steps = make()
    calls = []

    def recorder(params):
        with span("test.sum_gradients"):
            calls.append(len(list(params)))

    monkeypatch.setattr(steps_module, "sum_gradients", recorder)
    events = _events(steps)
    got = {name: [(s, e) for n, s, e in events if n == name]
           for name in ("step.forward_loss", "step.backward",
                        "step.optimizer", "test.sum_gradients")}
    assert len(calls) == STEPS and all(calls), calls
    assert len(got["step.forward_loss"]) == STEPS * accum
    assert len(got["step.backward"]) == STEPS * accum
    assert len(got["step.optimizer"]) == STEPS
    for k, (start, end) in enumerate(got["test.sum_gradients"]):
        last = got["step.backward"][(k + 1) * accum - 1]
        assert last[0] <= start and end <= last[1], k
        assert end <= got["step.optimizer"][k][0]
