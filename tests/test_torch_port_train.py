"""The port's validation, checkpoints and training CLI against the JAX
package's, on the CPU.

* ``validate`` on the same weights and batches (a ragged last batch
  included) writes the same ``val_loss_and_acc.txt`` line and returns the
  same accuracies, for VAL.METRIC global and local_batch;
* the port's ``checkpoint.pth.tar``, read by the JAX package's
  ``load_checkpoint`` + ``torch_to_flax``, gives JAX embeddings equal to
  the port's within 1e-5, and ``restore_train_state`` brings back the
  weights, BatchNorm statistics, momentum buffers and schedule exactly;
  an optimizer state that does not fit is kept fresh with a warning;
* a 2-epoch ``--iterative_cluster`` run of
  ``python -m video_similarity_search_tpu_torch.cli.online_train`` and of
  the JAX ``train`` on ``tests/synthetic_data.py`` data, from the same
  ``--pretrain_path`` weights: the same set of files, the same line counts
  in the txt logs, one label a train video in ``vid_clusters.txt``,
  cluster-label targets and adaptive p; then a resume for one more epoch
  that starts at epoch 2 with the saved momentum buffers;
* the utilities' copies: MetricsSink and AverageMeter as the JAX ones, and
  the torch.profiler StepProfiler.
"""

import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from synthetic_data import make_synthetic_ucf
from video_similarity_search_tpu.config import arg_parser as j_arg_parser
from video_similarity_search_tpu.config import get_cfg as j_get_cfg
from video_similarity_search_tpu.config import load_config as j_load_config
from video_similarity_search_tpu.evaluation.validate import \
    validate as j_validate
from video_similarity_search_tpu.models import model_selector as j_selector
from video_similarity_search_tpu.train.checkpoint import \
    load_checkpoint as j_load_checkpoint
from video_similarity_search_tpu.train.checkpoint import torch_to_flax
from video_similarity_search_tpu.train.driver import train as j_train
from video_similarity_search_tpu_torch.cli import online_train as t_cli
from video_similarity_search_tpu_torch.config import get_cfg as t_get_cfg
from video_similarity_search_tpu_torch.evaluation.validate import \
    validate as t_validate
from video_similarity_search_tpu_torch.models import model_selector as t_selector
from video_similarity_search_tpu_torch.train import checkpoint as t_ckpt
from video_similarity_search_tpu_torch.train import steps as t_steps
from video_similarity_search_tpu_torch.train.checkpoint import \
    flax_resnet3d_to_torch
from video_similarity_search_tpu_torch.train.state import make_optimizer

T, S = 4, 16
YAML = ("MODEL:\n  ARCH: 3dresnet\nRESNET:\n  MODEL_DEPTH: 10\n"
        "  NO_MAX_POOl: true\n  HIDDEN_LAYER: 32\n  OUT_DIM: 8\n"
        f"DATA:\n  SAMPLE_SIZE: {S}\n  SAMPLE_DURATION: {T}\n"
        "TRAIN:\n  DATASET: ucf101\n  BATCH_SIZE: 8\n  EPOCHS: 2\n"
        "  NUM_DATA_WORKERS: 2\n  LOG_INTERVAL: 100\n"
        "  RETRIEVAL_INTERVAL: 1\n"
        "VAL:\n  BATCH_SIZE: 8\n"
        "DATASET:\n  SAMPLING_STRATEGY: random_semi_hard\n"
        "  POSITIVE_SAMPLING_P: 1.0\n"
        "LOSS:\n  LOCAL_LOCAL_CONTRAST: true\n"
        "OPTIM:\n  LR: 0.01\n"
        "ITERCLUSTER:\n  METHOD: finch\n  INTERVAL: 1\n  WARMUP_EPOCHS: 0\n"
        "  ADAPTIVEP: true\n"
        "TPU:\n  COMPUTE_DTYPE: float32\n")
LOGS = ("NMIs.txt", "AMIs.txt", "train_loss_and_acc.txt",
        "val_loss_and_acc.txt", "global_retrieval_acc.txt")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    vid, ann = make_synthetic_ucf(str(root / "data"))
    cfg_path = root / "cfg.yaml"
    cfg_path.write_text(YAML)
    extra = ["DATASET.VID_PATH", vid, "DATASET.ANNOTATION_PATH", ann]
    jcfg, tcfg = j_get_cfg(), t_get_cfg()
    for cfg in (jcfg, tcfg):
        cfg.merge_from_file(str(cfg_path))
        cfg.merge_from_list(list(extra))
    jmodel = j_selector(jcfg)
    variables = jmodel.init(jax.random.key(5), jnp.zeros((2, T, S, S, 3)),
                            train=False)
    rng = np.random.default_rng(5)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(
        lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32),
        variables["batch_stats"])
    sd = flax_resnet3d_to_torch(params, stats)
    init = root / "init.pth.tar"
    torch.save({"state_dict": sd}, str(init))
    return {"root": root, "cfg": str(cfg_path), "extra": extra,
            "jcfg": jcfg, "tcfg": tcfg, "jmodel": jmodel, "params": params,
            "stats": stats, "sd": sd, "init": str(init)}


def _tmodel(setup):
    model = t_selector(setup["tcfg"])
    model.load_state_dict(setup["sd"])
    return model


def _val_batches(n_batches=3, b=4, last=2, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        batch = {k: rng.integers(0, 256, (b, T, S, S, 3), np.uint8)
                 for k in ("anchor", "positive", "negative")}
        a_t = rng.integers(0, 3, b).astype(np.int32)
        batch["targets"] = np.concatenate([a_t, a_t])
        batch["__size__"] = last if i == n_batches - 1 else b
        out.append(batch)
    return out


@pytest.mark.parametrize("metric", ["global", "local_batch"])
def test_validate_matches_jax(setup, tmp_path, metric):
    batches = _val_batches()
    res = {}
    for pkg in ("jax", "torch"):
        cfg = setup["jcfg" if pkg == "jax" else "tcfg"].clone()
        cfg.VAL.METRIC = metric
        cfg.OUTPUT_PATH = str(tmp_path / pkg)
        if pkg == "jax":
            state = types.SimpleNamespace(params=setup["params"],
                                          batch_stats=setup["stats"])
            acc, topk = j_validate(state, setup["jmodel"], cfg, batches,
                                   epoch=3)
        else:
            acc, topk = t_validate(_tmodel(setup), cfg, batches, epoch=3,
                                   device="cpu")
        line = (tmp_path / pkg / "tnet_checkpoints"
                / "val_loss_and_acc.txt").read_text()
        res[pkg] = (acc, topk, line)
    assert res["torch"][0] == res["jax"][0]
    assert res["torch"][1] == pytest.approx(res["jax"][1], abs=1e-12)
    t_vals = res["torch"][2].split()
    j_vals = res["jax"][2].split()
    assert t_vals[0] == j_vals[0] == "epoch:3"
    np.testing.assert_allclose([float(v) for v in t_vals[1:]],
                               [float(v) for v in j_vals[1:]], atol=1e-5)


def _train_a_little(setup, steps=2):
    """A port model and optimizer after a few CPU train steps, so the
    weights, BatchNorm statistics and momentum buffers are all live."""
    cfg = setup["tcfg"].clone()
    model = _tmodel(setup)
    opt, sched = make_optimizer(cfg, model.parameters(), steps_per_epoch=3)
    step = t_steps.make_triplet_train_step(cfg, model, opt, sched,
                                           device="cpu")
    rng = np.random.default_rng(1)
    g = torch.Generator().manual_seed(0)
    for _ in range(steps):
        batch = {k: torch.from_numpy(rng.normal(size=(4, T, S, S, 3))
                                     .astype(np.float32))
                 for k in ("anchor", "positive", "extra")}
        a_t = torch.tensor([0, 0, 1, 1])
        batch["targets"] = torch.cat([a_t, a_t])
        step(batch, generator=g)
    return model, opt, sched


def test_checkpoint_is_read_by_the_jax_package(setup, tmp_path):
    model, opt, sched = _train_a_little(setup)
    path = t_ckpt.save_checkpoint(str(tmp_path), "3dresnet", model, opt,
                                  sched, epoch=199, best_prec1=0.25,
                                  is_best=True)
    base = tmp_path / "tnet_checkpoints" / "3dresnet"
    assert path == str(base / "checkpoint.pth.tar")
    assert sorted(os.listdir(base)) == ["checkpoint.pth.tar",
                                        "checkpoint_200.pth.tar",
                                        "model_best.pth.tar"]
    payload = j_load_checkpoint(path)
    assert (payload["epoch"], payload["best_prec1"]) == (200, 0.25)
    params, stats = torch_to_flax(payload["torch_state_dict"], "3dresnet")
    x = np.random.default_rng(2).normal(size=(3, T, S, S, 3)).astype(
        np.float32)
    want = setup["jmodel"].apply({"params": params, "batch_stats": stats},
                                 jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_restore_brings_back_weights_momentum_and_schedule(setup, tmp_path,
                                                          capsys):
    model, opt, sched = _train_a_little(setup, steps=3)
    path = t_ckpt.save_checkpoint(str(tmp_path), "3dresnet", model, opt,
                                  sched, epoch=6, best_prec1=0.5)
    fresh = t_selector(setup["tcfg"])
    opt2, sched2 = make_optimizer(setup["tcfg"], fresh.parameters(),
                                  steps_per_epoch=3)
    epoch, best = t_ckpt.restore_train_state(
        fresh, opt2, sched2, t_ckpt.load_checkpoint(path), verbose=False)
    assert (epoch, best, sched2.count) == (7, 0.5, 3)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    bufs = [opt.state[p]["momentum_buffer"] for p in model.parameters()]
    bufs2 = [opt2.state[p]["momentum_buffer"] for p in fresh.parameters()]
    assert len(bufs) == len(bufs2) > 0
    assert all(torch.equal(a, b) for a, b in zip(bufs, bufs2))
    # an optimizer over parameters of other shapes starts fresh, loudly
    other = torch.nn.Linear(3, 2)
    opt3 = torch.optim.SGD(other.parameters(), lr=0.1, momentum=0.5)
    saved = t_ckpt.load_checkpoint(path)["optimizer"]
    assert t_ckpt._restore_optimizer(opt3, saved) == 2
    assert "WARNING: restore[optimizer]: 2/2" in capsys.readouterr().out


def test_resolve_checkpoint_rules(tmp_path):
    root = tmp_path / "run"
    assert t_ckpt.resolve_checkpoint(None, "3dresnet") is None
    with pytest.raises(FileNotFoundError):
        t_ckpt.resolve_checkpoint(str(root), "3dresnet")
    assert t_ckpt.resolve_checkpoint(str(root), "3dresnet",
                                     allow_missing=True) is None
    os.makedirs(root)
    assert t_ckpt.resolve_checkpoint(str(root), "3dresnet",
                                     allow_missing=True) is None
    nested = root / "tnet_checkpoints" / "3dresnet" / "checkpoint.pth.tar"
    os.makedirs(nested.parent)
    nested.write_bytes(b"")
    assert t_ckpt.resolve_checkpoint(str(root), "3dresnet") == str(nested)
    assert t_ckpt.resolve_checkpoint(str(nested), "3dresnet") == str(nested)
    orbax = tmp_path / "orbax"
    os.makedirs(orbax)
    (orbax / "_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="orbax"):
        t_ckpt.resolve_checkpoint(str(orbax), "3dresnet")


def _files(out):
    """Relative paths of the files a run wrote; a checkpoint counts once,
    whether an orbax directory (JAX) or a .pth.tar (the port)."""
    found = set()
    for dirpath, _, names in os.walk(out):
        rel = os.path.relpath(dirpath, out)
        parts = rel.split(os.sep)
        if parts[:2] == ["tnet_checkpoints", "3dresnet"] and len(parts) > 2:
            found.add("/".join(parts[:3]))  # inside an orbax directory
            continue
        for n in names:
            path = n if rel == "." else "/".join(parts + [n])
            found.add(path[:-len(".pth.tar")] if path.endswith(".pth.tar")
                      else path)
    return found


def _logs(out):
    return {name: open(os.path.join(out, "tnet_checkpoints", name))
            .read().splitlines() for name in LOGS}


def test_cli_two_epochs_and_resume_match_jax(setup, tmp_path, monkeypatch):
    argv = ["--cfg", setup["cfg"], "--iterative_cluster",
            "--pretrain_path", setup["init"]]
    outs = {pkg: str(tmp_path / pkg) for pkg in ("jax", "torch")}

    jargs = j_arg_parser().parse_args(argv + ["--output", outs["jax"]]
                                      + setup["extra"])
    jcfg = j_load_config(jargs)
    os.makedirs(os.path.join(outs["jax"], "tnet_checkpoints"))
    j_train(jargs, jcfg)
    tcfg, model, opt = t_cli.main(argv + ["--output", outs["torch"],
                                          "--device", "cpu"]
                                  + setup["extra"])

    assert _files(outs["torch"]) == _files(outs["jax"])
    assert "tnet_checkpoints/3dresnet/checkpoint" in _files(outs["torch"])
    jlogs, tlogs = _logs(outs["jax"]), _logs(outs["torch"])
    for name in LOGS:
        assert len(tlogs[name]) == len(jlogs[name]) == 2, name
    assert all(np.isfinite(float(ln.split()[-1]))
               for ln in tlogs["train_loss_and_acc.txt"])
    labels = open(os.path.join(outs["torch"], "vid_clusters.txt")).read()
    assert len(labels.split()) == 9  # one pseudo-label a train video
    for cfg in (jcfg, tcfg):
        assert cfg.DATASET.TARGET_TYPE_T == "cluster_label"
    nmi = float(tlogs["NMIs.txt"][-1])
    assert tcfg.DATASET.POSITIVE_SAMPLING_P == pytest.approx(1.0 - nmi,
                                                              abs=1e-6)

    # resume for one more epoch from the run root
    saved = torch.load(os.path.join(outs["torch"], "tnet_checkpoints",
                                    "3dresnet", "checkpoint.pth.tar"),
                       weights_only=False)
    assert saved["epoch"] == 2
    seen = {}
    make_step = t_steps.make_triplet_train_step

    def spy(cfg, model, optimizer, schedule, device):
        seen["momentum"] = [optimizer.state[p]["momentum_buffer"].clone()
                            for p in model.parameters()]
        seen["count"] = schedule.count
        return make_step(cfg, model, optimizer, schedule, device)

    monkeypatch.setattr(t_steps, "make_triplet_train_step", spy)
    t_cli.main(["--cfg", setup["cfg"], "--iterative_cluster", "--output",
                outs["torch"], "--checkpoint_path", outs["torch"],
                "--device", "cpu", "TRAIN.EPOCHS", "3"] + setup["extra"])
    want = [saved["optimizer"]["state"][i]["momentum_buffer"]
            for i in range(len(seen["momentum"]))]
    assert all(torch.equal(a, b) for a, b in zip(seen["momentum"], want))
    assert seen["count"] == saved["lr_schedule"]["count"] > 0
    logs = _logs(outs["torch"])
    assert logs["train_loss_and_acc.txt"][-1].startswith("epoch:2 ")
    assert len(logs["train_loss_and_acc.txt"]) == 3
    assert len(logs["NMIs.txt"]) == 3


def test_cli_refuses_what_is_not_ported(setup, tmp_path):
    base = ["--cfg", setup["cfg"], "--output", str(tmp_path), "--device",
            "cpu"] + setup["extra"]
    with pytest.raises(NotImplementedError, match="item 10"):
        t_cli.main(base[:-4] + ["--num_shards", "2"] + base[-4:])
    # LOSS.TYPE contrastive and UberNCE are ported
    # (tests/test_torch_port_{contrastive,moco}.py)


def test_metrics_sink_meter_and_step_profiler(tmp_path):
    """The port's copies of the JAX-free utilities: the same scalars.csv
    as the JAX MetricsSink, the same AverageMeter arithmetic, and a
    torch.profiler trace of steps 5-9 only when a directory is given."""
    from video_similarity_search_tpu.utils.meters import \
        AverageMeter as JMeter
    from video_similarity_search_tpu.utils.metrics_sink import \
        MetricsSink as JSink
    from video_similarity_search_tpu_torch.utils.meters import \
        AverageMeter as TMeter
    from video_similarity_search_tpu_torch.utils.metrics_sink import \
        MetricsSink as TSink
    from video_similarity_search_tpu_torch.utils.profiling import StepProfiler

    for pkg, cls in (("jax", JSink), ("torch", TSink)):
        sink = cls(str(tmp_path / pkg), enabled=True)
        for i, v in enumerate((0.5, 1 / 3, 2e-7)):
            sink.add_scalar("train/loss", v, i)
        sink.close()
        assert not cls(str(tmp_path / "off" / pkg), enabled=False).enabled
    assert ((tmp_path / "torch" / "scalars.csv").read_text()
            == (tmp_path / "jax" / "scalars.csv").read_text())
    assert not (tmp_path / "off").exists()
    jm, tm = JMeter("loss"), TMeter("loss")
    for v, n in ((0.5, 3), (0.25, 1), (1.0, 2)):
        jm.update(v, n)
        tm.update(v, n)
    assert (tm.val, tm.avg, tm.sum, tm.count) == (jm.val, jm.avg, jm.sum,
                                                  jm.count)

    prof = StepProfiler(str(tmp_path / "trace"))
    for i in range(12):
        prof.step(i)
        torch.ones(8).sum()
    prof.close()
    assert os.listdir(tmp_path / "trace") == ["trace_steps5-9.json"]
    off = StepProfiler("")
    for i in range(7):
        off.step(i)
    off.close()
