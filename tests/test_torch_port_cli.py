"""The port's evaluate CLI against the JAX package's ``cli/evaluate.py``.

Both load the same reference-format ``.pth.tar`` (flax weights carried into
kenshohara key names, saved with a DDP ``module.`` prefix) and run on the
same synthetic JPEG dataset; the port with ``--device cpu``. The JAX CLI
runs in this process (its ``main`` under a patched ``sys.argv``). The
embeddings agree within atol 2e-4 and ``global_retrieval_acc.txt`` is the
same. Also: the checkpoint reader and loader, the tool flags' PNGs, and
the orbax directory the port does not read.
"""

import importlib.util
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from synthetic_data import make_synthetic_ucf
from video_similarity_search_tpu.config import get_cfg as j_get_cfg
from video_similarity_search_tpu.models.registry import \
    model_selector as j_selector
from video_similarity_search_tpu.train.checkpoint import \
    load_torch_checkpoint as j_load_ckpt
from video_similarity_search_tpu_torch.cli import evaluate as t_cli
from video_similarity_search_tpu_torch.config import get_cfg as t_get_cfg
from video_similarity_search_tpu_torch.models import \
    model_selector as t_selector
from video_similarity_search_tpu_torch.train.checkpoint import (
    flax_resnet3d_to_torch, load_encoder_state, load_torch_checkpoint)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    vid, ann = make_synthetic_ucf(str(root / "data"), n_frames=12, size=48,
                                  with_test=True)
    cfg_path = root / "cfg.yaml"
    cfg_path.write_text(
        "MODEL:\n  ARCH: 3dresnet\nRESNET:\n  MODEL_DEPTH: 10\n"
        "  WIDEN_FACTOR: 0.25\n  HIDDEN_LAYER: 32\n  OUT_DIM: 8\n"
        "DATA:\n  SAMPLE_SIZE: 16\n  SAMPLE_DURATION: 4\n"
        "TRAIN:\n  DATASET: ucf101\n  NUM_DATA_WORKERS: 1\n"
        f"DATASET:\n  VID_PATH: '{vid}'\n  ANNOTATION_PATH: '{ann}'\n"
        "TPU:\n  COMPUTE_DTYPE: float32\n")
    cfg = j_get_cfg()
    cfg.merge_from_file(str(cfg_path))
    fmodel = j_selector(cfg)
    variables = fmodel.init(jax.random.key(3), jnp.zeros((1, 4, 16, 16, 3)),
                            train=False)
    rng = np.random.default_rng(1)
    stats = jax.tree.map(
        lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32),
        variables["batch_stats"])
    sd = flax_resnet3d_to_torch(jax.tree.map(np.asarray, variables["params"]),
                                stats)
    ckpt = root / "model.pth.tar"
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()},
                "epoch": 7, "best_prec1": 0.5}, str(ckpt))
    return {"cfg": str(cfg_path), "ckpt": str(ckpt), "root": root, "sd": sd}


def _jax_cli(argv, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "jax_cli_evaluate", os.path.join(REPO, "cli", "evaluate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["evaluate.py"] + argv)
    return mod.main()


def _outputs(out):
    res = {}
    for split in ("train", "test"):
        with open(os.path.join(out, f"{split}_embeddings.pkl"), "rb") as f:
            res[split] = pickle.load(f)
    with open(os.path.join(out, "tnet_checkpoints",
                           "global_retrieval_acc.txt")) as f:
        res["acc"] = f.read()
    return res


@pytest.mark.parametrize("crop", ["avg", "center"])
def test_cli_matches_jax_cli(setup, monkeypatch, crop):
    argv = ["--cfg", setup["cfg"], "--checkpoint_path", setup["ckpt"],
            "--crop", crop]
    j_out = str(setup["root"] / f"jax_{crop}")
    t_out = str(setup["root"] / f"torch_{crop}")
    j_acc = _jax_cli(argv + ["--output", j_out], monkeypatch)
    t_acc = t_cli.main(argv + ["--output", t_out, "--device", "cpu"])
    assert t_acc == j_acc
    j, t = _outputs(j_out), _outputs(t_out)
    assert t["acc"] == j["acc"] and t["acc"].startswith("epoch:0 top1:")
    for split, n in (("train", 6), ("test", 3)):
        assert t[split]["embeddings"].shape == (n, 8)
        np.testing.assert_allclose(t[split]["embeddings"],
                                   j[split]["embeddings"], atol=2e-4)
        for k in ("labels", "indices"):
            np.testing.assert_array_equal(t[split][k], j[split][k])


@pytest.mark.parametrize("flag", [["--heatmap", "0,1"], ["--plot"]])
def test_tools_not_ported_raise(setup, flag, tmp_path):
    """The two tool flags, refused before the evaluation tools were
    ported, now write their PNGs under OUTPUT_PATH at the JAX figures'
    pixel sizes (8 x 3 in at 120 dpi; 2 (k + 1) x 2 n in at 120 dpi with
    k = 5 of the 6 train videos and n = the 3 test videos)."""
    from PIL import Image

    out = str(tmp_path / "out")
    t_cli.main(["--cfg", setup["cfg"], "--checkpoint_path", setup["ckpt"],
                "--output", out, "--device", "cpu"] + flag)
    name, size = (("temporal_heat_map.png", (960, 360))
                  if flag[0] == "--heatmap"
                  else ("exemplar_retrievals.png", (1440, 720)))
    with Image.open(os.path.join(out, name)) as im:
        im.load()
        assert im.size == size
    assert os.path.exists(os.path.join(out, "tnet_checkpoints",
                                       "global_retrieval_acc.txt"))


def test_orbax_checkpoint_dir_raises(setup, tmp_path):
    with pytest.raises(ValueError, match="orbax"):
        t_cli.main(["--cfg", setup["cfg"], "--device", "cpu",
                    "--checkpoint_path", str(tmp_path)])


def test_load_torch_checkpoint_matches_jax(setup, tmp_path):
    t, j = load_torch_checkpoint(setup["ckpt"]), j_load_ckpt(setup["ckpt"])
    assert (t["epoch"], t["best_prec1"]) == (j["epoch"], j["best_prec1"])
    assert (7, 0.5) == (t["epoch"], t["best_prec1"])
    assert sorted(t["torch_state_dict"]) == sorted(j["torch_state_dict"])
    for k, v in t["torch_state_dict"].items():
        np.testing.assert_array_equal(v.numpy(), j["torch_state_dict"][k])
    # a MoCo query encoder: encoder_q.0.* -> backbone.*, loaded by name
    moco = tmp_path / "moco.pth.tar"
    torch.save({"state_dict": {"module.encoder_q.0." + k: v
                               for k, v in setup["sd"].items()}}, str(moco))
    t, j = load_torch_checkpoint(str(moco)), j_load_ckpt(str(moco))
    assert sorted(t["torch_state_dict"]) == sorted(j["torch_state_dict"])
    assert all(k.startswith("backbone.") for k in t["torch_state_dict"])
    cfg = t_get_cfg()
    cfg.merge_from_file(setup["cfg"])
    model = t_selector(cfg)
    info = load_encoder_state(model, t["torch_state_dict"], verbose=False)
    assert not info["skipped"] and not info["missing"]
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), setup["sd"][k].numpy())


def test_load_encoder_state_partial_load_rules(setup):
    cfg = t_get_cfg()
    cfg.merge_from_file(setup["cfg"])
    sd = dict(setup["sd"])
    # head missing and a wrong-shaped tensor: skipped, kept at init
    head = {k: sd.pop(k) for k in list(sd) if k.startswith(("fc1", "fc2"))}
    sd["bn_proj.weight"] = torch.zeros(3)
    model = t_selector(cfg)
    info = load_encoder_state(model, sd, verbose=False)
    assert info["skipped"] == ["bn_proj.weight"]
    assert set(info["missing"]) == set(head) | {"bn_proj.weight"}
    # a backbone weight missing: raises
    sd.pop("layer1.0.conv1.weight")
    with pytest.raises(KeyError, match="layer1.0.conv1.weight"):
        load_encoder_state(t_selector(cfg), sd, verbose=False)
    # BatchNorm's counters alone may be absent
    full = {k: v for k, v in setup["sd"].items()
            if not k.endswith("num_batches_tracked")}
    load_encoder_state(t_selector(cfg), full, verbose=False)
