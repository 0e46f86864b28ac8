"""The port's IIC clip retrieval and FLOP counter against the JAX
package's, on the CPU.

* ``decode_video`` and ``parse_split_file`` equal; every IIC dataset class
  (recognition train / multi-window test, clip retrieval from a layout and
  from explicit lists) over cv2 MJPG videos in the UCF layout
  (split/classInd.txt + videos/) and the HMDB layout (prev_split/ +
  avi/), with and without the cv2 resize: items byte-equal;
* both ``iic_retrieve_clips`` CLIs on the same R3D-10 weights (a
  reference-format ``.pth.tar`` made from flax weights) and videos, the
  port's with ``--device cpu``: features within 1e-4 (float32 convolutions
  summed in another order), ``topk_correct.json`` equal; without
  ``--device cpu`` the port's CLI raises on a machine without CUDA;
* ``resnet3d_flops_per_clip`` equal to JAX's for every depth it accepts,
  and the port's hook counter equal to JAX's ``model_flops_per_clip`` on
  R3D-18, S3D and SlowFast-18.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

cv2 = pytest.importorskip("cv2")

from video_similarity_search_tpu.config import get_cfg as j_get_cfg  # noqa: E402
from video_similarity_search_tpu.data import iic_data as ji  # noqa: E402
from video_similarity_search_tpu.models.registry import \
    model_selector as j_selector  # noqa: E402
from video_similarity_search_tpu.utils import flops as jf  # noqa: E402
from video_similarity_search_tpu_torch.cli import \
    iic_retrieve_clips as t_cli  # noqa: E402
from video_similarity_search_tpu_torch.data import iic_data as ti  # noqa: E402
from video_similarity_search_tpu_torch.train.checkpoint import \
    flax_resnet3d_to_torch  # noqa: E402
from video_similarity_search_tpu_torch.utils import flops as tf  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUTS = {"ucf101": ("split", "classInd.txt", "videos"),
           "hmdb51": ("prev_split", "ClassInd.txt", "avi")}
CLASSES = ["brush_hair", "jump", "run"]


def _write_avi(path, n_frames, seed, hw=(30, 40)):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                        (hw[1], hw[0]))
    rng = np.random.default_rng(seed)
    base = rng.integers(30, 220, 3)
    for _ in range(n_frames):
        w.write(np.clip(base + rng.integers(-25, 25, hw + (3,)), 0,
                        255).astype(np.uint8))
    w.release()


def _make_layout(root, layout):
    """3 classes x 3 videos (two train, one test) of 6 to 21 frames."""
    split_dir, class_file, video_dir = LAYOUTS[layout]
    os.makedirs(os.path.join(root, split_dir))
    with open(os.path.join(root, split_dir, class_file), "w") as f:
        f.write("\n".join(f"{i + 1} {c}" for i, c in enumerate(CLASSES)))
    train, test = [], []
    for c, name in enumerate(CLASSES):
        for v in range(3):
            rel = f"{name}/v_{name}_g{v:02d}.avi"
            _write_avi(os.path.join(root, video_dir, rel),
                       n_frames=6 + 5 * v + c, seed=10 * c + v)
            (train if v < 2 else test).append(rel)
    with open(os.path.join(root, split_dir, "trainlist01.txt"), "w") as f:
        f.write("\n".join(f"{r} 1" for r in train))
    with open(os.path.join(root, split_dir, "testlist01.txt"), "w") as f:
        f.write("\n".join(test))
    return root


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return {layout: _make_layout(str(tmp_path_factory.mktemp(layout)),
                                 layout) for layout in LAYOUTS}


def _item_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_decode_and_split_files_match_jax(roots):
    root = roots["ucf101"]
    lists = [os.path.join(root, "split", n)
             for n in ("trainlist01.txt", "testlist01.txt")]
    cls = os.path.join(root, "split", "classInd.txt")
    for lst in lists:
        assert ti.parse_split_file(lst, cls) == ji.parse_split_file(lst, cls)
    path = os.path.join(root, "videos", CLASSES[1], "v_jump_g02.avi")
    got, want = ti.decode_video(path), ji.decode_video(path)
    assert got.shape == (17, 30, 40, 3) and np.array_equal(got, want)
    assert np.array_equal(ti.decode_video(path, max_frames=5), want[:5])
    with pytest.raises(IOError):
        ti.decode_video(os.path.join(root, "missing.avi"))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("sample_size", [None, 16])
def test_recognition_items_are_byte_equal(roots, layout, sample_size):
    cls = {"ucf101": "UCF101Dataset", "hmdb51": "HMDB51Dataset"}[layout]
    for train in (True, False):
        kw = dict(train=train, test_sample_num=4, sample_size=sample_size,
                  seed=3)
        j = getattr(ji, cls)(roots[layout], 8, **kw)
        t = getattr(ti, cls)(roots[layout], 8, **kw)
        assert len(t) == len(j) == (6 if train else 3)
        t.set_epoch_seed(5)
        j.set_epoch_seed(5)
        for i in range(len(t)):
            _item_equal(t[i], j[i])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_clip_retrieval_items_are_byte_equal(roots, layout):
    cls = {"ucf101": "UCF101ClipRetrievalDataset",
           "hmdb51": "HMDB51ClipRetrievalDataset"}[layout]
    for train in (True, False):
        for sample_size in (None, 16):
            kw = dict(sample_num=5, train=train, sample_size=sample_size)
            j = getattr(ji, cls)(roots[layout], 8, **kw)
            t = getattr(ti, cls)(roots[layout], 8, **kw)
            assert len(t) == len(j) > 0
            for i in range(len(t)):
                _item_equal(t[i], j[i])
    split_dir, class_file, video_dir = LAYOUTS[layout]
    items = ti.parse_split_file(
        os.path.join(roots[layout], split_dir, "testlist01.txt"),
        os.path.join(roots[layout], split_dir, class_file))
    kw = dict(clip_len=16, sample_num=3, sample_size=12)
    j = ji.ClipRetrievalDataset(os.path.join(roots[layout], video_dir),
                                items, **kw)
    t = ti.ClipRetrievalDataset(os.path.join(roots[layout], video_dir),
                                items, **kw)
    for i in range(len(t)):  # 8- and 9-frame videos repeat to 16
        _item_equal(t[i], j[i])


YAML = ("MODEL:\n  ARCH: 3dresnet\nRESNET:\n  MODEL_DEPTH: 10\n"
        "  WIDEN_FACTOR: 0.25\n  HIDDEN_LAYER: 32\n  OUT_DIM: 8\n"
        "DATA:\n  SAMPLE_SIZE: 16\n  SAMPLE_DURATION: 4\n"
        "TPU:\n  COMPUTE_DTYPE: float32\n")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A reference-format .pth.tar of seeded R3D-10 weights (flax init,
    BatchNorm statistics spread around 1, carried into kenshohara names
    with a DDP ``module.`` prefix), and its yaml."""
    root = tmp_path_factory.mktemp("iic_weights")
    cfg_path = root / "cfg.yaml"
    cfg_path.write_text(YAML)
    cfg = j_get_cfg()
    cfg.merge_from_file(str(cfg_path))
    variables = j_selector(cfg).init(jax.random.key(3),
                                     jnp.zeros((1, 4, 16, 16, 3)),
                                     train=False)
    rng = np.random.default_rng(1)
    stats = jax.tree.map(
        lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32),
        variables["batch_stats"])
    sd = flax_resnet3d_to_torch(jax.tree.map(np.asarray, variables["params"]),
                                stats)
    ckpt = root / "model.pth.tar"
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()},
                "epoch": 1}, str(ckpt))
    return str(cfg_path), str(ckpt)


def _jax_cli(argv, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "jax_cli_iic", os.path.join(REPO, "cli", "iic_retrieve_clips.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["iic_retrieve_clips.py"] + argv)
    return mod.main()


def _outputs(feature_dir):
    out = {split: (np.load(os.path.join(feature_dir,
                                        f"{split}_features.npy")),
                   np.load(os.path.join(feature_dir, f"{split}_classes.npy")))
           for split in ("train", "test")}
    with open(os.path.join(feature_dir, "topk_correct.json")) as f:
        return out, json.load(f)


@pytest.mark.parametrize("mode", ["hmdb51", "lists"])
def test_iic_clis_agree(roots, weights, tmp_path, monkeypatch, mode):
    cfg_path, ckpt = weights
    if mode == "lists":  # explicit lists over the UCF tree
        root = roots["ucf101"]
        data = ["--video_dir", os.path.join(root, "videos"),
                "--train_list", os.path.join(root, "split",
                                             "trainlist01.txt"),
                "--test_list", os.path.join(root, "split", "testlist01.txt"),
                "--class_index", os.path.join(root, "split", "classInd.txt")]
    else:
        data = ["--dataset", mode, "--root_dir", roots[mode]]
    argv = ["--cfg", cfg_path, "--checkpoint_path", ckpt, "--clip_len", "4",
            "--sample_num", "3"] + data
    j_dir, t_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    _jax_cli(argv + ["--feature_dir", j_dir], monkeypatch)
    got = t_cli.main(argv + ["--feature_dir", t_dir, "--device", "cpu"])
    (j_feats, j_acc), (t_feats, t_acc) = _outputs(j_dir), _outputs(t_dir)
    assert t_acc == j_acc == got and sorted(got) == ["1", "10", "20", "5",
                                                      "50"]
    for split in ("train", "test"):
        assert t_feats[split][0].shape == (6 if split == "train" else 3, 3, 8)
        np.testing.assert_allclose(t_feats[split][0], j_feats[split][0],
                                   atol=1e-4)
        np.testing.assert_array_equal(t_feats[split][1], j_feats[split][1])
    # a second run reads the cached features
    again = t_cli.main(argv + ["--feature_dir", t_dir, "--device", "cpu"])
    assert again == got


def test_port_cli_needs_cuda_unless_told_cpu(roots, weights, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_cli.main(["--cfg", weights[0], "--dataset", "ucf101",
                    "--root_dir", roots["ucf101"],
                    "--feature_dir", str(tmp_path)])


@pytest.mark.parametrize("depth", sorted(jf._DEPTH_TO_SPEC))
def test_resnet3d_flops_per_clip_matches_jax(depth):
    for kw in ({}, {"t": 8, "size": 112, "no_max_pool": False},
               {"conv1_t_stride": 2, "widen_factor": 0.5,
                "projection_head": False, "in_channels": 4}):
        assert (tf.resnet3d_flops_per_clip(depth, **kw)
                == jf.resnet3d_flops_per_clip(depth, **kw))


def test_model_flops_per_clip_matches_jax():
    """The hooks count what JAX's ``model_flops_per_clip`` counts from
    flax's layers: R3D-18 (also against the formula), S3D and
    SlowFast-18, at small clips (the counts are per clip; two clips in
    the batch)."""
    from video_similarity_search_tpu.models import generate_model as j_r3d
    from video_similarity_search_tpu.models.s3d import S3D as JS3D
    from video_similarity_search_tpu.models.slowfast import (
        SlowFast as JSlowFast, multipathway_input as j_paths)
    from video_similarity_search_tpu_torch.models import generate_model
    from video_similarity_search_tpu_torch.models.s3d import S3D
    from video_similarity_search_tpu_torch.models.slowfast import (
        SlowFast, multipathway_input)

    x = np.zeros((2, 8, 32, 32, 3), np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    r3d = tf.model_flops_per_clip(generate_model(18, no_max_pool=True).eval(),
                                  tx)
    assert r3d["forward"] == jf.model_flops_per_clip(
        j_r3d(18, no_max_pool=True, projection_head=True), jx)
    assert r3d["forward"] == tf.resnet3d_flops_per_clip(t=8, size=32)
    assert r3d["first"] == 0
    s3d = S3D().eval()
    got = tf.model_flops_per_clip(s3d, tx, firsts=[s3d.Conv_1a.conv1])
    assert got["forward"] == jf.model_flops_per_clip(JS3D(), jx)
    assert 0 < got["first"] < got["forward"]
    x16 = np.zeros((2, 16, 32, 32, 3), np.float32)
    got = tf.model_flops_per_clip(
        SlowFast(depth=18).eval(),
        multipathway_input(torch.from_numpy(x16), 4))
    assert got["forward"] == jf.model_flops_per_clip(
        JSlowFast(depth=18), j_paths(jnp.asarray(x16), alpha=4))


def test_chip_peak_tflops():
    assert tf.chip_peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert tf.chip_peak_tflops("NVIDIA H100 80GB HBM3", "float32") == 67.0
    assert tf.chip_peak_tflops("NVIDIA H100 PCIe") == 756.0
    assert tf.peaks_for("NVIDIA H100 NVL, 400.00 W")[0] == "NVL"
    for kind in ("TPU v5 lite", "NVIDIA H200", "NVIDIA A10", "unknown"):
        with pytest.raises(ValueError, match="no peak rates"):
            tf.chip_peak_tflops(kind)
