"""The port's evaluation tools against the JAX package's, on the CPU: the
report parsers and training-progress figure, the temporal heat map, the
exemplar retrieval grid, t-SNE (class choice, PCA, P, and the map's
quality against scikit-learn's), TripletNet, backbone_feature_dim, and the
tsne and generate_report CLIs.

The JAX tools draw with matplotlib (present here), the port's with Pillow;
each port PNG must have the JAX PNG's pixel size. The heat map runs a tiny
R3D (depth 10, width 1/4, 4x16x16 clips, float32) whose flax weights go to
the port through ``flax_resnet3d_to_torch`` (BatchNorm statistics drawn
from ``default_rng(1)``), on ``tests/synthetic_data.py`` videos read by
both packages' loaders; JAX's function runs in this process.

The t-SNE tests run torch and scikit-learn's OpenMP on one thread: the
1,000 iterations are many small operations, and with the suite's other
workers on the cores, thread pools of every core's width slowed one test
from ~9 s alone to over 600 s.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from synthetic_data import make_synthetic_ucf
from video_similarity_search_tpu.config import get_cfg as j_get_cfg
from video_similarity_search_tpu.data import build_data_loader as j_loader
from video_similarity_search_tpu.evaluation import heatmap as j_heatmap
from video_similarity_search_tpu.evaluation import knn as j_knn
from video_similarity_search_tpu.evaluation import report as j_report
from video_similarity_search_tpu.evaluation import tsne as j_tsne
from video_similarity_search_tpu.models import resnet3d as j_resnet3d
from video_similarity_search_tpu.models.registry import \
    model_selector as j_selector
from video_similarity_search_tpu.models.triplet_net import \
    TripletNet as JTripletNet
from video_similarity_search_tpu.ops.pdist import \
    topk_neighbors as j_topk
from video_similarity_search_tpu_torch.cli import \
    generate_report as t_report_cli
from video_similarity_search_tpu_torch.cli import tsne as t_tsne_cli
from video_similarity_search_tpu_torch.config import get_cfg as t_get_cfg
from video_similarity_search_tpu_torch.data import \
    build_data_loader as t_loader
from video_similarity_search_tpu_torch.evaluation import heatmap as t_heatmap
from video_similarity_search_tpu_torch.evaluation import knn as t_knn
from video_similarity_search_tpu_torch.evaluation import plotting
from video_similarity_search_tpu_torch.evaluation import report as t_report
from video_similarity_search_tpu_torch.evaluation import tsne as t_tsne
from video_similarity_search_tpu_torch.models import (TripletNet,
                                                      backbone_feature_dim)
from video_similarity_search_tpu_torch.models import \
    model_selector as t_selector
from video_similarity_search_tpu_torch.ops.pdist import topk_neighbors
from video_similarity_search_tpu_torch.train.checkpoint import \
    flax_resnet3d_to_torch

YAML = ("MODEL:\n  ARCH: 3dresnet\nRESNET:\n  MODEL_DEPTH: 10\n"
        "  WIDEN_FACTOR: 0.25\n  HIDDEN_LAYER: 32\n  OUT_DIM: 8\n"
        "DATA:\n  SAMPLE_SIZE: 16\n  SAMPLE_DURATION: 4\n"
        "TRAIN:\n  DATASET: ucf101\n  NUM_DATA_WORKERS: 1\n"
        "DATASET:\n  VID_PATH: '{vid}'\n  ANNOTATION_PATH: '{ann}'\n"
        "TPU:\n  COMPUTE_DTYPE: float32\n")


@pytest.fixture
def one_thread():
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


def _size(path):
    with Image.open(path) as im:
        im.load()
        return im.size


@pytest.fixture(scope="module")
def r3d(tmp_path_factory):
    """Synthetic videos (12 frames, 48x48, seed 0), the tiny R3D's flax
    variables (init key 3) and their port state_dict in a .pth.tar."""
    root = tmp_path_factory.mktemp("tools")
    vid, ann = make_synthetic_ucf(str(root / "data"), n_classes=4,
                                  n_frames=12, size=48, with_test=True)
    cfg_path = root / "cfg.yaml"
    cfg_path.write_text(YAML.format(vid=vid, ann=ann))
    cfg = j_get_cfg()
    cfg.merge_from_file(str(cfg_path))
    fmodel = j_selector(cfg)
    variables = fmodel.init(jax.random.key(3), jnp.zeros((1, 4, 16, 16, 3)),
                            train=False)
    rng = np.random.default_rng(1)
    stats = jax.tree.map(
        lambda v: rng.uniform(0.5, 1.5, v.shape).astype(np.float32),
        variables["batch_stats"])
    params = jax.tree.map(np.asarray, variables["params"])
    sd = flax_resnet3d_to_torch(params, stats)
    ckpt = root / "model.pth.tar"
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()},
                "epoch": 1}, str(ckpt))
    return {"root": root, "cfg": str(cfg_path), "jcfg": cfg,
            "fmodel": fmodel, "params": params, "stats": stats, "sd": sd,
            "ckpt": str(ckpt)}


def _port_model(cfg_path, sd):
    cfg = t_get_cfg()
    cfg.merge_from_file(cfg_path)
    model = t_selector(cfg)
    model.load_state_dict(sd)
    return cfg, model


# -------------------------------------------------------------- report

LOGS = {
    "train_loss_and_acc.txt": "epoch:0 runtime:1.5 0.91\nnot a line\n"
                              "epoch:1 runtime:2.5e-1 0.75\n"
                              "epoch:2 runtime:x 0.5\nepoch:3 runtime:3 0.6\n",
    "val_loss_and_acc.txt": "epoch:0 0.9 0.5 0.41 0.77\n\n# comment\n"
                            "epoch:1 0.8 0.6\nepoch:2 0.7 0.65 0.5 0.8\n",
    "NMIs.txt": "0.51\n\n0.55\n0.6\n",
    "AMIs.txt": "",
}


def _write_logs(root, logs):
    d = root / "tnet_checkpoints"
    d.mkdir(parents=True, exist_ok=True)
    for name, text in logs.items():
        (d / name).write_text(text)
    return d


def test_report_parsers_match_jax(tmp_path):
    """Malformed lines (no match, a short val line, blanks) are read as the
    JAX parsers read them; missing files give empty results."""
    d = _write_logs(tmp_path, LOGS)
    for name, fn in (("train_loss_and_acc.txt", "parse_train_log"),
                     ("val_loss_and_acc.txt", "parse_val_log"),
                     ("NMIs.txt", "parse_scalar_log"),
                     ("AMIs.txt", "parse_scalar_log"),
                     ("missing.txt", "parse_train_log"),
                     ("missing.txt", "parse_val_log"),
                     ("missing.txt", "parse_scalar_log")):
        path = str(d / name)
        assert getattr(t_report, fn)(path) == getattr(j_report, fn)(path)
    assert t_report.parse_train_log(str(d / "train_loss_and_acc.txt"))[
        "epoch"] == [0, 1, 3]


WELL_FORMED = {
    "train_loss_and_acc.txt": "epoch:0 runtime:1.5 0.91\n"
                              "epoch:1 runtime:2.5 0.75\n",
    "val_loss_and_acc.txt": "epoch:0 0.9 0.5 0.41 0.77\n"
                            "epoch:1 0.7 0.65 0.5 0.8\n",
    "NMIs.txt": "0.51\n0.55\n",
}


@pytest.mark.parametrize("logs", [
    WELL_FORMED,
    {"train_loss_and_acc.txt": "epoch:0 runtime:1 0.9\n",
     "val_loss_and_acc.txt": "epoch:0 0.9 0.5\n"},
    {**WELL_FORMED, "AMIs.txt": "0.2\n0.3\n"},
], ids=["four_panels", "two_panels", "five_panels"])
def test_training_progress_png_size_matches_jax(tmp_path, logs):
    """(A val line short of top1/top5 beside full ones breaks the JAX
    figure, so these logs are well formed.)"""
    j_root, t_root = tmp_path / "j", tmp_path / "t"
    _write_logs(j_root, logs)
    _write_logs(t_root, logs)
    j_png = j_report.plot_training_progress(str(j_root))
    t_png = t_report_cli.main(["--output_path", str(t_root)])
    assert os.path.basename(t_png) == os.path.basename(j_png)
    assert _size(t_png) == _size(j_png)


def test_generate_report_cli_out_png(tmp_path):
    _write_logs(tmp_path, LOGS)
    out = str(tmp_path / "sub" / "report.png")
    assert t_report_cli.main(["--output_path", str(tmp_path),
                              "--out_png", out]) == out
    assert _size(out) == (600 * 4, 525)


# -------------------------------------------------------------- heat map

@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_temporal_heat_map_matches_jax(r3d, tmp_path, metric):
    """Positions equal; distances within 1e-4 of JAX's; PNG sizes equal."""
    jcfg = r3d["jcfg"]
    _, (j_ds, _) = j_loader("test", jcfg, triplets=False, drop_last=False,
                            batch_size=1)
    state = types.SimpleNamespace(params=r3d["params"],
                                  batch_stats=r3d["stats"])
    j_png = str(tmp_path / "j.png")
    j_pos, j_d = j_heatmap.temporal_heat_map(
        state, r3d["fmodel"], jcfg, j_ds, exemplar_idx=0, test_idx=1,
        out_png=j_png, metric=metric)
    cfg, model = _port_model(r3d["cfg"], r3d["sd"])
    _, (t_ds, _) = t_loader("test", cfg, triplets=False, drop_last=False,
                            batch_size=1, device="cpu")
    t_png = str(tmp_path / "t.png")
    t_pos, t_d = t_heatmap.temporal_heat_map(
        model, cfg, t_ds, exemplar_idx=0, test_idx=1, out_png=t_png,
        metric=metric, device="cpu")
    np.testing.assert_array_equal(t_pos, j_pos)
    assert list(t_pos) == [4, 6, 8, 10]
    np.testing.assert_allclose(t_d, np.asarray(j_d), atol=1e-4, rtol=0)
    assert _size(t_png) == _size(j_png) == (960, 360)


# -------------------------------------------------------------- exemplar grid

def test_exemplar_retrievals_match_jax(tmp_path):
    """Seeded embeddings (default_rng(5)); each train video's first frame
    a distinct solid colour, so the grid's cells show which videos it
    retrieved: the port's top-5 of each of 4 queries equal JAX's, and the
    PNG's size equals the JAX figure's."""
    rng = np.random.default_rng(5)
    train_emb = rng.normal(size=(12, 16)).astype(np.float32)
    test_emb = rng.normal(size=(6, 16)).astype(np.float32)
    colours = [(20 * i + 10, 255 - 20 * i, (97 * i) % 256) for i in range(12)]

    def samples(prefix, cols):
        out = []
        for i, col in enumerate(cols):
            d = tmp_path / f"{prefix}{i}"
            d.mkdir()
            Image.new("RGB", (40, 30), col).save(d / "image_00001.jpg",
                                                 quality=95)
            out.append({"video": str(d)})
        return out

    train_s = samples("train", colours)
    test_s = samples("test", [(0, 0, 0)] * 6)
    j_png = j_knn.plot_exemplar_retrievals(test_emb, train_emb, test_s,
                                           train_s, str(tmp_path / "j.png"))
    t_png = t_knn.plot_exemplar_retrievals(test_emb, train_emb, test_s,
                                           train_s, str(tmp_path / "t.png"),
                                           device="cpu")
    assert _size(t_png) == _size(j_png) == (240 * 6, 240 * 4)
    want, _ = j_topk(test_emb[:4], train_emb, k=5)
    with Image.open(t_png) as im:
        grid = np.asarray(im.convert("RGB")).astype(int)
    pad = int(240 * 0.12)
    pal = np.asarray(colours)
    for r in range(4):
        for c in range(5):
            px = grid[r * 240 + pad + (240 - pad) // 2, (c + 1) * 240 + 120]
            got = int(np.argmin(np.abs(pal - px).sum(1)))
            assert np.abs(pal[got] - px).max() <= 8
            assert got == int(want[r, c])


# -------------------------------------------------------------- t-SNE

def _clusters(n_per, classes, d, seed):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(classes, d)) * 2.0
    labels = np.repeat(np.arange(classes), n_per)
    x = centres[labels] + rng.normal(size=(len(labels), d))
    perm = rng.permutation(len(labels))
    return x[perm].astype(np.float32), labels[perm] * 3 + 7


def test_tsne_plot_matches_jax(tmp_path, monkeypatch, one_thread):
    """8 classes x 60 points of 64-d (default_rng(0)), 5 classes drawn with
    seed 3 (~300 points): the rows each package selects are equal; the
    port's final KL is at most 1.1x scikit-learn's ``kl_divergence_`` and
    its trustworthiness (k = 10, against the t-SNE's input) within 0.02
    of scikit-learn's; both PNGs 1500 x 1200."""
    import sklearn.decomposition
    import sklearn.manifold
    from sklearn.manifold import trustworthiness

    x, labels = _clusters(60, 8, 64, 0)
    seen = {}

    class PCASpy(sklearn.decomposition.PCA):
        def fit_transform(self, X, y=None):
            seen.setdefault("j_rows", np.array(X))
            return super().fit_transform(X)

    class TSNESpy(sklearn.manifold.TSNE):
        def fit_transform(self, X, y=None):
            out = super().fit_transform(X)
            seen["j_x"], seen["j_y"] = np.array(X), out
            seen["j_kl"] = self.kl_divergence_
            return out

    monkeypatch.setattr(sklearn.decomposition, "PCA", PCASpy)
    monkeypatch.setattr(sklearn.manifold, "TSNE", TSNESpy)
    j_png = j_tsne.tsne_plot(x, labels, out_path=str(tmp_path / "j.png"),
                             n_classes=5, seed=3)

    pca, tsne = t_tsne.pca, t_tsne.tsne

    def pca_spy(rows, k):
        seen.setdefault("t_rows", rows.numpy().copy())
        return pca(rows, k)

    def tsne_spy(rows, **kw):
        out = tsne(rows, **kw)
        seen["t_x"], seen["t_y"], seen["t_kl"] = rows.numpy(), *out[:2]
        return out

    monkeypatch.setattr(t_tsne, "pca", pca_spy)
    monkeypatch.setattr(t_tsne, "tsne", tsne_spy)
    t_png = t_tsne.tsne_plot(x, labels, out_path=str(tmp_path / "t.png"),
                             n_classes=5, seed=3, device="cpu")
    np.testing.assert_array_equal(seen["t_rows"], seen["j_rows"])
    assert 200 < len(seen["t_rows"]) < 400
    assert seen["t_kl"] <= 1.1 * seen["j_kl"]
    t_trust = trustworthiness(seen["t_x"], seen["t_y"].numpy(),
                              n_neighbors=10)
    j_trust = trustworthiness(seen["j_x"], seen["j_y"], n_neighbors=10)
    assert abs(t_trust - j_trust) <= 0.02
    assert _size(t_png) == _size(j_png) == (1500, 1200)


def test_choose_classes_matches_jax_draw():
    labels = np.repeat(np.arange(30) * 2, 3)
    for seed in range(3):
        rng = np.random.default_rng(seed)  # the JAX function's lines
        want = rng.choice(np.unique(labels), size=20, replace=False)
        np.testing.assert_array_equal(
            t_tsne.choose_classes(labels, 20, seed), want)


def test_pca_matches_sklearn(one_thread):
    """300 x 64 rows (default_rng(2)), 50 components: within 1e-4 of
    scikit-learn's PCA on the same rows in float64, up to column sign."""
    from sklearn.decomposition import PCA

    x, _ = _clusters(60, 5, 64, 2)
    want = PCA(n_components=50).fit_transform(x.astype(np.float64))
    got = t_tsne.pca(torch.from_numpy(x), 50).numpy()
    signs = np.sign((want * got).sum(0))
    np.testing.assert_allclose(got * signs, want, atol=1e-4, rtol=0)


def test_conditional_p_matches_sklearn(one_thread):
    """Each row's bisection to perplexity 30 over its 91 neighbours
    (default_rng(4) rows) equals sklearn's ``_binary_search_perplexity``
    within 1e-12."""
    from sklearn.manifold import _utils

    x, _ = _clusters(40, 5, 32, 4)
    _, dist = topk_neighbors(torch.from_numpy(x), torch.from_numpy(x), 91,
                             metric="euclidean", exclude_self=True)
    d2 = dist * dist
    want = _utils._binary_search_perplexity(d2.numpy(), 30.0, 0)
    got = t_tsne.conditional_p(d2, 30.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)


def test_tab20_is_matplotlibs():
    import matplotlib

    cmap = matplotlib.colormaps["tab20"]
    assert plotting.TAB20 == tuple(
        tuple(round(255 * c) for c in cmap(i)[:3]) for i in range(20))


# -------------------------------------------------------------- models

@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_triplet_net_matches_jax(r3d, metric):
    """Three seeded (default_rng(6)) batches of 2 clips through the tiny
    R3D in eval mode: distances and embeddings within 1e-5."""
    rng = np.random.default_rng(6)
    clips = [rng.normal(size=(2, 4, 16, 16, 3)).astype(np.float32)
             for _ in range(3)]
    jnet = JTripletNet(encoder=r3d["fmodel"], dist_metric=metric)
    want = jnet.apply({"params": {"encoder": r3d["params"]},
                       "batch_stats": {"encoder": r3d["stats"]}},
                      *[jnp.asarray(c) for c in clips], train=False)
    _, model = _port_model(r3d["cfg"], r3d["sd"])
    net = TripletNet(model, dist_metric=metric).eval()
    with torch.no_grad():
        got = net(*[torch.from_numpy(c) for c in clips])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


def test_backbone_feature_dim_matches_jax():
    for depth in (10, 18, 34, 50, 101, 152, 200):
        for widen in (0.25, 1.0, 2.0):
            assert backbone_feature_dim(depth, widen) == \
                j_resnet3d.backbone_feature_dim(depth, widen)


# -------------------------------------------------------------- tsne CLI

def test_tsne_cli_writes_its_png(r3d, tmp_path, one_thread):
    """The port's tsne CLI on the .pth.tar with --device cpu: the
    validation split's 4 videos, all 4 classes."""
    out = str(tmp_path / "tsne.png")
    assert t_tsne_cli.main(["--cfg", r3d["cfg"], "--checkpoint_path",
                            r3d["ckpt"], "--output", out, "--n_classes", "4",
                            "--device", "cpu"]) == out
    assert _size(out) == (1500, 1200)
