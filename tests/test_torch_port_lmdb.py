"""The port's CoCLR LMDB path against the JAX package's, on the CPU.

* ``write_lmdb`` / ``LiteEnv`` across the two packages, both ways, on a
  store with overflow values (one and several pages) and branch levels:
  the two writers' files byte-equal, every value read back equal;
* the port's msgpack reader against ``msgpack.packb`` over every type a
  CoCLR store holds, and other type codes refused;
* ``frame_sampler`` / ``double_sampler`` equal to JAX's from the same
  numpy seeds; ``subsample_val`` equal to pandas' ``DataFrame.sample`` for
  n from 0 to 400 and at UCF-101 scale;
* every dataset class of ``get_lmdb_dataset`` and both 2-stream classes,
  over one real ``.lmdb`` file, in each mode: items byte-equal;
* ``LMDBClipAdapter`` batches through the port's ``PrefetchLoader``
  byte-equal to the JAX package's loader and collate;
* the classification CLI with ``--lmdb_root --device cpu`` trains an
  epoch, then runs the ten-crop test and ``--retrieval`` on its
  checkpoint.
"""

import io
import os
import random

import msgpack
import numpy as np
import pytest
import torch

from video_similarity_search_tpu.data import lmdb_data as jl
from video_similarity_search_tpu.data import lmdb_lite as jlite
from video_similarity_search_tpu.data.pipeline import \
    PrefetchLoader as JPrefetchLoader
from video_similarity_search_tpu.data.pipeline import \
    collate_videos as j_collate
from video_similarity_search_tpu_torch.cli import coclr_classify as t_cli
from video_similarity_search_tpu_torch.data import lmdb_data as tl
from video_similarity_search_tpu_torch.data import lmdb_lite as tlite
from video_similarity_search_tpu_torch.data import msgpack_lite
from video_similarity_search_tpu_torch.data.pipeline import (PrefetchLoader,
                                                             collate_videos)

CLASSES = ["Jump", "Run"]
FRAME = 40  # stored JPEG frames are FRAME x FRAME


def _jpeg(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG")
    return buf.getvalue()


def _mapping(names, vlens, seed=0):
    """A CoCLR store's key/value pairs (reference lmdb_dataset.py:75-81),
    framed by ``msgpack.packb``."""
    rng = np.random.default_rng(seed)
    mapping = {
        b"__len__": msgpack.packb(len(names)),
        b"__keys__": msgpack.packb([f"{i:09d}".encode()
                                    for i in range(len(names))]),
        b"__order__": msgpack.packb([n.encode() for n in names]),
    }
    for i, (name, vlen) in enumerate(zip(names, vlens)):
        base = rng.integers(0, 256, (FRAME, FRAME, 3))
        frames = [_jpeg(np.clip(base + rng.integers(-30, 30, base.shape),
                                0, 255).astype(np.uint8))
                  for _ in range(vlen)]
        mapping[f"{i:09d}".encode("ascii")] = msgpack.packb(frames)
    return mapping


def _root(tmp_path_factory, test_videos=7):
    """ClassInd.txt, train_split01.csv (8 videos) and test_split01.csv
    (``test_videos``) in the layout of tests/test_lmdb.py; the test rows'
    classes alternate along pandas' validation subset, so validation holds
    both classes. Each row: vpath, rgb vlen, flow vlen."""
    root = str(tmp_path_factory.mktemp("lmdb_root"))
    with open(os.path.join(root, "ClassInd.txt"), "w") as f:
        f.write("\n".join(f"{i + 1},{c}" for i, c in enumerate(CLASSES)))
    val_pick = np.random.RandomState(666).choice(
        test_videos, round(0.3 * test_videos), replace=False)
    test_cls = np.arange(test_videos) % 2
    test_cls[val_pick] = np.arange(len(val_pick)) % 2
    names, vlens = [], []
    for split, classes in (("train", [0, 1] * 4), ("test", test_cls)):
        lines = []
        for i, c in enumerate(classes):
            name = f"{CLASSES[c]}/v_{CLASSES[c]}_{split}{i:02d}"
            vlen = [12, 20, 27, 33][i % 4]  # 12: shorter than two clips
            names.append(name)
            vlens.append(vlen)
            lines.append(f"/data/{name}/frames,{vlen},{vlen - 1}")
        with open(os.path.join(root, f"{split}_split01.csv"), "w") as f:
            f.write("\n".join(lines))
    rgb = _mapping(names, vlens)
    flow = _mapping(names, [v - 1 for v in vlens], seed=1)
    for ds in ("ucf101", "hmdb51", "k400"):
        tlite.write_lmdb(os.path.join(root, f"{ds}_frame.lmdb"), rgb)
        tlite.write_lmdb(os.path.join(root, f"{ds}_tvl1_frame.lmdb"), flow)
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _root(tmp_path_factory)


def _big_mapping():
    rng = random.Random(0)
    mapping = {f"key_{i:06d}".encode():
               bytes(rng.getrandbits(8)
                     for _ in range(rng.choice([0, 5, 120, 900, 1919])))
               for i in range(1500)}
    mapping[b"__keys__"] = b"k" * 20000  # overflow over five pages
    mapping[b"huge"] = bytes(range(256)) * 30  # overflow over two
    mapping[b"\x00binary\xff"] = b"v" * 4000  # one overflow page
    return mapping


@pytest.mark.parametrize("writer,reader", [(jlite, tlite), (tlite, jlite)])
def test_lmdb_files_cross_the_two_packages(tmp_path, writer, reader):
    mapping = _big_mapping()
    path = str(tmp_path / "store.lmdb")
    writer.write_lmdb(path, mapping)
    other = str(tmp_path / "other.lmdb")
    reader.write_lmdb(other, mapping)
    with open(path, "rb") as a, open(other, "rb") as b:
        assert a.read() == b.read()  # the same bytes from both writers
    with reader.LiteEnv(path) as env:
        assert env.entries == len(mapping) and env.depth >= 2
        for k, v in mapping.items():
            assert env.get(k) == v
        assert env.get(b"missing") is None and env.get(b"zzz") is None
        assert dict(env.items()) == mapping
    d = str(tmp_path / "subdir")
    writer.write_lmdb(d, {b"a": b"1", b"b": b"2" * 3000}, subdir=True)
    with reader.LiteEnv(d) as env:
        assert env.get(b"a") == b"1" and env.get(b"b") == b"2" * 3000


STORE_VALUES = [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
    2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
    -2 ** 31 - 1, -2 ** 63, None, "", "a" * 31, "b" * 32, "c" * 255,
    "d" * 256, "é" * 40000, b"", b"x" * 255, b"y" * 256, b"z" * 70000,
    [], list(range(15)), list(range(16)), list(range(70000)), {},
    {b"k%d" % i: i for i in range(15)},
    {"k%d" % i: [i, b"v", None] for i in range(16)},
    [b"\xff\xd8" * 1000] * 50,
]


def test_msgpack_reader_matches_msgpack():
    for value in STORE_VALUES:
        packed = msgpack.packb(value)
        assert (msgpack_lite.loads(packed)
                == msgpack.loads(packed, strict_map_key=False)), \
            repr(value)[:40]
    for other in (1.5, True, False):
        with pytest.raises(ValueError, match="type code"):
            msgpack_lite.loads(msgpack.packb(other))
    with pytest.raises(ValueError, match="runs past the end"):
        msgpack_lite.loads(msgpack.packb(b"abc")[:-1])
    with pytest.raises(ValueError, match="extra data"):
        msgpack_lite.loads(msgpack.packb(1) + b"\x00")


@pytest.mark.parametrize("mode,window", [("train", False), ("val", False),
                                         ("test", False), ("train", True)])
def test_samplers_match_jax(mode, window):
    for vlen in (3, 8, 17, 40, 100, 301):
        for num_frames, ds in ((8, 1), (8, 2), (16, 3)):
            j = jl.frame_sampler(vlen, num_frames, ds, mode, window,
                                 rng=np.random.default_rng(vlen))
            t = tl.frame_sampler(vlen, num_frames, ds, mode, window,
                                 rng=np.random.default_rng(vlen))
            np.testing.assert_array_equal(t, j)
            j = jl.double_sampler(vlen, num_frames, ds, mode,
                                  np.random.default_rng(vlen + 1))
            t = tl.double_sampler(vlen, num_frames, ds, mode,
                                  np.random.default_rng(vlen + 1))
            np.testing.assert_array_equal(t, j)


def test_subsample_val_is_pandas_subset():
    pd = pytest.importorskip("pandas")
    for n in list(range(0, 401)) + [3783, 9537]:
        rows = [{"i": i} for i in range(n)]
        want = pd.DataFrame({"i": np.arange(n)}).sample(
            frac=0.3, random_state=666)["i"].tolist()
        assert [r["i"] for r in tl.subsample_val(rows)] == want, n
    # the JAX function takes pandas' subset when pandas imports, as here
    rows = [{"i": i} for i in range(33)]
    assert tl.subsample_val(rows) == jl.subsample_val(rows)


def _item_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("dataset,flow,two_clip", [
    ("ucf101", False, False), ("ucf101", False, True),
    ("ucf101", True, False), ("ucf101", True, True),
    ("hmdb51", False, False), ("hmdb51", True, False),
    ("k400", False, False), ("k400", False, True),
    ("k400", True, False), ("k400", True, True)])
def test_dataset_items_are_byte_equal(root, dataset, flow, two_clip):
    db = os.path.join(root, f"{dataset}{'_tvl1' if flow else ''}_frame.lmdb")
    for mode in ("train", "val", "test"):
        kw = dict(flow=flow, two_clip=two_clip, mode=mode, num_frames=8,
                  ds=2 if mode == "train" else 1, seed=3)
        j = jl.get_lmdb_dataset(dataset, root, db, **kw)
        t = tl.get_lmdb_dataset(dataset, root, db, **kw)
        assert type(t).__name__ == type(j).__name__
        assert len(t) == len(j) > 0
        assert t.video_subset == j.video_subset
        assert t.idx_to_class == j.idx_to_class
        for i in range(len(t)):
            _item_equal(t[i], j[i])


@pytest.mark.parametrize("name", ["UCF101_2STREAM_LMDB_2CLIP",
                                  "K400_2STREAM_LMDB_2CLIP"])
def test_two_stream_items_are_byte_equal(root, name):
    rgb = os.path.join(root, "ucf101_frame.lmdb")
    flow = os.path.join(root, "ucf101_tvl1_frame.lmdb")
    for mode in ("train", "val"):
        j = getattr(jl, name)(root, rgb, flow, mode=mode, num_frames=8,
                              seed=5)
        t = getattr(tl, name)(root, rgb, flow, mode=mode, num_frames=8,
                              seed=5)
        assert len(t) == len(j) > 0
        for i in range(len(t)):
            _item_equal(t[i], j[i])


def test_dict_reader_and_lmdb_reader_agree(root):
    """The in-memory seam and the file reader serve the same store."""
    db = os.path.join(root, "ucf101_frame.lmdb")
    with tlite.LiteEnv(db) as env:
        mapping = dict(env.items())
    a = tl.UCF101LMDB(root, tl.DictReader(mapping), mode="test",
                      num_frames=8, seed=1)
    b = tl.UCF101LMDB(root, db, mode="test", num_frames=8, seed=1)
    assert isinstance(tl.open_store(db), tl.LMDBReader)
    _item_equal(a[0], b[0])


@pytest.mark.parametrize("mode,buffer,batch", [("train", 64, 4),
                                               ("val", 32, 3),
                                               ("test", 45, 2)])
def test_adapter_batches_match_jax_loader(root, mode, buffer, batch):
    db = os.path.join(root, "ucf101_frame.lmdb")
    loaders = []
    for lib, loader_cls, collate in ((jl, JPrefetchLoader, j_collate),
                                     (tl, PrefetchLoader, collate_videos)):
        ds = lib.UCF101LMDB(root, db, mode=mode, num_frames=8, seed=0)
        adapter = lib.LMDBClipAdapter(ds, buffer, 8)
        loader = loader_cls(adapter, batch, shuffle=mode == "train",
                            drop_last=mode == "train", collate=collate,
                            num_workers=1)
        loader.set_epoch(2)
        loaders.append(list(loader))
    want, got = loaders
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["clip"].shape[1:] == (8, buffer, buffer, 3)
        for k in ("clip", "target", "index", "__valid__"):
            np.testing.assert_array_equal(g[k], w[k])
        assert g["__size__"] == w["__size__"]
        if mode == "test":  # 10 windows a video
            assert set(g["window_counts"][:g["__size__"]]) == {10}


def test_build_lmdb_loader_on_the_cpu(root):
    from video_similarity_search_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.DATA.SAMPLE_DURATION, cfg.DATA.SAMPLE_SIZE = 8, 32
    cfg.TPU.PREFETCH_DEVICE_PUT = True  # an upload only to a CUDA device
    loader, (adapter, idx_to_class) = tl.build_lmdb_loader(
        "ucf101", root, "train", cfg, 4, device="cpu")
    assert idx_to_class == {0: "Jump", 1: "Run"} and adapter.buffer_size == 64
    batch = next(iter(loader))
    assert isinstance(batch["clip"], np.ndarray)
    assert batch["clip"].shape == (4, 8, 64, 64, 3)


@pytest.fixture
def few_torch_threads():
    """Two intra-op threads: a parallel test run shares the cores among
    its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_cli_lmdb_trains_tests_and_retrieves(root, tmp_path, capsys,
                                             few_torch_threads):
    """``--lmdb_root`` end to end on the CPU: one epoch of ``last`` (the
    2x buffer cropped by ``train_augment``, validation on the crop), then
    the ten-crop test and ``--retrieval`` from its model_best.pth.tar."""
    argv = ["--lmdb_root", root, "--device", "cpu", "--seq_len", "8",
            "--img_dim", "32", "--num_class", "2", "--batch_size", "4",
            "--lr", "0.01", "--train_what", "last"]
    out = tmp_path / "out"
    t_cli.main(argv + ["--epochs", "1", "--output", str(out)])
    stdout = capsys.readouterr().out
    assert "epoch 0: lr 0.01000 loss" in stdout and "val top1" in stdout
    best = out / "tnet_checkpoints" / "s3d" / "model_best.pth.tar"
    assert best.exists()  # validation holds both classes: top-1 above 0
    top1, top5 = t_cli.main(argv + ["--checkpoint_path", str(best),
                                    "--output", str(tmp_path / "test")])
    stdout = capsys.readouterr().out
    assert "10-crop test: top1" in stdout and "(2 videos)" in stdout
    assert 0.0 <= top1 <= top5 <= 1.0
    topk = t_cli.main(argv + ["--checkpoint_path", str(best), "--retrieval",
                              "--output", str(tmp_path / "retrieval")])
    assert sorted(topk) == [1, 5, 10, 20, 50]
    assert all(0.0 <= v <= 1.0 for v in topk.values())
    assert "retrieval:" in capsys.readouterr().out
