"""The port's host data path against the JAX package's, on tiny synthetic
JPEGs (tests/synthetic_data.py: 48x48, 12 frames).

* manifests (UCF JSON, Kinetics CSV, cluster labels) and temporal
  transforms: identical outputs, the random ones under the same seed;
* the native decoder (each package builds its own copy of the same C++
  source): byte-identical clips for eval, train and RRC;
* the PIL path: the port's cv2-free resize within 1 gray level of the JAX
  package's cv2 resize, mean difference under 0.05;
* datasets, collate and PrefetchLoader: identical windows, index/target
  streams, picks, batches, padding, masks and shards.
"""

import os

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from synthetic_data import add_synthetic_flow, make_synthetic_ucf
from video_similarity_search_tpu.config import get_cfg as j_get_cfg
from video_similarity_search_tpu.data import datasets as j_ds
from video_similarity_search_tpu.data import manifests as j_man
from video_similarity_search_tpu.data import native_loader as j_native
from video_similarity_search_tpu.data import pipeline as j_pipe
from video_similarity_search_tpu.data import temporal as j_tmp
from video_similarity_search_tpu_torch.config import get_cfg as t_get_cfg
from video_similarity_search_tpu_torch.data import datasets as t_ds
from video_similarity_search_tpu_torch.data import manifests as t_man
from video_similarity_search_tpu_torch.data import native_loader as t_native
from video_similarity_search_tpu_torch.data import pipeline as t_pipe
from video_similarity_search_tpu_torch.data import temporal as t_tmp

N_FRAMES, SIZE, DUR = 12, 48, 4


@pytest.fixture(scope="module")
def syn(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("syn"))
    vid, ann = make_synthetic_ucf(root, n_frames=N_FRAMES, size=SIZE,
                                  with_test=True)
    flow_u, flow_v = add_synthetic_flow(root, n_frames=N_FRAMES, size=SIZE)
    return {"vid": vid, "ann": ann, "flow_u": flow_u, "flow_v": flow_v}


@pytest.fixture(scope="module")
def natives():
    if not (j_native.available() and t_native.available()):
        pytest.skip("a native decoder does not build here (no libjpeg)")


def _cfgs(syn, opts=()):
    out = []
    for cfg in (j_get_cfg(), t_get_cfg()):
        cfg.merge_from_list(
            ["TRAIN.DATASET", "ucf101", "DATASET.VID_PATH", syn["vid"],
             "DATASET.ANNOTATION_PATH", syn["ann"],
             "DATASET.OPTICAL_U_PATH", syn["flow_u"],
             "DATA.SAMPLE_DURATION", DUR, "DATA.SAMPLE_SIZE", 16,
             "TRAIN.BATCH_SIZE", 3, "TRAIN.NUM_DATA_WORKERS", 1]
            + list(opts))
        out.append(cfg)
    return out


def _seed_temporal(seed):
    j_tmp.TemporalTransform.seed(seed)
    t_tmp.TemporalTransform.seed(seed)


def _assert_items_equal(a, b, clip_tol=0):
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.dtype == np.uint8 and clip_tol:
            d = np.abs(x.astype(int) - y.astype(int))
            assert d.max() <= clip_tol, k
        else:
            np.testing.assert_array_equal(x, y, err_msg=k)


# -- manifests --------------------------------------------------------------

@pytest.mark.parametrize("split,val_sample", [("train", 1), ("val", 1),
                                              ("val", 2), ("test", 1)])
def test_ucf_manifest_matches(syn, split, val_sample):
    kw = dict(annotation_path=syn["ann"], root_path=syn["vid"], split=split,
              sample_duration=DUR, val_sample=val_sample, seed=3,
              channel_ext={"optical_u": syn["flow_u"], "salient": "/sal"},
              cluster_labels=[5, 6, 7, 8, 9, 10, 11, 12, 13, 14],
              verbose=False)
    t = t_man.get_manifest("ucf101", **kw)
    assert t == j_man.get_manifest("ucf101", **kw)
    assert t[0]


def test_handstand_and_short_videos(tmp_path):
    import json

    db = {"v_HandStandPushups_g01_c01": {
              "subset": "training",
              "annotations": {"label": "HandStandPushups",
                              "segment": [1, 40]}},
          "v_Shorty_g01_c01": {"subset": "training",
                               "annotations": {"label": "Shorty",
                                               "segment": [1, 5]}}}
    ann = tmp_path / "a.json"
    ann.write_text(json.dumps({"labels": ["HandStandPushups", "Shorty"],
                               "database": db}))
    kw = dict(annotation_path=str(ann), root_path="/r", split="train",
              sample_duration=8, channel_ext={"optical_u": "/u"},
              verbose=False)
    t, j = t_man.load_video_manifest(**kw), j_man.load_video_manifest(**kw)
    assert t == j and len(t[0]) == 1
    assert t[0][0]["optical_u"] == "/u/v_HandstandPushups_g01_c01"
    assert t_man._fix_handstand("v_HandStandPushups_g01_c01") == \
        j_man._fix_handstand("v_HandStandPushups_g01_c01")


@pytest.mark.parametrize("classes_file", [False, True])
def test_kinetics_manifest_matches(tmp_path, classes_file):
    ann = tmp_path / "ann"
    ann.mkdir()
    (ann / "train.csv").write_text(
        "zumba/v1 32 zumba\nabseiling/v2,40,abseiling\n"
        "juggling/v3 4 juggling\nmystery/v4 32 mystery\n")
    (ann / "val.csv").write_text("juggling/v9 32 juggling\nzumba/v8 32 zumba\n")
    if classes_file:
        (ann / "classes.txt").write_text("zumba\nabseiling\njuggling\n")
    for split in ("train", "val"):
        kw = dict(annotation_path=str(ann), root_path=str(tmp_path),
                  split=split, sample_duration=4, verbose=False,
                  cluster_labels=[3, 1, 2])
        assert t_man.get_manifest("kinetics", channel_ext={}, seed=0,
                                  **kw) == j_man.get_manifest(
            "kinetics", channel_ext={}, seed=0, **kw)


def test_cluster_labels_round_trip(tmp_path, syn):
    labels = [3, 0, 7, 7, 1, 2, 2, 9, 4]
    tp, jp = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    t_man.write_cluster_labels(tp, np.array(labels))
    j_man.write_cluster_labels(jp, labels)
    with open(tp) as f, open(jp) as g:
        assert f.read() == g.read()
    assert t_man.read_cluster_labels(jp) == j_man.read_cluster_labels(tp) \
        == labels
    assert t_man.read_cluster_labels(str(tmp_path / "none.txt")) is None
    kw = dict(annotation_path=syn["ann"], root_path=syn["vid"],
              split="train", sample_duration=DUR, cluster_path=tp,
              verbose=False)
    t, _ = t_man.load_video_manifest(**kw)
    assert t == j_man.load_video_manifest(**kw)[0]
    assert [s["cluster_label"] for s in t] == labels[:len(t)]
    assert len(t) == 6  # 2 training videos in each of 3 classes


# -- temporal transforms ----------------------------------------------------

lengths = st.integers(min_value=1, max_value=80)
sizes = st.integers(min_value=1, max_value=24)
seeds = st.integers(0, 2 ** 31)


@settings(max_examples=40, deadline=None)
@given(lengths, sizes, st.integers(min_value=0, max_value=30), seeds,
       st.integers(min_value=1, max_value=5))
def test_random_transforms_same_draws(n, size, start, seed, block):
    frames = list(range(1, n + 1))
    for name, args in (("TemporalRandomCrop", (size, start)),
                       ("TemporalRandomCrop2xSpeed", (size, start)),
                       ("Shuffle", (block,))):
        _seed_temporal(seed)
        j, t = getattr(j_tmp, name)(*args), getattr(t_tmp, name)(*args)
        assert [t(frames) for _ in range(3)] == [j(frames) for _ in range(3)]
    _seed_temporal(seed)
    j = j_tmp.Compose([j_tmp.TemporalRandomCrop(size), j_tmp.Shuffle(block)])
    t = t_tmp.Compose([t_tmp.TemporalRandomCrop(size), t_tmp.Shuffle(block)])
    assert t(frames) == j(frames)


@settings(max_examples=40, deadline=None)
@given(lengths, sizes, st.integers(min_value=0, max_value=30),
       st.integers(min_value=1, max_value=6))
def test_fixed_transforms_match(n, size, arg, k):
    frames = list(range(1, n + 1))
    for name, args in (("LoopPadding", (size,)),
                       ("TemporalBeginCrop", (size,)),
                       ("TemporalEndCrop", (size,)),
                       ("TemporalCenterCrop", (size,)),
                       ("TemporalSpecificCrop", (arg, size)),
                       ("TemporalEvenCrop", (size, k)),
                       ("SlidingWindow", (size, arg)),
                       ("TemporalSubsampling", (k,)),
                       ("TemporalCenterFrame", ())):
        assert getattr(t_tmp, name)(*args)(frames) == \
            getattr(j_tmp, name)(*args)(frames), name
    assert t_tmp.get_test_video_frame_indices(n, size) == \
        j_tmp.get_test_video_frame_indices(n, size)
    assert t_tmp.temporal_ds_frame_indices(size, n, arg, k) == \
        j_tmp.temporal_ds_frame_indices(size, n, arg, k)


def test_temporal_rng_is_the_ports_own():
    assert t_tmp.TemporalTransform is not j_tmp.TemporalTransform
    j_tmp.TemporalTransform.seed(1)
    before = j_tmp.TemporalTransform.rng
    t_tmp.TemporalTransform.seed(2)
    assert j_tmp.TemporalTransform.rng is before


# -- the native decoder and the cv2-free resize -----------------------------

def _frame_paths(syn, idx, video="v_class0_g00_c01", label="class0"):
    return [os.path.join(syn["vid"], label, video, f"image_{i:05d}.jpg")
            for i in idx]


def test_native_decoder_byte_identical(syn, natives):
    paths = _frame_paths(syn, range(1, 9))
    for size, eval_mode in ((32, False), (16, True), (48, True), (64, False)):
        np.testing.assert_array_equal(
            t_native.decode_frames(paths, size, eval_mode),
            j_native.decode_frames(paths, size, eval_mode))
    for box in ((1.0, 2.0, 40.0, 30.0, -1.0, -1.0),
                (1.0, 1.0, 96.0, 94.0, 97.0, 95.0)):
        top, left, ch, cw, bh, bw = box
        np.testing.assert_array_equal(
            t_native.decode_frames_rrc(paths, top, left, ch, cw, 16,
                                       box_h=bh, box_w=bw),
            j_native.decode_frames_rrc(paths, top, left, ch, cw, 16,
                                       box_h=bh, box_w=bw))


def _readers(mode, seed=0, channel_ext=None):
    kw = dict(buffer_size=32 if mode == "train" else 16,
              eval_mode=mode == "eval",
              rrc_size=16 if mode == "rrc" else None)
    return (j_ds.ClipReader(channel_ext or {}, rng=np.random.default_rng(seed),
                            **kw),
            t_ds.ClipReader(channel_ext or {}, rng=np.random.default_rng(seed),
                            **kw))


@pytest.mark.parametrize("mode", ["eval", "train", "rrc"])
def test_clip_reader_native_byte_identical(syn, natives, mode):
    jr, tr = _readers(mode)
    assert tr.backend == "native"
    sample = {"video": os.path.join(syn["vid"], "class1", "v_class1_g01_c01"),
              "num_frames": N_FRAMES, "label": 1}
    for idx in ([1, 2, 3, 4], [9, 10, 11, 12, 13, 14]):  # tail loop-padded
        np.testing.assert_array_equal(tr.load(sample, idx),
                                      jr.load(sample, idx))
    assert tr.decoded == {f"native{'_rrc' if mode == 'rrc' else ''}": 2}


def test_missing_leading_frame_takes_the_pil_path(syn, natives):
    jr, tr = _readers("eval")
    sample = {"video": os.path.join(syn["vid"], "class0", "v_class0_g00_c01"),
              "num_frames": N_FRAMES, "label": 0}
    idx = [0, 1, 2, 3]  # frame 0 does not exist
    a, b = tr.load(sample, idx), jr.load(sample, idx)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert tr.decoded == {"pil_leading_frame_missing": 1}


@pytest.mark.parametrize("mode", ["eval", "train", "rrc"])
def test_cv2_free_resize_within_one_gray_level(syn, monkeypatch, mode):
    # the PIL path in both packages: cv2 in the JAX one, torch in the port
    monkeypatch.setattr(j_native, "available", lambda: False)
    ext = {"optical_u": (syn["flow_u"], t_pipe.VideoLoader(
        t_man.optical_img_name_formatter, t_pipe.BinaryImageLoaderPIL))}
    jr, tr = _readers(mode, seed=4, channel_ext=ext)
    tr.backend = "pil"
    diffs = []
    for c in range(3):
        for v in range(2):
            vid = f"v_class{c}_g{v:02d}_c01"
            sample = {"video": os.path.join(syn["vid"], f"class{c}", vid),
                      "num_frames": N_FRAMES, "label": c,
                      "optical_u": os.path.join(syn["flow_u"], vid)}
            for kw in ({}, {"pos_channel_replace": True}):
                a = tr.load(sample, list(range(1, 9)), **kw)
                b = jr.load(sample, list(range(1, 9)), **kw)
                assert a.shape == b.shape
                diffs.append(np.abs(a.astype(int) - b.astype(int)).ravel())
    d = np.concatenate(diffs)
    assert d.max() <= 1 and d.mean() < 0.05
    assert sum(tr.decoded.values()) > 0
    assert all(k.startswith("pil") for k in tr.decoded)


@pytest.mark.parametrize("shape,out", [((4, 48, 48, 3), (16, 16)),
                                       ((3, 240, 320, 3), (128, 128)),
                                       ((2, 37, 53, 1), (96, 80))])
def test_resize_frames_matches_cv2(shape, out):
    rng = np.random.default_rng(0)
    frames = list(rng.integers(0, 256, shape, np.uint8))
    for kw in ({}, {"keep_aspect_short_edge": out[0]}):
        a = t_ds._resize_frames(frames, out, **kw)
        b = j_ds._resize_frames(frames, out, **kw)
        assert a.shape == b.shape
        d = np.abs(a.astype(int) - b.astype(int))
        assert d.max() <= 1 and d.mean() < 0.05


# -- datasets, collate, loaders ---------------------------------------------

def test_video_dataset_test_windows_identical(syn, natives):
    jcfg, tcfg = _cfgs(syn)
    _, (jd, _) = j_pipe.build_data_loader("test", jcfg, triplets=False)
    _, (td, _) = t_pipe.build_data_loader("test", tcfg, triplets=False,
                                          device="cpu")
    assert len(td) == len(jd) == 3
    items = [(td[i], jd[i]) for i in range(len(td))]
    for t, j in items:
        assert t["clip"].shape == (3, DUR, 16, 16, 3)  # 12 frames, 3 windows
        _assert_items_equal(t, j)
    _assert_items_equal(t_pipe.collate_videos([t for t, _ in items]),
                        j_pipe.collate_videos([j for _, j in items]))


@pytest.mark.parametrize("opts,split,neg", [
    (["LOSS.LOCAL_LOCAL_CONTRAST", True], "train", False),
    (["LOSS.RELATIVE_SPEED_PERCEPTION", True], "train", False),
    (["LOSS.INTRA_NEGATIVE", True, "DATASET.POSITIVE_SAMPLING_P", 0.3],
     "train", False),
    (["DATASET.POSITIVE_SAMPLING_P", 0.5], "val", True),
    (["MODEL.PREDICT_TEMPORAL_DS", True], "train", False),
], ids=["llc", "rsp", "intra_neg", "val_negative", "temporal_ds"])
def test_triplet_streams_identical(syn, natives, opts, split, neg):
    jcfg, tcfg = _cfgs(syn, opts)
    _, (jd, _) = j_pipe.build_data_loader(split, jcfg, negative_sampling=neg)
    _, (td, _) = t_pipe.build_data_loader(split, tcfg, negative_sampling=neg,
                                          device="cpu")
    _seed_temporal(11)
    t_items = [td[i] for i in range(len(td))]
    _seed_temporal(11)
    j_items = [jd[i] for i in range(len(jd))]
    for t, j in zip(t_items, j_items):
        _assert_items_equal(t, j)
    _assert_items_equal(t_pipe.collate_triplets(t_items),
                        j_pipe.collate_triplets(j_items))


def test_triplet_streams_with_channel_replace_and_host_rrc(syn, natives,
                                                           monkeypatch):
    opts = ["DATASET.POS_CHANNEL_REPLACE", True,
            "DATASET.PROB_POS_CHANNEL_REPLACE", 0.5,
            "DATASET.CHANNEL_EXTENSIONS", "optical_u", "TPU.HOST_RRC", True,
            "LOSS.LOCAL_LOCAL_CONTRAST", True,
            "DATASET.POSITIVE_SAMPLING_P", 0.5]
    jcfg, tcfg = _cfgs(syn, opts)
    _, (jd, _) = j_pipe.build_data_loader("train", jcfg)
    _, (td, _) = t_pipe.build_data_loader("train", tcfg, device="cpu")
    jd.reader.rng = np.random.default_rng(5)
    td.reader.rng = np.random.default_rng(5)
    _seed_temporal(3)
    t_items = [td[i] for i in range(len(td))]
    _seed_temporal(3)
    j_items = [jd[i] for i in range(len(jd))]
    for t, j in zip(t_items, j_items):
        # optical_u replacement views are resized by cv2 / torch
        _assert_items_equal(t, j, clip_tol=1)
    assert td.reader.decoded["native_rrc"] > 0


def _cluster_cfgs(syn, labels):
    jcfg, tcfg = _cfgs(syn, ["DATASET.TARGET_TYPE_T", "cluster_label"])
    _, (jd, _) = j_pipe.build_data_loader("train", jcfg,
                                          cluster_labels=labels)
    loader, (td, _) = t_pipe.build_data_loader("train", tcfg,
                                               cluster_labels=labels,
                                               device="cpu")
    return jd, td, loader


def test_loader_rebuild_targets_are_cluster_labels(syn):
    labels = np.array([4, 4, 1, 0, 1, 2])
    jd, td, loader = _cluster_cfgs(syn, labels)
    assert td.target_type == jd.target_type == "cluster_label"
    np.testing.assert_array_equal(td.data_labels, jd.data_labels)
    seen = 0
    for batch in loader:
        b = batch["__size__"]
        np.testing.assert_array_equal(batch["targets"][:b],
                                      labels[batch["index"][:b]])
        seen += b
    assert seen == len(loader) * loader.batch_size


def test_eval_batch_rounds_to_the_device_count(syn):
    jcfg, tcfg = _cfgs(syn)
    jl, _ = j_pipe.build_data_loader("train", jcfg, triplets=False)
    tl8, _ = t_pipe.build_data_loader("train", tcfg, triplets=False,
                                      device="cpu", device_count=8)
    tl1, _ = t_pipe.build_data_loader("train", tcfg, triplets=False,
                                      device="cpu")
    assert jl.batch_size == tl8.batch_size == 16  # 6 x 3 = 18, down to 16
    assert tl1.batch_size == 18


class _DS:
    def __init__(self, n=10):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        w = 1 + i % 3
        return {"clip": np.full((w, 2, 4, 4, 3), i, np.uint8),
                "target": i % 4, "index": i}


@pytest.mark.parametrize("shuffle,drop_last,shards,bs", [
    (False, False, 1, 4), (True, False, 1, 4), (True, True, 1, 3),
    (True, False, 3, 2), (False, True, 3, 2), (True, False, 4, 3)])
def test_prefetch_loader_matches_jax(shuffle, drop_last, shards, bs):
    for epoch in (0, 1):
        for shard in range(shards):
            kw = dict(shuffle=shuffle, drop_last=drop_last, num_workers=2,
                      seed=7, shard_index=shard, num_shards=shards)
            jl = j_pipe.PrefetchLoader(_DS(), bs,
                                       collate=j_pipe.collate_videos, **kw)
            tl = t_pipe.PrefetchLoader(_DS(), bs,
                                       collate=t_pipe.collate_videos, **kw)
            jl.set_epoch(epoch)
            tl.set_epoch(epoch)
            np.testing.assert_array_equal(tl._indices(), jl._indices())
            assert len(tl) == len(jl)
            jb, tb = list(jl), list(tl)
            assert len(tb) == len(jb) == len(jl)
            for t, j in zip(tb, jb):
                _assert_items_equal(t, j)


def test_collate_takes_big_arrays_from_alloc():
    asked = []

    def alloc(name, shape, dtype):
        asked.append((name, tuple(shape)))
        return np.empty(shape, dtype)

    items = [_DS()[i] for i in range(3)]
    out = t_pipe.collate_videos(items, alloc=alloc)
    assert asked == [("clip", (6, 2, 4, 4, 3))]
    _assert_items_equal(out, j_pipe.collate_videos(items))
    trip = [{"anchor": np.full((2, 4, 4, 3), i, np.uint8),
             "positive": np.zeros((2, 4, 4, 3), np.uint8),
             "extra": np.ones((2, 4, 4, 3), np.uint8),
             "targets": (i, i + 1), "index": i} for i in range(4)]
    asked.clear()
    out = t_pipe.collate_triplets(trip, alloc=alloc)
    assert [a[0] for a in asked] == ["anchor", "positive", "extra"]
    _assert_items_equal(out, j_pipe.collate_triplets(trip))
    assert list(out["targets"]) == [0, 1, 2, 3, 1, 2, 3, 4]


def test_abandoned_iterator_shuts_down_cleanly():
    ld = t_pipe.PrefetchLoader(_DS(), 4, shuffle=False, drop_last=False,
                               collate=t_pipe.collate_videos, num_workers=1)
    it = iter(ld)
    next(it)
    del it  # generator close -> stop event -> producer exits its put loop
    # a fresh iteration still works after the abandonment
    assert len(list(ld)) == 3
    assert len(ld.wait_s) == 3


def test_producer_exception_propagates():
    class Bad(_DS):
        def __getitem__(self, i):
            if i == 5:
                raise FileNotFoundError("corrupt frame")
            return super().__getitem__(i)

    ld = t_pipe.PrefetchLoader(Bad(), 4, shuffle=False, drop_last=False,
                               collate=t_pipe.collate_videos, num_workers=1)
    with pytest.raises(RuntimeError, match="producer failed"):
        list(ld)
