"""``build_data_loader`` + prefetching with a pinned side-stream upload (port
of the JAX package's ``data/pipeline.py``).

Reference ``build_data_loader`` (datasets/data_loader.py:205-342) returns a
torch DataLoader with DistributedSampler. Here, as in the JAX package:

  * the dataset objects produce numpy uint8 clips (datasets.py);
  * a thread-pool prefetcher (JPEG decode releases the GIL) assembles
    batches ahead of consumption (``TPU.PREFETCH_DEPTH``);
  * per-process sharding replaces DistributedSampler: each process
    iterates its contiguous slice of the (epoch-reshuffled) permutation;
  * ragged final batches are PADDED to the static batch size (repeating
    the last item) with ``__size__`` = real item count and ``__valid__`` a
    boolean item mask; train triplet loaders drop_last like the reference;
  * per-GPU batch = BATCH_SIZE / world and 6x for non-triplet eval loaders
    (reference :300-313) is preserved as global BATCH_SIZE (and 6x eval).

The upload (``device_upload=True``, ``TPU.PREFETCH_DEVICE_PUT``) takes the
place of the JAX package's producer-side ``device_put``: the producer
collates each batch's clip arrays straight into a ring of
``prefetch_depth + 1`` preallocated page-locked host buffers, copies them
to the card with ``non_blocking=True`` on its own CUDA stream and records
an event; the consumer's stream waits on that event and the device
tensors are ``record_stream``-ed on it. A ring slot is refilled only after
its copy's event has completed. Leaves under 64 KiB stay on the host.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .datasets import ClipReader, TripletsDataset, VideoDataset
from .loaders import BinaryImageLoaderPIL, VideoLoader
from .manifests import (get_manifest, kp_img_name_formatter,
                        optical_img_name_formatter,
                        salient_img_name_formatter)
from .temporal import (Compose as TemporalCompose, TemporalBeginCrop,
                       TemporalCenterCrop, TemporalRandomCrop,
                       TemporalRandomCrop2xSpeed)

# large array leaves go to the card; small metadata stays on the host
UPLOAD_MIN_BYTES = 1 << 16


def get_channel_extension(cfg) -> Dict[str, Tuple[str, object]]:
    """name -> (root path, loader) (reference datasets/data_loader.py:174-201)."""
    ext: Dict[str, Tuple[str, object]] = {}
    for name in str(cfg.DATASET.CHANNEL_EXTENSIONS).split(","):
        name = name.strip()
        if name == "keypoint":
            ext[name] = (cfg.DATASET.KEYPOINT_PATH,
                         VideoLoader(kp_img_name_formatter,
                                     BinaryImageLoaderPIL))
        elif name == "salient":
            ext[name] = (cfg.DATASET.SALIENT_PATH,
                         VideoLoader(salient_img_name_formatter,
                                     BinaryImageLoaderPIL))
        elif name == "optical_u":
            ext[name] = (cfg.DATASET.OPTICAL_U_PATH,
                         VideoLoader(optical_img_name_formatter,
                                     BinaryImageLoaderPIL))
        elif name == "optical_v":
            ext[name] = (cfg.DATASET.OPTICAL_V_PATH,
                         VideoLoader(optical_img_name_formatter,
                                     BinaryImageLoaderPIL))
    return ext


def build_temporal_transforms(cfg, triplets: bool = True):
    """reference build_temporal_transformation (data_loader.py:124-169)."""
    d = cfg.DATA.SAMPLE_DURATION
    if triplets:
        tt = {
            "anchor": TemporalCompose([TemporalBeginCrop(d)]),
            "positive": TemporalCompose(
                [TemporalRandomCrop(d, start_index=d)]),
            "negative": TemporalCompose([TemporalRandomCrop(d)]),
        }
        if cfg.LOSS.RELATIVE_SPEED_PERCEPTION:
            tt["fast_positive"] = TemporalCompose(
                [TemporalRandomCrop2xSpeed(d, start_index=d)])
        if cfg.LOSS.INTRA_NEGATIVE:
            tt["intra_negative"] = TemporalCompose([TemporalRandomCrop(d)])
        return tt
    if cfg.DATA.TEMPORAL_CROP == "random":
        return TemporalCompose([TemporalRandomCrop(d)])
    return TemporalCompose([TemporalCenterCrop(d)])


def host_alloc(name: str, shape, dtype) -> np.ndarray:
    """The collate functions' default allocator: plain host memory."""
    return np.empty(shape, dtype)


class _PinnedRing:
    """``n`` slots of page-locked host buffers, one per big leaf name, each
    grown when a batch needs more bytes. A slot is handed out again only
    after the event of the last copy out of it has completed."""

    def __init__(self, n: int):
        self.buffers: List[Dict[str, object]] = [{} for _ in range(n)]
        self.events: List[Optional[object]] = [None] * n
        self.next = 0

    def acquire(self) -> int:
        slot = self.next
        self.next = (slot + 1) % len(self.buffers)
        if self.events[slot] is not None:
            self.events[slot].synchronize()
            self.events[slot] = None
        return slot

    def allocator(self, slot: int) -> Callable:
        bufs = self.buffers[slot]

        def alloc(name: str, shape, dtype) -> np.ndarray:
            dtype = np.dtype(dtype)
            nbytes = int(np.prod(shape)) * dtype.itemsize
            if nbytes < UPLOAD_MIN_BYTES:
                return np.empty(shape, dtype)
            buf = bufs.get(name)
            if buf is None or buf.numel() < nbytes:
                buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
                bufs[name] = buf
            return buf[:nbytes].numpy().view(dtype).reshape(shape)

        return alloc


class _Uploaded:
    """A batch whose big leaves are on the card, with the copy's event."""

    def __init__(self, batch: dict, tensors: list, event):
        self.batch, self.tensors, self.event = batch, tensors, event


class _ProducerError:
    """Exception relay from the prefetch thread to the consuming iterator."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class PrefetchLoader:
    """Batched, shuffled, thread-prefetched iterator over a dataset.

    ``device_upload=True`` moves each batch's big array leaves (64 KiB and
    more) to ``device`` inside the producer thread, through the pinned ring
    and a side stream (module docstring), so the host -> card copy overlaps
    the next batch's decode. The collate function is then called as
    ``collate(items, alloc=...)`` and must take its big arrays from
    ``alloc(name, shape, dtype)``, as ``collate_triplets`` and
    ``collate_videos`` do. Upload needs a CUDA device and raises without
    one.

    Per iteration, ``wait_s`` lists the seconds the consumer waited for
    each batch and ``copy_events`` the (start, end) CUDA events of each
    batch's copy."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool,
                 drop_last: bool, collate: Callable, num_workers: int = 4,
                 prefetch_depth: int = 2, seed: int = 0,
                 shard_index: int = 0, num_shards: int = 1,
                 device_upload: bool = False, device="cuda"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate = collate
        self.num_workers = max(1, num_workers)
        self.prefetch_depth = prefetch_depth
        self.seed = seed
        self.epoch = 0
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.device_upload = device_upload
        self.device = None
        if device_upload:
            self.device = resolve_device(device)
            if self.device.type != "cuda":
                raise ValueError(f"device upload needs a CUDA device, got "
                                 f"{self.device}")
        # gradient accumulation (TRAIN.ACCUM_STEPS): big leaves (B, ...)
        # are uploaded as (A, B/A, ...)
        self.upload_microbatch = 1
        self._ring: Optional[_PinnedRing] = None
        self._stream = None
        self.wait_s: List[float] = []
        self.copy_events: List[Tuple] = []
        self._atexit_registered = False
        # current producer (stop event, thread) for the single exit hook
        self._live: Optional[Tuple] = None

    def _upload(self, batch: dict, slot: int) -> _Uploaded:
        """Copy the big leaves of ``batch`` (collated into ring slot
        ``slot``) to the card on the side stream; -> the batch with device
        tensors in their place and the copy's end event."""
        big = {k: v for k, v in batch.items()
               if isinstance(v, np.ndarray)
               and v.nbytes >= UPLOAD_MIN_BYTES}
        out = dict(batch)
        tensors = []
        accum = max(1, int(self.upload_microbatch))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            start.record()
            for k, v in big.items():
                if accum > 1:
                    if v.ndim < 4 or v.shape[0] % accum != 0:
                        # Non-clip leaves (e.g. the triplet 'targets' (2B,)
                        # vector, interleaved [anchors; positives]) need the
                        # consumer's per-microbatch interleaved layout, not
                        # this contiguous reshape, and a leaf that does not
                        # divide is reshaped by the consumer: both stay on
                        # the host, copied out of the ring slot, which the
                        # producer refills while the consumer holds them
                        out[k] = np.array(v)
                        continue
                    v = v.reshape((accum, v.shape[0] // accum) + v.shape[1:])
                dv = torch.from_numpy(v).to(self.device, non_blocking=True)
                out[k] = dv
                tensors.append(dv)
            end.record()
        self._ring.events[slot] = end
        self.copy_events.append((start, end))
        return _Uploaded(out, tensors, end)

    def set_epoch(self, epoch: int) -> None:
        """reference DistributedSampler.set_epoch (online_train.py:672-673)."""
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch_seed"):
            self.dataset.set_epoch_seed(self.seed + epoch)

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            idx = np.random.default_rng(self.seed + self.epoch).permutation(n)
        if self.num_shards > 1:
            # Pad the global permutation (wrapping from the front) so every
            # process's shard has EQUAL length — otherwise per-process batch
            # counts can differ by one and the one with the extra step
            # deadlocks in its collectives. Same semantics as the
            # reference's torch DistributedSampler (data_loader.py:283).
            total = ((n + self.num_shards - 1)
                     // self.num_shards) * self.num_shards
            if total > n:
                idx = np.concatenate([idx, idx[:total - n]])
            idx = idx[self.shard_index::self.num_shards]
        return idx

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator:
        idx = self._indices()
        batches: List[np.ndarray] = []
        end = (len(idx) // self.batch_size * self.batch_size
               if self.drop_last else len(idx))
        for s in range(0, end, self.batch_size):
            batches.append(idx[s:s + self.batch_size])
        if not batches:
            return iter(())

        if self._live is not None:
            # one producer at a time: an abandoned iterator's producer may
            # still be finishing a batch in the shared ring
            self._live[0].set()
            self._live[1].join()
        if self.device_upload and self._ring is None:
            self._ring = _PinnedRing(self.prefetch_depth + 1)
            self._stream = torch.cuda.Stream(device=self.device)
        self.wait_s, self.copy_events = [], []
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            # bounded put that aborts when the consumer abandoned the
            # iterator: a daemon thread blocked forever in out_q.put would
            # be killed at interpreter exit — fatal if it then sits inside
            # a CUDA call (device_upload)
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            # a producer exception must NOT look like a normal end of
            # epoch (a single corrupt JPEG would silently truncate the
            # epoch — and desynchronize per-process step counts under
            # num_shards > 1); ship it to the consumer and re-raise there
            try:
                for bidx in batches:
                    if stop.is_set():
                        break
                    items = list(pool.map(self.dataset.__getitem__, bidx))
                    real = len(items)
                    if real < self.batch_size:
                        # pad+mask the ragged tail to the static batch size
                        items = items + [items[-1]] * (self.batch_size - real)
                    if self.device_upload:
                        slot = self._ring.acquire()
                        batch = self.collate(
                            items, alloc=self._ring.allocator(slot))
                    else:
                        batch = self.collate(items)
                    if batch is not None:
                        batch["__valid__"] = (np.arange(self.batch_size)
                                              < real)
                        batch["__size__"] = real
                        if self.device_upload:
                            batch = self._upload(batch, slot)
                    if not put_or_stop(batch):
                        break
            except BaseException as e:  # noqa: BLE001 - relayed, not dropped
                put_or_stop(_ProducerError(e))
            finally:
                put_or_stop(None)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        # Interpreter-exit safety: a daemon producer killed while inside a
        # CUDA call (device_upload) aborts the process. threading's
        # internal atexit hooks run BEFORE non-daemon joins / runtime
        # teardown, so stop the producer and give it a moment to leave any
        # in-flight copy. ONE callback per loader (tracking the CURRENT
        # producer) — registering per-__iter__ would accumulate a callback
        # per epoch for the process lifetime.
        self._live = (stop, thread)
        if not self._atexit_registered:
            def _drain():
                live = self._live
                if live is not None:
                    live[0].set()
                    live[1].join(timeout=5)

            try:
                threading._register_atexit(_drain)
                self._atexit_registered = True
            except (RuntimeError, AttributeError):  # shutdown began / no API
                pass

        def gen():
            try:
                while True:
                    t0 = time.perf_counter()
                    batch = out_q.get()
                    self.wait_s.append(time.perf_counter() - t0)
                    if batch is None:
                        self.wait_s.pop()
                        break
                    if isinstance(batch, _ProducerError):
                        raise RuntimeError(
                            "PrefetchLoader producer failed"
                        ) from batch.exc
                    if isinstance(batch, _Uploaded):
                        batch = self._receive(batch)
                    yield batch
            finally:
                stop.set()
                # an abandoned iterator leaves a batch's items queued in the
                # pool: drop them rather than decode them for nobody
                pool.shutdown(wait=False, cancel_futures=True)

        return gen()

    def _receive(self, up: _Uploaded) -> dict:
        """Consumer side of the upload: the current stream waits for the
        copy, and owns the device tensors from here on."""
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(up.event)
        for t in up.tensors:
            t.record_stream(cur)
        return up.batch


def collate_triplets(items: List[dict], alloc: Callable = host_alloc) -> dict:
    """Stack triplet items; ``targets`` is (2B,) laid out [anchor targets;
    positive targets], on the host, like the trainer expects."""
    def stack(name: str) -> np.ndarray:
        first = items[0][name]
        out = alloc(name, (len(items),) + first.shape, first.dtype)
        for i, it in enumerate(items):
            out[i] = it[name]
        return out

    out = {
        "anchor": stack("anchor"),
        "positive": stack("positive"),
        "index": np.array([it["index"] for it in items], np.int32),
    }
    a_t = np.array([it["targets"][0] for it in items], np.int32)
    p_t = np.array([it["targets"][1] for it in items], np.int32)
    out["targets"] = np.concatenate([a_t, p_t])  # (2B,) like the trainer
    if "extra" in items[0]:
        out["extra"] = stack("extra")
    if "negative" in items[0]:
        out["negative"] = stack("negative")
        out["n_target"] = np.array([it["n_target"] for it in items], np.int32)
    if "ds_label" in items[0]:
        out["ds_label"] = np.array([it["ds_label"] for it in items], np.int32)
    return out


def collate_videos(items: List[dict], alloc: Callable = host_alloc) -> dict:
    """Flattens multi-window test items (reference datasets/dataset.py:19-31)."""
    clips, targets, indices, window_counts = [], [], [], []
    for it in items:
        clip = it["clip"]
        if clip.ndim == 5:  # (windows, T, H, W, C)
            for w in range(clip.shape[0]):
                clips.append(clip[w])
                targets.append(it["target"])
                indices.append(it["index"])
            window_counts.append(clip.shape[0])
        else:
            clips.append(clip)
            targets.append(it["target"])
            indices.append(it["index"])
            window_counts.append(1)
    stacked = alloc("clip", (len(clips),) + clips[0].shape, clips[0].dtype)
    for i, c in enumerate(clips):
        stacked[i] = c
    return {
        "clip": stacked,
        "target": np.array(targets, np.int32),
        "index": np.array(indices, np.int32),
        "window_counts": np.array(window_counts, np.int32),
    }


def build_data_loader(split: str, cfg, is_master_proc: bool = True,
                      triplets: bool = True, negative_sampling: bool = False,
                      req_train_shuffle: Optional[bool] = None,
                      drop_last: Optional[bool] = None,
                      batch_size: Optional[int] = None,
                      val_sample: Optional[int] = 1,
                      shard_index: int = 0, num_shards: int = 1,
                      buffer_size: Optional[int] = None,
                      test_windows: bool = True,
                      cluster_labels=None, device="cuda",
                      device_count: int = 1):
    """Same role/signature as reference build_data_loader
    (datasets/data_loader.py:205-342). Returns (loader, (dataset,
    idx_to_class)).

    ``cluster_labels``: in-memory pseudo-labels (dataset order) that
    override the CLUSTER_PATH file read. ``device``: where the batches go.
    With ``TPU.PREFETCH_DEVICE_PUT`` and a CUDA ``device`` the loader
    uploads (PrefetchLoader); on a machine without CUDA that raises, and
    ``device="cpu"`` keeps every batch on the host. ``device_count``: the
    auto eval batch is rounded down to a multiple of it (1 on one card)."""
    upload = (bool(cfg.TPU.PREFETCH_DEVICE_PUT)
              and torch.device(device).type == "cuda")
    if upload:
        device = resolve_device(device)  # before any file is read
    dataset_name = cfg.TRAIN.DATASET
    # channel extensions only where the reference attaches them
    # (data_loader.py:230-233): with POS_CHANNEL_REPLACE the extra views
    # exist solely so the TRAIN triplet loader can replace positives —
    # eval/val loaders stay 3-channel RGB; without replacement the
    # extensions concat into the input channels everywhere.
    use_ext = ((triplets and cfg.DATASET.POS_CHANNEL_REPLACE
                and split == "train")
               or not cfg.DATASET.POS_CHANNEL_REPLACE)
    channel_ext = get_channel_extension(cfg) if use_ext else {}
    if channel_ext and not cfg.DATASET.POS_CHANNEL_REPLACE \
            and not cfg.DATASET.MODALITY:
        assert len(channel_ext) + 3 == cfg.DATA.INPUT_CHANNEL_NUM, (
            f"CHANNEL_EXTENSIONS adds {len(channel_ext)} channels but "
            f"INPUT_CHANNEL_NUM={cfg.DATA.INPUT_CHANNEL_NUM} "
            "(reference datasets/data_loader.py:233)")
    cluster_path = cfg.DATASET.CLUSTER_PATH or None

    manifest_kwargs = dict(
        annotation_path=cfg.DATASET.ANNOTATION_PATH,
        root_path=cfg.DATASET.VID_PATH,
        split=split,
        sample_duration=cfg.DATA.SAMPLE_DURATION,
        cluster_path=cluster_path if split == "train" else None,
        cluster_labels=cluster_labels if split == "train" else None,
        verbose=is_master_proc,
    )
    if dataset_name != "kinetics":
        manifest_kwargs["channel_ext"] = {k: v[0]
                                          for k, v in channel_ext.items()}
        manifest_kwargs["val_sample"] = val_sample
    samples, idx_to_class = get_manifest(dataset_name, **manifest_kwargs)

    target_type = (cfg.DATASET.TARGET_TYPE_T if split == "train"
                   else cfg.DATASET.TARGET_TYPE_V)
    if target_type == "cluster_label" and (
            not samples or "cluster_label" not in samples[0]):
        target_type = "label"  # warmup epochs before the first clustering

    sample_size = cfg.DATA.SAMPLE_SIZE
    train_aug = split == "train" and triplets
    # ``buffer_size`` override: ten-crop testing needs a decode buffer
    # larger than the crop so the five crop positions differ (reference
    # scales to 1.14x then crops, coclr_classify.py:528-534)
    reader = ClipReader(
        channel_ext,
        buffer_size=buffer_size or (2 * sample_size if train_aug
                                    else sample_size),
        eval_mode=not train_aug,
        prob_pos_channel_replace=cfg.DATASET.PROB_POS_CHANNEL_REPLACE,
        rrc_size=sample_size if (train_aug and cfg.TPU.HOST_RRC) else None,
    )

    if triplets:
        dataset = TripletsDataset(
            samples,
            temporal_transforms=build_temporal_transforms(cfg, True),
            reader=reader,
            target_type=target_type,
            positive_sampling_p=cfg.DATASET.POSITIVE_SAMPLING_P,
            negative_sampling=negative_sampling,
            pos_channel_replace=(cfg.DATASET.POS_CHANNEL_REPLACE
                                 and split == "train"),
            relative_speed_perception=cfg.LOSS.RELATIVE_SPEED_PERCEPTION,
            local_local_contrast=cfg.LOSS.LOCAL_LOCAL_CONTRAST,
            intra_negative=cfg.LOSS.INTRA_NEGATIVE,
            predict_temporal_ds=cfg.MODEL.PREDICT_TEMPORAL_DS,
            sample_duration=cfg.DATA.SAMPLE_DURATION,
            split=split,
        )
        collate = collate_triplets
        bsz = batch_size or (cfg.TRAIN.BATCH_SIZE if split == "train"
                             else cfg.VAL.BATCH_SIZE)
        shuffle = split == "train" if req_train_shuffle is None \
            else req_train_shuffle
        # static train batches; val keeps its ragged last batch (padded and
        # masked instead of the reference's drop_last, SURVEY §7.4)
        dl = drop_last if drop_last is not None else (split == "train")
    else:
        # test_windows=False: --crop center, one center clip per test video
        # instead of averaged sliding windows (reference evaluate.py:89-143)
        ds_split = split if (split != "test" or test_windows) else "val"
        dataset = VideoDataset(
            samples,
            temporal_transform=build_temporal_transforms(cfg, False),
            reader=reader,
            target_type=target_type,
            split=ds_split,
            sample_duration=cfg.DATA.SAMPLE_DURATION,
        )
        collate = collate_videos
        # 6x eval batch (reference datasets/data_loader.py:300-313), raised
        # to 256 clips when the dataset is big enough to fill it — batch
        # size doesn't change eval results
        default_bsz = (cfg.TRAIN.BATCH_SIZE if split == "train"
                       else cfg.VAL.BATCH_SIZE)
        if cfg.TRAIN.EVAL_BATCH_SIZE:
            bsz = batch_size or cfg.TRAIN.EVAL_BATCH_SIZE
        else:
            bsz = batch_size or min(max(default_bsz * 6, 256),
                                    max(len(samples), default_bsz * 6))
            # the auto batch can land on len(samples) (any value between
            # default*6 and 256) — round down to a device-count multiple
            # so a sharded embedding pass divides evenly
            if bsz > device_count:
                bsz -= bsz % device_count
        shuffle = False if req_train_shuffle is None else req_train_shuffle
        dl = drop_last if drop_last is not None else False

    loader = PrefetchLoader(
        dataset, bsz, shuffle=shuffle, drop_last=dl, collate=collate,
        num_workers=cfg.TRAIN.NUM_DATA_WORKERS,
        prefetch_depth=cfg.TPU.PREFETCH_DEPTH,
        shard_index=shard_index, num_shards=num_shards,
        device_upload=upload, device=device,
    )
    return loader, (dataset, idx_to_class)
