"""Default configuration tree.

Key names and defaults mirror the reference config
(reference config/default_params.py:5-170) so that the shipped experiment
YAMLs (config/custom_configs/*.yaml) merge unchanged. TPU-specific knobs
live under ``TPU``.

The port's copy of the JAX package's ``config/defaults.py``, with the same
keys and defaults so every shipped YAML merges into both. Of the ``TPU.*``
keys the port reads only ``COMPUTE_DTYPE`` (the autocast dtype on the
card); the rest load and are ignored.
"""

from .node import ConfigNode


def _build_default_cfg() -> ConfigNode:
    _C = ConfigNode()

    # -- Training (reference config/default_params.py:11-19) ---------------
    _C.TRAIN = ConfigNode()
    _C.TRAIN.EPOCHS = 300
    _C.TRAIN.BATCH_SIZE = 16
    _C.TRAIN.DATASET = "ucf101"
    _C.TRAIN.NUM_DATA_WORKERS = 4
    _C.TRAIN.LOG_INTERVAL = 5
    _C.TRAIN.EVAL_BATCH_SIZE = False
    # live scalar metrics to <OUTPUT_PATH>/metrics/ (CSV per log interval +
    # tensorboard events when importable) — the reference's tensorboardX
    # PlotterThread channel (coclr_utils/tensorboard_utils.py:7-31)
    _C.TRAIN.METRICS_SINK = False
    # full train-bank retrieval eval cadence (reference hardcodes 10,
    # online_train.py:736; configurable here, same default)
    _C.TRAIN.RETRIEVAL_INTERVAL = 10
    # TPU-native gradient accumulation: split each train batch into A
    # microbatches scanned sequentially inside ONE jitted step (grads
    # averaged, optimizer applied once). Peak activation memory drops by
    # ~A x, so large EFFECTIVE batches train at the small-batch MFU
    # optimum instead of XLA's emergency-remat regime (PERF.md round 4).
    # Semantics: BN statistics and triplet mining are microbatch-local --
    # exactly the reference's per-GPU DDP behavior with A extra shards.
    _C.TRAIN.ACCUM_STEPS = 1

    # -- Validation (:24-27) ------------------------------------------------
    _C.VAL = ConfigNode()
    _C.VAL.METRIC = "global"  # or 'local_batch'
    _C.VAL.BATCH_SIZE = 80
    _C.VAL.LOG_INTERVAL = 5

    # -- Test (:32) ----------------------------------------------------------
    _C.TEST = ConfigNode()

    # -- Model (:40-43) --------------------------------------------------------
    _C.MODEL = ConfigNode()
    _C.MODEL.ARCH = "slowfast"  # {3dresnet, slowfast, info_nce, uber_nce, s3d, r3d}
    _C.MODEL.PREDICT_TEMPORAL_DS = False

    # -- Dataset (:48-70) -----------------------------------------------------
    _C.DATASET = ConfigNode()
    _C.DATASET.VID_PATH = ""
    _C.DATASET.ANNOTATION_PATH = ""
    _C.DATASET.CLUSTER_PATH = ""
    _C.DATASET.TARGET_TYPE_T = "label"  # [label, cluster_label]
    _C.DATASET.TARGET_TYPE_V = "label"
    _C.DATASET.SAMPLING_STRATEGY = "random_semi_hard"
    _C.DATASET.POSITIVE_SAMPLING_P = 0.8
    _C.DATASET.CHANNEL_EXTENSIONS = ""
    _C.DATASET.KEYPOINT_PATH = ""
    _C.DATASET.SALIENT_PATH = ""
    _C.DATASET.OPTICAL_U_PATH = ""
    _C.DATASET.OPTICAL_V_PATH = ""
    _C.DATASET.MODALITY = False
    _C.DATASET.POS_CHANNEL_REPLACE = False
    _C.DATASET.PROB_POS_CHANNEL_REPLACE = 0.25
    _C.DATASET.RECONSTRUCTION = False

    # -- SlowFast (:76-79); pyslowfast sub-config keys folded in here ---------
    # (reference keeps a second vendored CfgNode tree merged from
    # SLOWFAST.CFG_PATH — models/slowfast/slowfast/config/defaults.py; the
    # keys the models actually consume are promoted to first-class keys).
    _C.SLOWFAST = ConfigNode()
    _C.SLOWFAST.CFG_PATH = ""
    _C.SLOWFAST.ALPHA = 4
    _C.SLOWFAST.FAST_MASK = False
    _C.SLOWFAST.BETA_INV = 8
    _C.SLOWFAST.FUSION_CONV_CHANNEL_RATIO = 2
    _C.SLOWFAST.FUSION_KERNEL_SZ = 7
    _C.SLOWFAST.DEPTH = 50
    _C.SLOWFAST.NUM_FRAMES = 32
    _C.SLOWFAST.CROP_SIZE = 224
    _C.SLOWFAST.PROJECTION_HEAD = True
    _C.SLOWFAST.OUT_DIM = 128
    _C.SLOWFAST.NUM_CLASSES = 400
    _C.SLOWFAST.DROPOUT_RATE = 0.5
    # 2D->3D temporal inflation of --pretrain_path conv kernels (reference
    # pyslowfast TRAIN.CHECKPOINT_INFLATE + inflate_weight,
    # slowfast/utils/checkpoint.py:139-175); Caffe2 .pkl checkpoints are
    # detected by extension and need no knob
    _C.SLOWFAST.CHECKPOINT_INFLATE = False

    # -- 3D ResNet (:85-97) -----------------------------------------------------
    _C.RESNET = ConfigNode()
    _C.RESNET.MODEL_DEPTH = 18
    _C.RESNET.N_CLASSES = 101
    _C.RESNET.PROJECTION_HEAD = True
    _C.RESNET.HIDDEN_LAYER = 2048
    _C.RESNET.OUT_DIM = 128
    _C.RESNET.SHORTCUT = "B"
    _C.RESNET.CONV1_T_SIZE = 7
    _C.RESNET.CONV1_T_STRIDE = 1
    _C.RESNET.NO_MAX_POOl = True  # sic — key name kept for YAML compatibility
    _C.RESNET.WIDEN_FACTOR = 1
    _C.RESNET.ATTENTION = False

    # -- Data (:102-114) -----------------------------------------------------------
    _C.DATA = ConfigNode()
    _C.DATA.SAMPLE_SIZE = 224
    _C.DATA.SAMPLE_DURATION = 8
    _C.DATA.INPUT_CHANNEL_NUM = 3
    _C.DATA.TEMPORAL_CROP = "center"  # ['center', 'random', 'avg']

    # -- Loss (:119-140) --------------------------------------------------------------
    _C.LOSS = ConfigNode()
    _C.LOSS.TYPE = "triplet"
    _C.LOSS.MARGIN = 0.2
    _C.LOSS.DIST_METRIC = "cosine"  # or 'euclidean'
    _C.LOSS.K = 1024  # num of negatives (NCE)
    _C.LOSS.T = 0.07  # temperature
    _C.LOSS.M = 0.5  # memory-bank momentum
    _C.LOSS.FEAT_DIM = 128
    _C.LOSS.MOCO = False  # contrastive uses the MemoryMoCo queue instead of
    # NCEAverage banks (the reference's intended module-level moco=True
    # branch, online_train.py:38,697 — its import is broken upstream)
    _C.LOSS.MEM_TRIPLET = False  # triplets vs a K-slot labeled FIFO bank
    _C.LOSS.MEM_TRIPLET_K = 40  # reference MemTripletLoss K (triplet_loss.py:17)
    _C.LOSS.RELATIVE_SPEED_PERCEPTION = False
    _C.LOSS.LOCAL_LOCAL_CONTRAST = False
    _C.LOSS.LOCAL_LOCAL_WEIGHT = 1.0
    _C.LOSS.LOCAL_LOCAL_MARGIN = 0.04
    _C.LOSS.INTRA_NEGATIVE = False
    # Replicate the reference's inverted intra-neg objective (its block is
    # a copy-paste of LOCAL_LOCAL_CONTRAST that pulls the shuffled clip
    # CLOSER, online_train.py:334-360) for bug-for-bug curve comparison;
    # default False = the intended objective (losses/combos.py).
    _C.LOSS.INTRA_NEG_REFERENCE_COMPAT = False

    # -- Optimizer (:145-150) --------------------------------------------------------------
    _C.OPTIM = ConfigNode()
    _C.OPTIM.OPTIMIZER = "sgd"
    _C.OPTIM.WD = 0.00001
    _C.OPTIM.LR = 0.01
    _C.OPTIM.MOMENTUM = 0.5
    _C.OPTIM.SCHEDULE = []

    # -- Iterative clustering (:155-163) -----------------------------------------------------
    _C.ITERCLUSTER = ConfigNode()
    _C.ITERCLUSTER.METHOD = "kmeans"
    _C.ITERCLUSTER.INTERVAL = 5
    _C.ITERCLUSTER.K = 1000
    _C.ITERCLUSTER.ADAPTIVEP = False
    _C.ITERCLUSTER.WARMUP_EPOCHS = 0
    _C.ITERCLUSTER.L2_NORMALIZE = True
    _C.ITERCLUSTER.FINCH_PARTITION = 0

    # -- Misc (:168-170) ------------------------------------------------------------------------
    _C.NUM_GPUS = 1  # kept for YAML compatibility; on TPU = number of chips
    _C.OUTPUT_PATH = "."
    _C.SYNC_BATCH_NORM = False

    # -- TPU-specific (new) ----------------------------------------------------------------------
    _C.TPU = ConfigNode()
    _C.TPU.MESH_SHAPE = []  # [] = 1-D data mesh over all visible devices
    _C.TPU.COMPUTE_DTYPE = "bfloat16"  # model compute dtype (params stay fp32)
    _C.TPU.DONATE_STATE = True
    _C.TPU.PREFETCH_DEPTH = 2  # host->HBM double buffering depth
    _C.TPU.STEM_S2D = False  # space-to-depth 3dresnet stem (1.3x stem MFU)
    # host-side RandomResizedCrop fused into the native JPEG decode (the
    # reference's own protocol, spatial_transforms.py:171-225): train clips
    # cross host->device at SAMPLE_SIZE instead of the 2x device-crop
    # buffer — 4x fewer transfer bytes and ~25% less host decode work;
    # the device augmentation then skips its crop+resize
    _C.TPU.HOST_RRC = False
    # a torch.profiler Chrome trace of the train epoch's steps 5-9 in
    # epoch 0 (every loss), with the port's spans (utils/profiling.py),
    # written to <PROFILE_DIR>/trace_steps5-9.json; "" = off
    _C.TPU.PROFILE_DIR = ""
    _C.TPU.REMAT = False  # checkpoint residual blocks (big-batch training)
    # restrict remat to specific 1-based stages, e.g. "1" (stage-1 holds
    # the ~2 GB activations at 256-clip steps); "" = all stages
    _C.TPU.REMAT_STAGES = ""
    # approx_min_k in the retrieval top-k (bank-scale evals: 8.5x at a
    # 240k-row bank, measured recall 0.998 at the 0.99 target — PERF.md
    # round 4). Off by default: retrieval metrics are parity numbers.
    _C.TPU.APPROX_TOPK = False
    # producer-side device_put: the prefetch thread uploads each batch's
    # clip arrays to HBM (forced transfer) so host->device copy overlaps
    # the next batch's decode instead of serializing inside the consumer's
    # first execute (single-process runs only; the torch pin_memory/worker
    # overlap of reference data_loader.py:300-342)
    _C.TPU.PREFETCH_DEVICE_PUT = False

    return _C


_DEFAULT = _build_default_cfg()


def get_cfg() -> ConfigNode:
    """Return a fresh copy of the default config (ref default_params.py:186-190)."""
    return _DEFAULT.clone()
