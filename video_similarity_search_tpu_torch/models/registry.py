"""Model registry: cfg -> torch module (port of the JAX package's
``models/registry.py``): ``3dresnet``, ``slowfast`` (with the SLOWFAST.*
sub-config), ``s3d``, ``r3d``, and the MoCo query encoder for
``info_nce`` / ``uber_nce``."""

from __future__ import annotations

from typing import Optional

import torch

from .heads import R3DEmbedder, S3DEmbedder
from .moco import MoCoEncoder
from .resnet3d import generate_model
from .slowfast import SlowFast

ARCHES = ("3dresnet", "slowfast", "info_nce", "uber_nce", "s3d", "r3d")

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float32": torch.float32, "fp32": torch.float32}


def parse_remat_stages(spec) -> Optional[tuple]:
    """``TPU.REMAT_STAGES`` '1' / '1,2' -> (1, 2); '' or None -> None (all
    stages when ``TPU.REMAT``), as the JAX registry parses it."""
    if not spec:
        return None
    if isinstance(spec, (list, tuple)):
        return tuple(int(s) for s in spec)
    return tuple(int(s) for s in str(spec).split(","))


def compute_dtype(cfg) -> torch.dtype:
    """``TPU.COMPUTE_DTYPE`` -> the autocast dtype used on the card."""
    name = str(cfg.TPU.COMPUTE_DTYPE).lower() if "TPU" in cfg else "float32"
    return _DTYPES.get(name, torch.float32)


def embedding_dim(cfg) -> int:
    """Output embedding dim of the arch's projection head."""
    arch = cfg.MODEL.ARCH
    if arch == "3dresnet":
        return cfg.RESNET.OUT_DIM
    if arch == "slowfast":
        return cfg.SLOWFAST.OUT_DIM
    return 128  # s3d / r3d / info_nce / uber_nce embedders


def model_selector(cfg, projection_head: bool = True, classifier: bool = False,
                   dropout: Optional[float] = None,
                   num_classes: int = 101) -> torch.nn.Module:
    """Build the encoder named by ``cfg.MODEL.ARCH`` on the CPU; the caller
    moves it with ``.to(device)``. SlowFast takes the [slow, fast] list
    of ``slowfast.multipathway_input``, which the steps build."""
    arch = cfg.MODEL.ARCH
    assert arch in ARCHES, f"unknown arch {arch!r}"
    if arch == "s3d":
        return S3DEmbedder(dim=128)
    if arch == "r3d":
        return R3DEmbedder(dim=128)
    if arch in ("info_nce", "uber_nce"):
        # the query encoder; the key encoder and queue are the "moco" bank
        return MoCoEncoder(network="s3d", dim=128)
    if arch == "slowfast":
        sf = cfg.SLOWFAST
        n_ch = cfg.DATA.INPUT_CHANNEL_NUM
        if sf.FAST_MASK:
            assert n_ch == 4, "FAST_MASK expects a 4th mask channel"
        return SlowFast(
            depth=sf.DEPTH, alpha=sf.ALPHA, beta_inv=sf.BETA_INV,
            fusion_conv_channel_ratio=sf.FUSION_CONV_CHANNEL_RATIO,
            fusion_kernel_sz=sf.FUSION_KERNEL_SZ,
            input_channels=(3, 3) if sf.FAST_MASK else (n_ch, n_ch),
            projection_head=projection_head and not classifier,
            projection2_out=sf.OUT_DIM, classifier=classifier,
            num_classes=num_classes if classifier else sf.NUM_CLASSES,
            dropout_rate=sf.DROPOUT_RATE if dropout is None else dropout)
    return generate_model(
        model_depth=cfg.RESNET.MODEL_DEPTH,
        hidden_layer=cfg.RESNET.HIDDEN_LAYER,
        out_dim=cfg.RESNET.OUT_DIM,
        num_classes=num_classes,
        n_input_channels=cfg.DATA.INPUT_CHANNEL_NUM,
        shortcut_type=cfg.RESNET.SHORTCUT,
        conv1_t_size=cfg.RESNET.CONV1_T_SIZE,
        conv1_t_stride=cfg.RESNET.CONV1_T_STRIDE,
        no_max_pool=cfg.RESNET.NO_MAX_POOl,
        widen_factor=cfg.RESNET.WIDEN_FACTOR,
        projection_head=projection_head,
        predict_temporal_ds=cfg.MODEL.PREDICT_TEMPORAL_DS,
        attention=cfg.RESNET.ATTENTION,
        classifier=classifier,
        dropout=dropout,
        stem_s2d=bool(cfg.TPU.STEM_S2D) if "TPU" in cfg else False,
        remat=bool(cfg.TPU.REMAT) if "TPU" in cfg else False,
        remat_stages=parse_remat_stages(
            cfg.TPU.REMAT_STAGES) if "TPU" in cfg else None,
    )
