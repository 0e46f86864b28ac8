"""Model registry: cfg -> torch module (port of the JAX package's
``models/registry.py``; the ``3dresnet`` branch only)."""

from __future__ import annotations

from typing import Optional

import torch

from .resnet3d import ResNet3D, generate_model

ARCHES = ("3dresnet", "slowfast", "info_nce", "uber_nce", "s3d", "r3d")

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float32": torch.float32, "fp32": torch.float32}


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
                   num_classes: int = 101) -> ResNet3D:
    """Build the encoder named by ``cfg.MODEL.ARCH`` on the CPU; the caller
    moves it with ``.to(device)``."""
    arch = cfg.MODEL.ARCH
    assert arch in ARCHES, f"unknown arch {arch!r}"
    if arch != "3dresnet":
        raise NotImplementedError(
            f"arch {arch!r}: not ported yet (ROADMAP.md, queue 1)")
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
    )
