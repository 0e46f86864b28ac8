"""Eval-mode embedding forward (port of the JAX package's
``train/steps.py::make_embed_step``). The training steps wait for the
training slice (ROADMAP.md, queue 1)."""

from __future__ import annotations

from typing import Callable

import torch

from ..models.registry import compute_dtype
from ..utils.device import resolve_device


def make_embed_step(cfg, model: torch.nn.Module,
                    device="cuda") -> Callable[[torch.Tensor], torch.Tensor]:
    """-> ``step(clips)``: normalized float (B,T,H,W,C) clips on ``device``
    -> float32 (B, D) embeddings, eval mode, under ``inference_mode``.
    Moves ``model`` to ``device``.

    On CUDA the forward runs under ``torch.autocast`` in
    ``TPU.COMPUTE_DTYPE`` (bfloat16 by default, as the JAX package computes
    in bf16 with f32 params), the weights take ``channels_last_3d`` (the
    permuted (B,T,H,W,C) input already has it, so cuDNN gets its NDHWC
    kernels without a copy), and TF32 is switched off for both cuDNN and
    cuBLAS: a float32 compute dtype then means IEEE float32, as in the JAX
    reference, and bf16 work is unaffected (ROADMAP hazard H3)."""
    if cfg.MODEL.ARCH != "3dresnet":
        raise NotImplementedError(
            f"embed step for {cfg.MODEL.ARCH!r}: not ported yet "
            "(ROADMAP.md, queue 1)")
    dev = resolve_device(device)
    model.to(dev).eval()
    dtype = torch.float32
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        model.to(memory_format=torch.channels_last_3d)
        dtype = compute_dtype(cfg)
    use_amp = dtype != torch.float32

    def step(clips: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), torch.autocast(
                dev.type, dtype=dtype, enabled=use_amp):
            out = model(clips)
        return out.float()

    return step
