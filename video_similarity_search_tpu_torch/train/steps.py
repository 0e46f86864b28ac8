"""Train and eval steps (port of the JAX package's ``train/steps.py``):
the eval-mode embedding forward and the triplet step (reference
``triplet_train_epoch``, online_train.py:245-434).

On CUDA both run the forward under ``torch.autocast`` in
``TPU.COMPUTE_DTYPE`` (bfloat16 by default, as the JAX package computes in
bf16 with float32 parameters), with ``channels_last_3d`` weights, and with
TF32 off for cuDNN and cuBLAS: a float32 compute dtype then means IEEE
float32, as in the JAX reference, and bf16 work is unaffected (ROADMAP
hazard H3). Losses are taken in float32 outside autocast.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..losses import (INTRA_NEG_LAMBDA, RSP_LAMBDA, intra_neg_loss, llc_loss,
                      online_triplet_loss, rsp_loss)
from ..models.registry import compute_dtype
from ..utils.device import resolve_device


def _prepare(cfg, model: torch.nn.Module, device) -> tuple:
    """Move ``model`` to ``device``; -> (device, autocast dtype)."""
    if cfg.MODEL.ARCH != "3dresnet":
        raise NotImplementedError(
            f"steps for {cfg.MODEL.ARCH!r}: not ported yet "
            "(ROADMAP.md, queue 1)")
    dev = resolve_device(device)
    model.to(dev)
    dtype = torch.float32
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        model.to(memory_format=torch.channels_last_3d)
        dtype = compute_dtype(cfg)
    return dev, dtype


def make_embed_step(cfg, model: torch.nn.Module,
                    device="cuda") -> Callable[[torch.Tensor], torch.Tensor]:
    """-> ``step(clips)``: normalized float (B,T,H,W,C) clips on ``device``
    -> float32 (B, D) embeddings, eval mode, under ``inference_mode``.
    Moves ``model`` to ``device`` and puts it in eval mode."""
    dev, dtype = _prepare(cfg, model, device)
    model.eval()
    use_amp = dtype != torch.float32

    def step(clips: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), torch.autocast(
                dev.type, dtype=dtype, enabled=use_amp):
            out = model(clips)
        return out.float()

    return step


def make_triplet_loss_fn(cfg, model: torch.nn.Module, device="cuda"
                         ) -> Callable:
    """The triplet step's loss body (the JAX ``make_triplet_loss_fn``):
    ``loss_fn(batch, noise=None, generator=None)`` -> (loss, aux) with aux
    ``triplet_loss``, ``aux_loss``, ``n_triplets`` and ``negatives`` (the
    miner's picks).

    ``batch``: normalized ``anchor``, ``positive`` and, when a
    relative-speed, local-local or intra-negative loss is on, ``extra``
    clips (B, T, H, W, C), and ``targets`` (2B,) [anchor labels; positive
    labels]. The views go through ONE train-mode forward over
    ``cat([anchor, positive, extra])``, so BatchNorm sees all 3B clips, as
    the reference's TripletNet does. ``noise`` / ``generator``: the
    miner's draws (``losses/triplet.py``)."""
    if cfg.LOSS.MEM_TRIPLET:
        raise NotImplementedError(
            "LOSS.MEM_TRIPLET: not ported yet (ROADMAP.md, queue 1, "
            "item 15: losses/mem_triplet.py)")
    dev, dtype = _prepare(cfg, model, device)
    use_amp = dtype != torch.float32
    margin = cfg.LOSS.MARGIN
    metric = cfg.LOSS.DIST_METRIC
    strategy = cfg.DATASET.SAMPLING_STRATEGY
    use_rsp = cfg.LOSS.RELATIVE_SPEED_PERCEPTION
    use_llc = cfg.LOSS.LOCAL_LOCAL_CONTRAST
    use_intra = cfg.LOSS.INTRA_NEGATIVE
    intra_compat = bool(getattr(cfg.LOSS, "INTRA_NEG_REFERENCE_COMPAT",
                                False))
    llc_margin = cfg.LOSS.LOCAL_LOCAL_MARGIN
    llc_weight = cfg.LOSS.LOCAL_LOCAL_WEIGHT

    def loss_fn(batch: Dict[str, torch.Tensor],
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        b = batch["anchor"].shape[0]
        clips = [batch["anchor"], batch["positive"]]
        if use_rsp or use_llc or use_intra:
            clips.append(batch["extra"])
        with torch.autocast(dev.type, dtype=dtype, enabled=use_amp):
            emb = model(torch.cat(clips, 0))
        emb = emb.float()
        t_loss, n_triplets, negatives = online_triplet_loss(
            emb[:2 * b], batch["targets"], margin=margin, dist_metric=metric,
            sampling_strategy=strategy, noise=noise, generator=generator)
        aux_loss = torch.zeros((), device=emb.device)
        if use_rsp:
            aux_loss = RSP_LAMBDA * rsp_loss(emb[:b], emb[b:2 * b],
                                             emb[2 * b:], metric)
        elif use_llc:
            aux_loss = llc_weight * llc_loss(emb[:b], emb[b:2 * b],
                                             emb[2 * b:], llc_margin, metric)
        elif use_intra:
            aux_loss = INTRA_NEG_LAMBDA * intra_neg_loss(
                emb[:b], emb[b:2 * b], emb[2 * b:], metric,
                reference_compat=intra_compat)
        return t_loss + aux_loss, {"triplet_loss": t_loss,
                                   "aux_loss": aux_loss,
                                   "n_triplets": n_triplets,
                                   "negatives": negatives}

    return loss_fn


def make_triplet_train_step(cfg, model: torch.nn.Module,
                            optimizer: torch.optim.Optimizer, schedule,
                            device="cuda") -> Callable:
    """Step for LOSS.TYPE='triplet' (the JAX ``make_triplet_train_step``):
    ``step(batch, generator=None, noise=None)`` runs forward, loss,
    backward, ``optimizer.step()`` and ``schedule.step()`` and returns the
    metrics ``loss``, ``triplet_loss``, ``aux_loss``, ``n_triplets`` and
    ``negatives`` as device tensors, so the host does not wait on the card
    every step (the JAX driver's ``_drain``).

    ``TRAIN.ACCUM_STEPS = A > 1``: batch leaves arrive (A, b, ...) and the
    A microbatches run in sequence; their gradients are summed and divided
    by A, the optimizer steps once, BatchNorm statistics chain through the
    microbatches (each forward updates them in turn), the loss metrics are
    the microbatch means and ``n_triplets`` their sum. ``noise`` is then a
    sequence of A per-microbatch draws. Mining and BatchNorm are
    microbatch-local, as in the JAX scan."""
    accum = max(1, int(cfg.TRAIN.ACCUM_STEPS))
    loss_fn = make_triplet_loss_fn(cfg, model, device)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             noise=None) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        if accum == 1:
            loss, aux = loss_fn(batch, noise, generator)
            loss.backward()
            metrics = {"loss": loss.detach(), **aux}
        else:
            parts = []
            for a in range(accum):
                mb = {k: v[a] for k, v in batch.items()}
                loss, aux = loss_fn(mb, None if noise is None else noise[a],
                                    generator)
                loss.backward()
                parts.append({"loss": loss.detach(), **aux})
            with torch.no_grad():
                for p in params:
                    if p.grad is not None:
                        p.grad.div_(accum)
            metrics = {k: torch.stack([m[k] for m in parts]).mean()
                       for k in ("loss", "triplet_loss", "aux_loss")}
            metrics["n_triplets"] = torch.stack(
                [m["n_triplets"] for m in parts]).sum()
            metrics["negatives"] = (
                None if parts[0]["negatives"] is None else
                torch.stack([m["negatives"] for m in parts]))
        optimizer.step()
        schedule.step()
        return {k: v.detach() if isinstance(v, torch.Tensor) else v
                for k, v in metrics.items()}

    return step
