"""Train and eval steps (port of the JAX package's ``train/steps.py``):
the eval-mode embedding forward, the triplet step (reference
``triplet_train_epoch``, online_train.py:245-434; with ``LOSS.MEM_TRIPLET``
against a labelled bank), the contrastive NCE / MemoryMoCo step (reference
``contrastive_train_epoch``, :136-225), the MoCo InfoNCE / UberNCE step
(reference ``UberNCE_train_epoch``, :60-133) and the supervised
classification step (reference coclr_classify.py:395-458). For
``MODEL.ARCH slowfast`` every forward takes the [slow, fast] pathways of
``multipathway_input``, split on the device where the JAX steps split
them.

On CUDA they run the forward under ``torch.autocast`` in
``TPU.COMPUTE_DTYPE`` (bfloat16 by default, as the JAX package's registry
builds its models in bf16 with float32 parameters; the classification CLI
sets float32, as the JAX one runs), with ``channels_last_3d`` weights,
and with TF32 off for cuDNN and cuBLAS: a float32 compute dtype then
means IEEE float32, as in the JAX reference, and bf16 work is unaffected
(ROADMAP hazard H3). Losses are taken in float32 outside autocast.

With a process group up (``parallel``) the pretrain steps take the JAX
package's global-batch semantics: each rank encodes its own rows, the
embeddings (with their gradient), targets and indices are gathered into
the global batch in global order, every rank computes the same global
loss and advances the same banks, the draws are made for the global batch
from a generator seeded alike on every rank, and the parameter gradients
are summed across ranks before the one optimizer step.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..losses import (INTRA_NEG_LAMBDA, RSP_LAMBDA, MemoryMoCo,
                      MemTripletLoss, NCEAverage, intra_neg_loss, llc_loss,
                      memory_moco_logits, nce_softmax_loss,
                      online_triplet_loss, rsp_loss)
from ..models.moco import (MoCoBank, infonce_forward, moco_losses,
                           query_network, ubernce_forward)
from ..models.registry import compute_dtype, embedding_dim
from ..models.slowfast import multipathway_input
from ..parallel import (gather_parts, gather_rows, get_rank, get_world_size,
                        sum_gradients)
from ..utils.device import resolve_device
from ..utils.profiling import span


# the train steps' spans (``utils/profiling.py::span``), in order: forward
# and loss, backward, optimizer (a profiler over the real step splits its
# device time by them)
RANGES = ("step.forward_loss", "step.backward", "step.optimizer")


def _prepare(cfg, model: torch.nn.Module, device) -> tuple:
    """Move ``model`` to ``device``; -> (device, ``autocast()``: a new
    ``torch.autocast`` context in the compute dtype, off in float32)."""
    dev = resolve_device(device)
    model.to(dev)
    dtype = torch.float32
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        model.to(memory_format=torch.channels_last_3d)
        dtype = compute_dtype(cfg)
    return dev, functools.partial(torch.autocast, dev.type, dtype=dtype,
                                  enabled=dtype != torch.float32)


def _nth(v, a: int, accum: int):
    """Microbatch ``a``'s share of a batch leaf or an injected draw: all of
    it at ``accum`` 1, else its row ``a``."""
    return v if accum == 1 or v is None else v[a]


def _optimizer_step(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer, schedule,
                    accum: int = 1) -> Callable:
    """The skeleton every train step shares -> ``run(forward_loss,
    after=None)``: train mode, the gradients cleared, then for each of the
    ``accum`` microbatches ``forward_loss(a)`` -> (loss, metrics) in
    ``step.forward_loss`` and the loss's backward in ``step.backward``;
    the gradients summed across ranks once, in the last microbatch's
    ``step.backward``, and divided by ``accum`` when it is above 1; then
    ``optimizer.step()``, ``schedule.step()`` and ``after(parts)`` in
    ``step.optimizer``. Returns the microbatches' metrics, ``parts``."""
    params = [p for p in model.parameters() if p.requires_grad]

    def run(forward_loss: Callable, after: Optional[Callable] = None
            ) -> list:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        parts = []
        for a in range(accum):
            with span(RANGES[0]):
                loss, metrics = forward_loss(a)
            with span(RANGES[1]):
                loss.backward()
                if a == accum - 1:
                    sum_gradients(params)
            parts.append(metrics)
        if accum > 1:
            with torch.no_grad():
                for p in params:
                    if p.grad is not None:
                        p.grad.div_(accum)
        with span(RANGES[2]):
            optimizer.step()
            schedule.step()
            if after is not None:
                after(parts)
        return parts

    return run


def model_input(cfg, clips: torch.Tensor):
    """What the model takes for (B, T, H, W, C) ``clips``: SlowFast's
    [slow, fast] pathways (``multipathway_input``), else the clips."""
    if cfg.MODEL.ARCH == "slowfast":
        return multipathway_input(clips, cfg.SLOWFAST.ALPHA,
                                  fast_mask=cfg.SLOWFAST.FAST_MASK)
    return clips


def _first(out):
    """A model's embedding: the first entry of a tuple output (the
    temporal-downsample head's ``(projection, ds_logits)``), as the JAX
    ``_encode`` keeps it."""
    return out[0] if isinstance(out, tuple) else out


def make_banks(cfg, n_data: int, model: Optional[torch.nn.Module] = None
               ) -> Dict[str, torch.nn.Module]:
    """The loss-side banks that ``cfg`` trains with, on the CPU (the JAX
    driver's ``_make_step_and_state``): ``mem_triplet`` for
    ``LOSS.MEM_TRIPLET``; for ``LOSS.TYPE contrastive`` the ``memory_moco``
    queue with ``LOSS.MOCO`` (and no intra-negative), else the ``nce``
    per-sample banks over the ``n_data`` training videos; for ``UberNCE``
    the ``moco`` bank: a copy of ``model``'s query network as the key
    encoder and a queue of ``LOSS.K`` x ``LOSS.FEAT_DIM`` (with labels for
    ``MODEL.ARCH uber_nce``)."""
    loss = cfg.LOSS
    if loss.TYPE == "UberNCE":
        if model is None:
            raise ValueError("LOSS.TYPE UberNCE: make_banks needs the model "
                             "(its key encoder is a copy of it)")
        return {"moco": MoCoBank(query_network(model), K=loss.K,
                                 dim=loss.FEAT_DIM,
                                 with_labels=cfg.MODEL.ARCH == "uber_nce")}
    if loss.TYPE == "triplet" and loss.MEM_TRIPLET:
        return {"mem_triplet": MemTripletLoss(K=loss.MEM_TRIPLET_K,
                                              dim=embedding_dim(cfg))}
    if loss.TYPE != "contrastive":
        return {}
    if loss.MOCO and not loss.INTRA_NEGATIVE:
        return {"memory_moco": MemoryMoCo(loss.K, loss.FEAT_DIM, T=loss.T,
                                          use_softmax=True)}
    return {"nce": NCEAverage(n_data, loss.FEAT_DIM, K=loss.K, T=loss.T,
                              momentum=loss.M, use_softmax=True,
                              intra_neg=bool(loss.INTRA_NEGATIVE))}


def make_embed_step(cfg, model: torch.nn.Module,
                    device="cuda") -> Callable[[torch.Tensor], torch.Tensor]:
    """-> ``step(clips)``: normalized float (B,T,H,W,C) clips on ``device``
    -> float32 (B, D) embeddings, eval mode, under ``inference_mode``.
    Moves ``model`` to ``device`` and puts it in eval mode. A model that
    returns a tuple gives its first entry (a classifier's logits), as the
    JAX step does; SlowFast gets its pathways (``model_input``)."""
    _, autocast = _prepare(cfg, model, device)
    model.eval()

    def step(clips: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), autocast():
            out = model(model_input(cfg, clips))
        return _first(out).float()

    return step


def _topk_accuracy(logits: torch.Tensor, target: torch.Tensor,
                   ks: Sequence[int] = (1, 5)) -> List[torch.Tensor]:
    """The share of rows whose target is among the k highest logits, for
    each k (reference coclr_utils calc_topk_accuracy; k clamped to the
    class count, as the JAX ``_topk_accuracy``). Rows with tied logits
    may order them otherwise than ``lax.top_k``."""
    kmax = min(max(ks), logits.shape[-1])
    pred = logits.topk(kmax, dim=-1).indices
    correct = pred == target[:, None]
    return [correct[:, :min(k, kmax)].any(dim=1).float().mean() for k in ks]


def make_classify_train_step(cfg, model: torch.nn.Module,
                             optimizer: torch.optim.Optimizer, schedule,
                             device="cuda") -> Callable:
    """Supervised cross-entropy step for the finetune / linear probe (the
    JAX ``make_classify_train_step``; reference coclr_classify.py:395-458):
    ``step(batch, generator=None, dropout_keep=None)`` with ``batch``
    {``clips`` normalized (B, T, H, W, C), ``label`` (B,)} runs the whole
    model in train mode (a frozen backbone's BatchNorm statistics move, as
    JAX applies ``train=True`` to it too), the forward under autocast, the
    cross-entropy in float32, backward, ``optimizer.step()`` and
    ``schedule.step()``; -> ``loss``, ``top1``, ``top5`` as device
    tensors. The dropout mask is drawn from ``generator`` or given as
    ``dropout_keep``. Weight decay and ``--train_what`` freezing live in
    the optimizer (``train/state.py::make_classify_optimizer``)."""
    _, autocast = _prepare(cfg, model, device)
    run = _optimizer_step(model, optimizer, schedule)

    def step(batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             dropout_keep: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        def forward_loss(_):
            with autocast():
                out = model(batch["clips"], dropout_keep=dropout_keep,
                            generator=generator)
            logits = _first(out).float()
            labels = batch["label"].long()
            loss = F.cross_entropy(logits, labels)
            return loss, (loss.detach(), logits.detach(), labels)

        [(loss, logits, labels)] = run(forward_loss)
        t1, t5 = _topk_accuracy(logits, labels)
        return {"loss": loss, "top1": t1, "top5": t5}

    return step


def make_triplet_loss_fn(cfg, model: torch.nn.Module, device="cuda",
                         bank: Optional[MemTripletLoss] = None) -> Callable:
    """The triplet step's loss body (the JAX ``make_triplet_loss_fn``):
    ``loss_fn(batch, noise=None, generator=None)`` -> (loss, aux) with aux
    ``triplet_loss``, ``aux_loss``, ``n_triplets`` and ``negatives`` (the
    miner's picks). With ``LOSS.MEM_TRIPLET`` the triplets are mined
    against ``bank`` (``losses/mem_triplet.py``), which each call advances,
    and ``negatives`` are queue slots.

    ``batch``: normalized ``anchor``, ``positive`` and, when a
    relative-speed, local-local or intra-negative loss is on, ``extra``
    clips (B, T, H, W, C), and ``targets`` (2B,) [anchor labels; positive
    labels]. The views go through ONE train-mode forward over
    ``cat([anchor, positive, extra])``, so BatchNorm sees all 3B clips, as
    the reference's TripletNet does. ``noise`` / ``generator``: the
    miner's draws (``losses/triplet.py``). With a process group up the
    batch holds this rank's rows: the embeddings and targets are gathered
    into the global [anchors; positives; extras] and [anchor labels;
    positive labels] first, and the loss, the picks and the draws are the
    global batch's."""
    use_mem = bool(cfg.LOSS.MEM_TRIPLET)
    if use_mem and bank is None:
        raise ValueError("LOSS.MEM_TRIPLET trains against a bank: pass "
                         "make_banks(cfg, n)['mem_triplet']")
    dev, autocast = _prepare(cfg, model, device)
    if use_mem:
        bank.to(dev)
    margin = cfg.LOSS.MARGIN
    metric = cfg.LOSS.DIST_METRIC
    strategy = cfg.DATASET.SAMPLING_STRATEGY
    use_rsp = cfg.LOSS.RELATIVE_SPEED_PERCEPTION
    use_llc = cfg.LOSS.LOCAL_LOCAL_CONTRAST
    use_intra = cfg.LOSS.INTRA_NEGATIVE
    intra_compat = bool(cfg.LOSS.INTRA_NEG_REFERENCE_COMPAT)
    llc_margin = cfg.LOSS.LOCAL_LOCAL_MARGIN
    llc_weight = cfg.LOSS.LOCAL_LOCAL_WEIGHT

    def loss_fn(batch: Dict[str, torch.Tensor],
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        clips = [batch["anchor"], batch["positive"]]
        if use_rsp or use_llc or use_intra:
            clips.append(batch["extra"])
        with autocast():
            emb = _first(model(model_input(cfg, torch.cat(clips, 0))))
        emb = gather_parts(emb.float(), len(clips))
        targets = gather_parts(batch["targets"], 2)
        b = emb.shape[0] // len(clips)
        mine = bank if use_mem else online_triplet_loss
        t_loss, n_triplets, negatives = mine(
            emb[:2 * b], targets, margin=margin, dist_metric=metric,
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
                            device="cuda",
                            bank: Optional[MemTripletLoss] = None
                            ) -> Callable:
    """Step for LOSS.TYPE='triplet' (the JAX ``make_triplet_train_step``):
    ``step(batch, generator=None, noise=None)`` runs forward, loss,
    backward, ``optimizer.step()`` and ``schedule.step()`` and returns the
    metrics ``loss``, ``triplet_loss``, ``aux_loss``, ``n_triplets`` and
    ``negatives`` as device tensors, so the host does not wait on the card
    every step (the JAX driver's ``_drain``).

    ``TRAIN.ACCUM_STEPS = A > 1``: batch leaves arrive (A, b, ...) and the
    A microbatches run in sequence; their gradients are summed and divided
    by A, the optimizer steps once, BatchNorm statistics chain through the
    microbatches (each forward updates them in turn), as does the
    ``LOSS.MEM_TRIPLET`` bank, the loss metrics are the microbatch means
    and ``n_triplets`` their sum. ``noise`` is then a sequence of A
    per-microbatch draws. Mining and BatchNorm are microbatch-local, as in
    the JAX scan. With a process group up, global microbatch a is every
    rank's microbatch a, in rank order, and the summed gradient is the
    ranks' sum."""
    accum = max(1, int(cfg.TRAIN.ACCUM_STEPS))
    loss_fn = make_triplet_loss_fn(cfg, model, device, bank)
    run = _optimizer_step(model, optimizer, schedule, accum)

    def step(batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             noise=None) -> Dict[str, torch.Tensor]:
        def forward_loss(a):
            loss, aux = loss_fn({k: _nth(v, a, accum)
                                 for k, v in batch.items()},
                                _nth(noise, a, accum), generator)
            return loss, {"loss": loss.detach(), **aux}

        parts = run(forward_loss)
        metrics = parts[0]
        if accum > 1:
            metrics = {k: torch.stack([m[k] for m in parts]).mean()
                       for k in ("loss", "triplet_loss", "aux_loss")}
            metrics["n_triplets"] = torch.stack(
                [m["n_triplets"] for m in parts]).sum()
            metrics["negatives"] = (
                None if parts[0]["negatives"] is None else
                torch.stack([m["negatives"] for m in parts]))
        return {k: v.detach() if isinstance(v, torch.Tensor) else v
                for k, v in metrics.items()}

    return step


def diff_view(x: torch.Tensor) -> torch.Tensor:
    """The residual (``res``) view: the frame difference along T, moved to
    [0, 1] (reference online_train.py:228-230)."""
    return ((x - torch.roll(x, 1, dims=1)) + 1.0) / 2.0


def shuffle_view(x: torch.Tensor, perms: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 block_size: int = 2) -> torch.Tensor:
    """The intra-negative view: each clip's frames shuffled in blocks of
    ``block_size`` by its own permutation (reference
    datasets/temporal_transforms.py Shuffle, :233-246); trailing frames
    that fill no block keep their place. ``perms`` (B, T // block_size)
    gives the permutations of the global batch, or they are drawn from
    ``generator`` for it; with a process group up ``x`` holds this rank's
    rows and takes their permutations."""
    b, t = x.shape[0], x.shape[1]
    n_blocks = t // block_size
    rank, world = get_rank(), get_world_size()
    if perms is None:
        perms = torch.rand(b * world, n_blocks, generator=generator,
                           device=generator.device).argsort(dim=1)
    perms = perms[rank * b:(rank + 1) * b].to(x.device).long()
    idx = (perms[:, :, None] * block_size
           + torch.arange(block_size, device=x.device)).reshape(b, -1)
    if idx.shape[1] < t:
        tail = torch.arange(idx.shape[1], t, device=x.device)
        idx = torch.cat([idx, tail.expand(b, -1)], dim=1)
    return torch.take_along_dim(x, idx[:, :, None, None, None], dim=1)


def make_contrastive_train_step(cfg, model: torch.nn.Module,
                                optimizer: torch.optim.Optimizer, schedule,
                                bank: torch.nn.Module, modality: str = "rgb",
                                intra_neg: bool = False,
                                use_moco: bool = False,
                                device="cuda") -> Callable:
    """Step for LOSS.TYPE='contrastive' (the JAX
    ``make_contrastive_train_step``; reference contrastive_train_epoch,
    online_train.py:136-225): ``step(batch, generator=None, nce_idx=None,
    shuffle_perm=None)`` with ``batch`` {``view1``, ``view2`` (unused for
    ``modality='res'``, whose second view is ``diff_view(view1)``),
    ``index`` (B,)} -> metrics ``loss``, ``view1_loss``, ``view2_loss``,
    ``view1_prob``, ``view2_prob`` as device tensors.

    Each view goes through its own train-mode forward, so BatchNorm
    normalizes it by its own batch statistics and the running statistics
    take one update a view, in order (ROADMAP hazard H8: the JAX step
    vmaps the views and merges their statistics to exactly this). The
    views score against ``bank`` (``make_banks``): ``NCEAverage`` (with
    ``intra_neg`` a third, block-shuffled view of view1 into its third
    bank) or, with ``use_moco``, the ``MemoryMoCo`` queue: view1 queries
    with view2 keys advance it, and view2's logits score against the queue
    as it was before. Both losses are softmax cross-entropy. The draws are
    the NCE negatives ``nce_idx`` (B, K+1) and the shuffle permutations,
    injected or drawn from ``generator``; with ``TRAIN.ACCUM_STEPS`` A > 1
    the batch leaves are (A, b, ...), the injections sequences of A, and
    the bank and BatchNorm statistics chain through the microbatches.
    With a process group up each view's features and the indices are
    gathered into the global batch before they score and update the
    banks, and the draws are the global batch's."""
    dev, autocast = _prepare(cfg, model, device)
    bank.to(dev)
    accum = max(1, int(cfg.TRAIN.ACCUM_STEPS))
    temperature = cfg.LOSS.T
    run = _optimizer_step(model, optimizer, schedule, accum)
    names = ("loss", "view1_loss", "view2_loss", "view1_prob", "view2_prob")

    def encode(clips):
        with autocast():
            return _first(model(model_input(cfg, clips))).float()

    def loss_fn(batch, generator, nce_idx, perm):
        view1 = batch["view1"]
        views = [view1, diff_view(view1) if modality == "res"
                 else batch["view2"]]
        if intra_neg and not use_moco:
            views.append(shuffle_view(view1, perm, generator))
        feats = [gather_rows(encode(v)) for v in views]
        if use_moco:
            out2 = memory_moco_logits(bank.memory, feats[1], feats[0],
                                      T=temperature)
            out1 = bank(feats[0], feats[1])
        else:
            out1, out2 = bank(feats[0], feats[1],
                              gather_rows(batch["index"]),
                              neg=feats[2] if intra_neg else None,
                              idx=nce_idx, generator=generator)
        l1, l2 = nce_softmax_loss(out1), nce_softmax_loss(out2)
        return l1 + l2, (l1, l2, out1[:, 0].mean(), out2[:, 0].mean())

    def step(batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             nce_idx=None, shuffle_perm=None) -> Dict[str, torch.Tensor]:
        def forward_loss(a):
            loss, aux = loss_fn({k: _nth(v, a, accum)
                                 for k, v in batch.items()},
                                generator, _nth(nce_idx, a, accum),
                                _nth(shuffle_perm, a, accum))
            return loss, [v.detach() for v in (loss, *aux)]

        parts = [torch.stack(p) for p in run(forward_loss)]
        return dict(zip(names, torch.stack(parts).mean(0)))

    return step


MOCO_T, MOCO_M = 0.07, 0.999  # reference model_utils.py:122-125, infoNCE.py


def make_moco_train_step(cfg, model: torch.nn.Module,
                         optimizer: torch.optim.Optimizer, schedule,
                         bank: MoCoBank, uber: bool = False,
                         device="cuda") -> Callable:
    """Step for LOSS.TYPE='UberNCE', archs ``info_nce`` / ``uber_nce`` (the
    JAX ``make_moco_train_step``; reference UberNCE_train_epoch,
    online_train.py:60-133, and models/infoNCE.py): ``step(batch,
    generator=None)`` with ``batch`` {``x1``, ``x2`` two augmented views
    (B, T, H, W, C), ``label`` (B,)} -> metrics ``loss``, ``top1``,
    ``top5`` as device tensors.

    Queries of x1 from ``model`` (train mode, under autocast) and keys of
    x2 from the bank's key encoder (train mode on its batch's statistics,
    running statistics untouched: ROADMAP hazard H9) score against the
    queue at T 0.07 in float32: InfoNCE's loss is logsumexp minus the
    positive logit, UberNCE's (``uber``) the masked log-softmax mean over
    the positives. Then, in the JAX step's order: the optimizer step, the
    momentum update (m 0.999) of the key parameters from the *updated*
    query parameters, and the enqueue of the keys computed before the
    update, with their labels for UberNCE. (The reference's forward moves
    the key encoder before it computes the keys; the port matches JAX,
    ROADMAP Queue 3.) ``TRAIN.ACCUM_STEPS`` does not apply (the JAX
    driver runs UberNCE at 1). With a process group up the queries, keys
    and labels are gathered into the global batch (``infonce_forward``),
    so every rank scores, enqueues and updates alike."""
    dev, autocast = _prepare(cfg, model, device)
    bank.to(dev)
    if dev.type == "cuda":
        bank.to(memory_format=torch.channels_last_3d)
    query = query_network(model)
    run = _optimizer_step(model, optimizer, schedule)

    def step(batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        labels = gather_rows(batch["label"])

        def forward_loss(_):
            with autocast():
                if uber:
                    logits, mask, keys = ubernce_forward(
                        model, bank, batch["x1"], batch["x2"], labels,
                        T=MOCO_T)
                else:
                    logits, _, keys = infonce_forward(
                        model, bank, batch["x1"], batch["x2"], T=MOCO_T)
                    mask = None
            loss, top1, top5 = moco_losses(logits, mask)
            return loss, ({"loss": loss.detach(), "top1": top1,
                           "top5": top5}, keys)

        def momentum_and_enqueue(parts):
            bank.momentum_update(query, MOCO_M)
            bank.dequeue_and_enqueue(parts[0][1], labels if uber else None)

        [(metrics, _)] = run(forward_loss, momentum_and_enqueue)
        return metrics

    return step
