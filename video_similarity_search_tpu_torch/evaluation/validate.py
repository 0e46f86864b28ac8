"""Validation: triplet accuracy and retrieval top-1/5 (port of the JAX
package's ``evaluation/validate.py``; reference validation.py:12-151).

The 3-tower eval forward runs on (anchor, positive, negative) validation
batches stacked into one forward; ``d(a,n) > d(a,p) + margin`` counts as a
correct triplet. Then a 'global' retrieval over all anchor embeddings or a
'local_batch' one per batch, and a line appended to
``val_loss_and_acc.txt``.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data.augment import normalize_only
from ..losses import pairwise_dist
from ..train.steps import make_embed_step
from ..utils.device import resolve_device
from ..utils.meters import AverageMeter, append_metric_line
from .retrieval import local_batch_retrieval_acc, topk_retrieval_acc


def make_validate_step(cfg, model: torch.nn.Module,
                       device="cuda") -> Callable:
    """-> ``step(anchor, positive, negative)`` on normalized clips ->
    (per-sample losses, per-sample correct, anchor embeddings float32).
    Per-sample values let the caller drop a padded tail."""
    margin = cfg.LOSS.MARGIN
    metric = cfg.LOSS.DIST_METRIC
    embed = make_embed_step(cfg, model, device=device)

    def step(anchor, positive, negative):
        b = anchor.shape[0]
        out = embed(torch.cat([anchor, positive, negative], 0))
        e_a, e_p, e_n = out[:b], out[b:2 * b], out[2 * b:]
        dist_a = pairwise_dist(e_a, e_p, metric)
        dist_b = pairwise_dist(e_a, e_n, metric)
        losses = F.relu(dist_a - dist_b + margin)
        correct = dist_b > dist_a + margin
        return losses, correct, e_a

    return step


def validate(model: torch.nn.Module, cfg, val_loader, epoch: int = 0,
             is_master_proc: bool = True,
             device="cuda") -> Tuple[float, Dict[int, float]]:
    """-> (triplet accuracy, {k: retrieval acc}). Writes
    ``val_loss_and_acc.txt`` like the reference (validation.py:148-149)."""
    dev = resolve_device(device)
    step = make_validate_step(cfg, model, device=dev)
    losses = AverageMeter("loss")
    n_correct, n_total = 0, 0
    embs, labels = [], []
    dataset = cfg.TRAIN.DATASET

    for batch in val_loader:
        views = [normalize_only(torch.as_tensor(batch[k]).to(dev),
                                dataset=dataset)
                 for k in ("anchor", "positive", "negative")]
        per_loss, per_correct, e_a = step(*views)
        b = int(batch.get("__size__", views[0].shape[0]))  # real (unpadded)
        losses.update(float(per_loss[:b].mean()), b)
        n_correct += int(per_correct[:b].sum())
        n_total += b
        embs.append(e_a[:b].cpu().numpy())
        labels.append(np.asarray(batch["targets"][:b]))

    acc = n_correct / max(n_total, 1)
    if cfg.VAL.METRIC == "local_batch":
        metrics = [local_batch_retrieval_acc(e, lb, device=dev)
                   for e, lb in zip(embs, labels)]
        topk = {k: (float(np.mean([m[k] for m in metrics])) if metrics
                    else 0.0) for k in (1, 5)}
    else:  # 'global': all embeddings as both query and bank
        emb = np.concatenate(embs) if embs else np.zeros((0, 1), np.float32)
        lab = np.concatenate(labels) if labels else np.zeros((0,), np.int64)
        topk = topk_retrieval_acc(emb, lab, emb, lab, ks=(1, 5),
                                  exclude_self=True, device=dev) \
            if len(emb) else {1: 0.0, 5: 0.0}

    if is_master_proc:
        print(f"Val epoch {epoch}: loss {losses.avg:.4f} "
              f"triplet_acc {acc:.4f} top1 {topk[1]:.4f} top5 {topk[5]:.4f}")
        append_metric_line(
            cfg.OUTPUT_PATH, "val_loss_and_acc.txt",
            f"epoch:{epoch} {losses.avg:.4f} {acc:.4f} "
            f"{topk[1]:.4f} {topk[5]:.4f}")
    return acc, topk
