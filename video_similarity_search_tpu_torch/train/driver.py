"""Pretrain driver pieces (port of the JAX package's ``train/driver.py``).

Ported so far: ``iterative_cluster_step``, the pseudo-labelling step of
SLIC's iterative-cluster pretrain (reference online_train.py:599-667).
The triplet epochs wait for the training slice (ROADMAP.md, queue 1).
After the step, the caller rebuilds the triplet loader from the returned
labels: ``build_data_loader("train", cfg, triplets=True,
cluster_labels=labels)``.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from ..cluster import fit_cluster
from ..data import write_cluster_labels
from ..evaluation import get_embeddings_and_labels
from ..utils.cluster_metrics import (adjusted_mutual_info,
                                     normalized_mutual_info)
from ..utils.device import resolve_device
from ..utils.meters import append_metric_line


def iterative_cluster_step(model, cfg, eval_train_loader,
                           is_master: bool = True, sink=None,
                           epoch: int = 0,
                           device="cuda") -> Optional[np.ndarray]:
    """Embed train set -> cluster -> NMI/AMI logs -> vid_clusters.txt
    (reference online_train.py:599-667). Returns labels in dataset order.

    ``ITERCLUSTER.ADAPTIVEP`` sets ``DATASET.POSITIVE_SAMPLING_P`` to
    1 - NMI. NMI and AMI are computed without scikit-learn
    (``utils/cluster_metrics.py``)."""
    dev = resolve_device(device)
    t0 = time.time()
    emb, true_labels, indices = get_embeddings_and_labels(
        model, cfg, eval_train_loader, split="train", verbose=is_master,
        device=dev)
    if is_master:
        print(f"embedding pass: {time.time() - t0:.1f}s")

    t0 = time.time()
    labels = fit_cluster(emb, method=cfg.ITERCLUSTER.METHOD,
                         k=cfg.ITERCLUSTER.K,
                         l2normalize=cfg.ITERCLUSTER.L2_NORMALIZE,
                         finch_partition=cfg.ITERCLUSTER.FINCH_PARTITION,
                         verbose=is_master, device=dev)
    if is_master:
        print(f"clustering: {time.time() - t0:.1f}s")

    # restore dataset order (loader iterates unshuffled, but be safe)
    order = np.argsort(indices)
    labels = labels[order]
    true = true_labels[order]

    nmi = normalized_mutual_info(true, labels)
    ami = adjusted_mutual_info(true, labels)
    if is_master:
        print(f"NMI: {nmi:.4f} AMI: {ami:.4f}")
        append_metric_line(cfg.OUTPUT_PATH, "NMIs.txt", f"{nmi:.6f}")
        append_metric_line(cfg.OUTPUT_PATH, "AMIs.txt", f"{ami:.6f}")
        if sink:
            sink.add_scalar("cluster/nmi", nmi, epoch)
            sink.add_scalar("cluster/ami", ami, epoch)
        cluster_file = os.path.join(cfg.OUTPUT_PATH, "vid_clusters.txt")
        write_cluster_labels(cluster_file, labels)

    if cfg.ITERCLUSTER.ADAPTIVEP:
        # adaptive positive sampling p = 1 - NMI (reference :645-646)
        cfg.DATASET.POSITIVE_SAMPLING_P = float(1.0 - nmi)
    return labels
