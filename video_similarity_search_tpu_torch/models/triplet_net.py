"""Triplet wrapper: shared-encoder 3-tower forward (port of the JAX
package's ``models/triplet_net.py``; reference models/triplet_net.py:6-34).

The (anchor, positive, negative) clips are stacked on the batch axis and
the encoder runs once on 3B clips, so BatchNorm in train mode sees all
three views together, as in the JAX module. The training steps call the
encoder directly; this wrapper keeps the reference's module surface.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from ..losses.triplet import pairwise_dist

__all__ = ["TripletNet", "pairwise_dist"]


class TripletNet(nn.Module):
    """Returns (dist_a, dist_b, e_x, e_y, e_z) like the reference forward;
    train or eval mode is the module's own (``.train()`` / ``.eval()``)."""

    def __init__(self, encoder: nn.Module, dist_metric: str = "cosine"):
        super().__init__()
        if dist_metric not in ("cosine", "euclidean"):
            raise ValueError(f"dist_metric {dist_metric!r}: cosine or "
                             "euclidean")
        self.encoder = encoder
        self.dist_metric = dist_metric

    def forward(self, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor
                ) -> Tuple[torch.Tensor, ...]:
        b = x.shape[0]
        emb = self.encoder(torch.cat([x, y, z], dim=0))
        if isinstance(emb, tuple):
            emb = emb[0]
        e_x, e_y, e_z = emb[:b], emb[b:2 * b], emb[2 * b:]
        return (pairwise_dist(e_x, e_y, self.dist_metric),
                pairwise_dist(e_x, e_z, self.dist_metric), e_x, e_y, e_z)
