"""Segment ops: group means and counts over cluster labels (port of the
JAX package's ``ops/segment.py``) with ``index_add_``. On the card the
sums use atomics, so their float order varies from run to run."""

from __future__ import annotations

import torch


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Per-segment mean of rows: (N, D) x (N,) -> (num_segments, D)."""
    data = data.float()
    ids = segment_ids.long()
    sums = torch.zeros(num_segments, data.shape[1], device=data.device)
    sums.index_add_(0, ids, data)
    counts = torch.zeros(num_segments, device=data.device)
    counts.index_add_(0, ids, torch.ones(ids.shape[0], device=data.device))
    return sums / counts.clamp_min(1.0)[:, None]


def segment_count(segment_ids: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    ids = segment_ids.long()
    return torch.zeros(num_segments, dtype=torch.int64,
                       device=ids.device).index_add_(
        0, ids, torch.ones_like(ids))
