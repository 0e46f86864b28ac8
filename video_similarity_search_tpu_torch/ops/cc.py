"""Connected components of the first-neighbor graph (port of the JAX
package's ``ops/cc.py``).

Min-label propagation over the undirected edge set {i - nn(i)}: the
forward edge, the reverse edges through ``scatter_reduce(..., "amin")``
(JAX ``segment_min``), and pointer jumping. The JAX ``lax.while_loop``
becomes a host loop that stops when a sweep changes nothing: O(log N)
sweeps, one device-to-host sync each.
"""

from __future__ import annotations

from typing import Tuple

import torch


def connected_components(nn_idx: torch.Tensor) -> torch.Tensor:
    """Labels (N,) int64: component id = min vertex id in the component."""
    nn_idx = nn_idx.long()
    n = nn_idx.shape[0]
    labels = torch.arange(n, device=nn_idx.device)
    big = torch.iinfo(torch.int64).max
    while True:
        fwd = labels[nn_idx]  # follow edge i -> nn(i)
        rev = torch.full_like(labels, big).scatter_reduce(
            0, nn_idx, labels, "amin")  # edges j -> i with nn(j) = i
        rev = torch.where(rev == big, labels, rev)
        new = torch.minimum(labels, torch.minimum(fwd, rev))
        new = torch.minimum(new, new[new])  # pointer jumping
        if torch.equal(new, labels):
            return labels
        labels = new


def compact_labels(labels: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Map arbitrary non-negative component ids to [0, C) in sorted order;
    returns (dense_labels, C)."""
    uniq, dense = torch.unique(labels, sorted=True, return_inverse=True)
    return dense, uniq.numel()
