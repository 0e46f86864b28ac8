"""Optimizer and learning-rate schedule (port of the JAX package's
``train/state.py::make_optimizer``; reference online_train.py:539-548).

The port's training state is the model (an ``nn.Module``, whose buffers
hold the BatchNorm statistics), a ``torch.optim.Optimizer`` and an
``LRSchedule``; there is no TrainState pytree.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

import torch


class LRSchedule:
    """``optax.piecewise_constant_schedule(LR, {b: 0.1 for b in
    boundaries})`` on a torch optimizer: the update whose 0-based count is
    ``k`` runs at ``LR * 0.1 ** #{b <= k}``. Call ``step()`` after each
    ``optimizer.step()``; with no boundaries the rate stays LR."""

    def __init__(self, optimizer: torch.optim.Optimizer, base_lr: float,
                 boundaries: Sequence[int] = ()):
        self.optimizer = optimizer
        self.base_lr = float(base_lr)
        self.boundaries = tuple(int(b) for b in boundaries)
        self.count = 0
        self._apply()

    def lr(self) -> float:
        return self.base_lr * 0.1 ** sum(self.count >= b
                                         for b in self.boundaries)

    def _apply(self) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr()

    def step(self) -> None:
        self.count += 1
        self._apply()

    def state_dict(self) -> dict:
        return {"count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self._apply()


def make_optimizer(cfg, params: Iterable[torch.nn.Parameter],
                   steps_per_epoch: Optional[int] = None
                   ) -> Tuple[torch.optim.Optimizer, LRSchedule]:
    """-> (optimizer, schedule), as the JAX package builds its optax chain:

    * ``sgd``: ``SGD(lr, momentum, nesterov=False)`` and no weight decay —
      the JAX SGD ignores ``OPTIM.WD`` (buf = momentum * buf + grad,
      update = lr * buf, torch's and optax's form alike);
    * ``adam``: ``add_decayed_weights(WD)`` then ``adam``, which is torch
      ``Adam(weight_decay=WD)`` (decay coupled into the gradient, eps 1e-8).

    ``OPTIM.SCHEDULE`` milestones (epochs) become step boundaries
    ``m * steps_per_epoch``, each dropping the rate by 10x, when
    ``steps_per_epoch`` is known (the reference defines the key but never
    reads it)."""
    lr = float(cfg.OPTIM.LR)
    milestones = list(cfg.OPTIM.SCHEDULE or [])
    boundaries = ([m * steps_per_epoch for m in milestones]
                  if milestones and steps_per_epoch else [])
    name = cfg.OPTIM.OPTIMIZER.lower()
    if name == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=float(cfg.OPTIM.WD))
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=lr,
                              momentum=float(cfg.OPTIM.MOMENTUM),
                              nesterov=False, weight_decay=0.0)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    return opt, LRSchedule(opt, lr, boundaries)
