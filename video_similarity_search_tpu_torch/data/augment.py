"""Eval-path clip normalization (port of ``normalization_constants`` and
``normalize_only`` from the JAX package's ``data/augment.py``). The train
augmentation chain waits for the training slice (ROADMAP.md, queue 1)."""

from __future__ import annotations

from typing import Tuple

import torch

# reference datasets/data_loader.py:53-66
MEAN_STD = {
    "kinetics": ((0.4345, 0.4051, 0.3775), (0.2768, 0.2713, 0.2737)),
    "imagenet": ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
}


def normalization_constants(dataset: str, num_channels: int = 3,
                            device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean/std vectors; extension channels get mean 0 / std 1
    (reference get_normalize_method, datasets/data_loader.py:69-83)."""
    mean, std = MEAN_STD["kinetics" if dataset == "kinetics" else "imagenet"]
    extra = num_channels - 3
    mean = tuple(mean) + (0.0,) * extra
    std = tuple(std) + (1.0,) * extra
    return (torch.tensor(mean, dtype=torch.float32, device=device),
            torch.tensor(std, dtype=torch.float32, device=device))


def normalize_only(clips_u8: torch.Tensor,
                   dataset: str = "ucf101") -> torch.Tensor:
    """Eval path: uint8 (B,T,H,W,C) -> float32 scaled and normalized, on the
    clips' own device."""
    x = clips_u8.to(torch.float32) / 255.0
    mean, std = normalization_constants(dataset, clips_u8.shape[-1],
                                        device=clips_u8.device)
    return (x - mean) / std
