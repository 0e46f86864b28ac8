"""Device selection shared by every entry point of the port."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """-> ``torch.device``; a CUDA device on a machine without CUDA raises.

    Nothing in the port drops to the CPU on its own: a caller that wants
    the CPU (the parity tests) says ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU")
    return dev
