from .checkpoint import flax_resnet3d_to_torch
from .steps import make_embed_step

__all__ = ["flax_resnet3d_to_torch", "make_embed_step"]
