from .checkpoint import (flax_resnet3d_to_torch, load_encoder_state,
                         load_torch_checkpoint)
from .steps import make_embed_step

# ``driver`` (iterative_cluster_step) is imported from its module: it
# depends on ``evaluation``, which itself imports ``train.steps``.
__all__ = ["flax_resnet3d_to_torch", "load_encoder_state",
           "load_torch_checkpoint", "make_embed_step"]
