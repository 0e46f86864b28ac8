from .checkpoint import (flax_resnet3d_to_torch, load_checkpoint,
                         load_encoder_state, load_torch_checkpoint,
                         resolve_checkpoint, restore_train_state,
                         save_checkpoint)
from .state import LRSchedule, make_optimizer
from .steps import make_embed_step, make_triplet_loss_fn, make_triplet_train_step

# ``driver`` (iterative_cluster_step, train) is imported from its module:
# it depends on ``evaluation``, which itself imports ``train.steps``.
__all__ = ["LRSchedule", "flax_resnet3d_to_torch", "load_checkpoint",
           "load_encoder_state", "load_torch_checkpoint", "make_embed_step",
           "make_optimizer", "make_triplet_loss_fn", "make_triplet_train_step",
           "resolve_checkpoint", "restore_train_state", "save_checkpoint"]
