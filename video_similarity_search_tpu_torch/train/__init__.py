from .checkpoint import (flax_linear_classifier_to_torch, flax_r3d_to_torch,
                         flax_resnet3d_to_torch, flax_s3d_to_torch,
                         load_bank_state, load_checkpoint, load_encoder_state,
                         load_torch_checkpoint, merge_pretrained,
                         resolve_checkpoint, restore_train_state,
                         save_checkpoint)
from .state import (LRSchedule, freeze_mask, make_classify_optimizer,
                    make_lr_schedule, make_optimizer)
from .steps import (make_banks, make_classify_train_step,
                    make_contrastive_train_step, make_embed_step,
                    make_triplet_loss_fn, make_triplet_train_step)

# ``driver`` (iterative_cluster_step, train) is imported from its module:
# it depends on ``evaluation``, which itself imports ``train.steps``.
__all__ = ["LRSchedule", "flax_linear_classifier_to_torch",
           "flax_r3d_to_torch", "flax_resnet3d_to_torch", "flax_s3d_to_torch",
           "freeze_mask", "load_bank_state", "load_checkpoint",
           "load_encoder_state", "load_torch_checkpoint", "make_banks",
           "make_classify_optimizer", "make_classify_train_step",
           "make_contrastive_train_step", "make_embed_step",
           "make_lr_schedule",
           "make_optimizer", "make_triplet_loss_fn", "make_triplet_train_step",
           "merge_pretrained", "resolve_checkpoint", "restore_train_state",
           "save_checkpoint"]
