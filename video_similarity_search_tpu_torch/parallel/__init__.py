"""Data-parallel training over torch.distributed (the counterpart of the
JAX package's ``parallel``)."""

from .dist import (DEFAULT_TIMEOUT, agree, all_reduce_sum, broadcast_module,
                   check_mesh_shape, destroy, free_port, gather_parts,
                   gather_rows, get_rank, get_world_size,
                   initialize_distributed, is_active, is_master_proc,
                   local_rank, maybe_auto_initialize, sum_gradients)

__all__ = ["DEFAULT_TIMEOUT", "agree", "all_reduce_sum", "broadcast_module",
           "check_mesh_shape", "destroy", "free_port", "gather_parts",
           "gather_rows", "get_rank", "get_world_size",
           "initialize_distributed", "is_active", "is_master_proc",
           "local_rank", "maybe_auto_initialize", "sum_gradients"]
