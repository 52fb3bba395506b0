from .mesh import (Mesh, create_mesh, initialize_distributed, pad_window_set,
                   shard_opt_state_zero2, sync_params, window_parallel_step)

__all__ = ["Mesh", "create_mesh", "initialize_distributed", "pad_window_set",
           "shard_opt_state_zero2", "sync_params", "window_parallel_step"]
