"""Sharded serving over ``torch.distributed``: the gather-form rules and
the collectives they need."""
from .collectives import all_gather_cat, broadcast_from
from .rules import (ServeShardFn, block_index, head_layout, local_caches,
                    local_cfg, mesh_coord, mesh_sizes, model_cuts,
                    serve_batch_sharding, serve_cache_shardings,
                    serve_param_shardings, shard_params)

__all__ = ["ServeShardFn", "all_gather_cat", "block_index",
           "broadcast_from", "head_layout", "local_caches", "local_cfg",
           "mesh_coord", "mesh_sizes", "model_cuts", "serve_batch_sharding",
           "serve_cache_shardings", "serve_param_shardings", "shard_params"]
