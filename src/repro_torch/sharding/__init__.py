"""Sharded serving and training over ``torch.distributed``: the gather-form
rules, the training rules of the reference, the collectives they need,
ZeRO data parallelism and the GPipe pipeline."""
from .collectives import all_gather_cat, broadcast_from
from .pipeline import make_pipelined_forward, pipeline_apply
from .rules import (ServeShardFn, TrainShardFn, batch_shardings,
                    block_index, cache_shardings, grad_shardings,
                    head_layout, local_caches, local_cfg, make_shard_fn,
                    mesh_coord, mesh_sizes, model_cuts, opt_state_shardings,
                    param_shardings, serve_batch_sharding,
                    serve_cache_shardings, serve_param_shardings,
                    shard_params, train_seam_spec, train_state_shardings)

__all__ = ["ServeShardFn", "TrainShardFn", "all_gather_cat",
           "batch_shardings", "block_index", "broadcast_from",
           "cache_shardings", "grad_shardings", "head_layout",
           "local_caches", "local_cfg", "make_pipelined_forward",
           "make_shard_fn", "mesh_coord", "mesh_sizes", "model_cuts",
           "opt_state_shardings", "param_shardings", "pipeline_apply",
           "serve_batch_sharding", "serve_cache_shardings",
           "serve_param_shardings", "shard_params", "train_seam_spec",
           "train_state_shardings"]
