"""Multi-device scaling of the particle filter over torch.distributed
(parallel/sharding.py)."""

from top_down_renderer_torch.parallel.sharding import (
    make_mesh,
    make_sharded_step,
    make_sharded_step_fast,
    make_sharded_step_multi,
    shard_filter_state,
)

__all__ = [
    "make_mesh",
    "make_sharded_step",
    "make_sharded_step_fast",
    "make_sharded_step_multi",
    "shard_filter_state",
]
