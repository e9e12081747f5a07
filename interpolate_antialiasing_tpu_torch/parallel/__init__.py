from .sharding import make_mesh, shard_batch, data_parallel_resize
from .halo import (
    halo_resize_h,
    plan_halo,
    plan_halo_banded,
    resize_sharded,
    resize_sharded_pil_exact,
)
from .dryrun import dryrun_multichip

__all__ = [
    "make_mesh",
    "shard_batch",
    "data_parallel_resize",
    "halo_resize_h",
    "plan_halo",
    "plan_halo_banded",
    "resize_sharded",
    "resize_sharded_pil_exact",
    "dryrun_multichip",
]
