from nanomod.parallel.mesh import (  # noqa: F401
    make_mesh,
    distributed_detect_step,
    shard_pools_over_positions,
)
