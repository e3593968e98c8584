from nanomod.accum.pools import PositionPools, PoolBuilder, join_pools  # noqa: F401
