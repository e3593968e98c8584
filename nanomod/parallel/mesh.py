"""Multi-device sharding: genome-coordinate parallel detection.

The reference's only multi-node mechanism is SGE qsub fan-out with
filesystem merges (ref bin/scripts/mySimulate.py:344-457).  This
design instead shards the *genome-position axis* across a device mesh (the
system's analog of tensor parallelism) while read batches stream
data-parallel:

    mesh axes: ('data', 'pos')
      data — read batches; per-position accumulators are merged with
             jax.lax.psum across this axis
      pos  — genomic coordinates; pools [P, C] are sharded on P, the test
             battery is embarrassingly parallel over P, and the small
             per-position p-value vectors are all_gathered for the
             neighbor-combination stencil (halo window ≪ shard size)

`distributed_detect_step` is a SELF-CONTAINED jitted multi-chip step
(scatter-add accumulation + psum merge + rank/KS components + all_gather)
kept as the compile-check harness and the minimal readable model of the
sharding layout; the PRODUCTION multi-chip paths are
parallel/sharded.py (position-sharded battery + ppermute halo
combination, used by detect.detect_from_pools) and parallel/shardmerge.py
(multi-host all-to-all observation routing) — both byte-validated against
the single-device pipeline in tests/test_shardmerge.py and the driver
dry run.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nanomod.stats import kernels


def make_mesh(n_devices: Optional[int] = None, data: int = 0) -> Mesh:
    """Build a ('data', 'pos') mesh over the available devices.

    `data` = size of the data axis (0 = auto: 2 if divisible, else 1)."""
    devices = jax.devices()
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(
            f"--n_devices {n} but only {len(devices)} JAX device(s) "
            f"available ({jax.default_backend()}); for CPU testing set "
            "XLA_FLAGS=--xla_force_host_platform_device_count=N")
    devices = devices[:n]
    if data == 0:
        data = 2 if n % 2 == 0 and n > 1 else 1
    pos = n // data
    arr = np.array(devices[: data * pos]).reshape(data, pos)
    return Mesh(arr, ("data", "pos"))


def shard_pools_over_positions(mesh: Mesh, z: np.ndarray, lab: np.ndarray,
                               n1: np.ndarray, n2: np.ndarray):
    """Place battery inputs with the position axis sharded over the whole
    mesh ('data','pos') — stats are embarrassingly parallel over P."""
    spec2 = NamedSharding(mesh, P(("data", "pos"), None))
    spec1 = NamedSharding(mesh, P(("data", "pos")))
    return (jax.device_put(z, spec2), jax.device_put(lab, spec2),
            jax.device_put(n1, spec1), jax.device_put(n2, spec1))


@partial(jax.jit, static_argnames=("genome_len",))
def _accumulate(read_pos, read_val, read_ok, *, genome_len):
    """Dense scatter-add of event values into per-position (count, Σ, Σ²).

    read_pos [R, L] int32 genomic positions; read_val [R, L] f32;
    read_ok [R, L] bool.  Runs inside shard_map on each data shard.
    """
    pos = jnp.where(read_ok, read_pos, genome_len).ravel()
    val = jnp.where(read_ok, read_val, 0.0).ravel()
    cnt = jnp.zeros(genome_len + 1, jnp.float32).at[pos].add(1.0)
    s1 = jnp.zeros(genome_len + 1, jnp.float32).at[pos].add(val)
    s2 = jnp.zeros(genome_len + 1, jnp.float32).at[pos].add(val * val)
    return cnt[:-1], s1[:-1], s2[:-1]


def distributed_detect_step(mesh: Mesh, genome_len: int,
                            read_pos: np.ndarray, read_val: np.ndarray,
                            read_ok: np.ndarray,
                            z: np.ndarray, lab: np.ndarray,
                            n1: np.ndarray, n2: np.ndarray):
    """One full multi-chip detection step under jit:

      1. data-parallel scatter-add of read events into per-position moment
         accumulators, merged with psum over the 'data' axis
      2. position-sharded KS/MWU rank components over reservoir pools
      3. all_gather of the per-position D statistics (the only cross-shard
         coupling downstream is the ±k combination stencil)

    Returns (counts [G], sums [G], d [P], trs [P], ties [P]).
    """
    n_data = mesh.shape["data"]
    n_pos = mesh.shape["pos"]

    def step(rp, rv, ro, z_l, lab_l, n1_l, n2_l):
        # (1) accumulate locally, merge over 'data'
        cnt, s1, s2 = _accumulate(rp, rv, ro, genome_len=genome_len)
        cnt = jax.lax.psum(cnt, "data")
        s1 = jax.lax.psum(s1, "data")
        s2 = jax.lax.psum(s2, "data")
        # (2) pos-sharded battery components
        d, trs, ties = kernels.pooled_rank_components(z_l, lab_l, n1_l, n2_l)
        # (3) gather the small per-position stats across the mesh
        d_all = jax.lax.all_gather(d, "pos", tiled=True)
        d_all = jax.lax.all_gather(d_all, "data", tiled=True)
        return cnt, s1, s2, d_all, trs, ties

    specs = dict(
        in_specs=(P("data"), P("data"), P("data"),
                  P(("data", "pos")), P(("data", "pos")),
                  P(("data", "pos")), P(("data", "pos"))),
        out_specs=(P(), P(), P(),
                   P(), P(("data", "pos")), P(("data", "pos"))),
    )
    smapped = jax.shard_map(step, mesh=mesh, check_vma=False, **specs)
    return jax.jit(smapped)(read_pos, read_val, read_ok, z, lab, n1, n2)
