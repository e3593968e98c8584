"""Position-sharded multi-device detection — the production sharded path.

The reference's detect is a single-threaded Python loop over every genomic
position (ref bin/scripts/myDetect.py:416-438).  Here the position axis of
each (chrom, strand) join is sharded over the WHOLE ('data', 'pos') device
mesh (the genome-coordinate axis is this system's analog of tensor
parallelism, SURVEY.md §2.3):

  * the full test-battery components (KS D + MWU rank sums + exact Welch
    sums + the capped repeated-subsample KS) run row-parallel on each
    shard's position slice — zero communication, XLA partitions the
    row-independent pairwise-count kernels without collectives;
  * the ONLY cross-shard coupling in the whole detect flow is the ±k
    neighbor p-value combination stencil (ref myDetect.py:383): each shard
    ppermutes its k boundary rows of (D, n1_eff, n2_eff, position, valid)
    to its mesh neighbors — a fixed-size halo exchange — and the
    [2k+1, P] neighbor-component stencil is then assembled locally;
  * the cheap O(P) float64 p-value transforms run on host PER SHARD from
    each shard's addressable data (p-values underflow float32), through
    the exact same stats.battery/stats.special code
    as the single-device path — so the sharded run is BYTE-identical to
    the single-device run (tested in tests/test_parallel.py and by the
    driver's dryrun_multichip).

Capped-KS reproducibility across shardings is guaranteed by the
per-absolute-row fold_in RNG keying (stats/kernels.capped_ks_d).
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nanomod.config import StatConfig
from nanomod.stats import battery, kernels, special

_AXES = ("data", "pos")


@jax.jit
def _bitcast_i32(x):
    return jax.lax.bitcast_convert_type(x, jnp.int32)


@partial(jax.jit, static_argnames=("out_sharding", "milli"))
def _packed_sharded(v1, c1, v2, c2, *, out_sharding, milli):
    """Battery components with the [R, P] pack constrained to row-sharded
    placement so each host can fetch exactly its shards' slices."""
    if milli:
        out = kernels.battery_components_packed_milli(v1, c1, v2, c2)
    else:
        out = kernels.battery_components_packed(v1, c1, v2, c2)
    return jax.lax.with_sharding_constraint(out, out_sharding)


@lru_cache(maxsize=32)
def _stencil_fn(mesh: Mesh, k: int, cov: int):
    """Build the shard_map'd halo-exchange + neighbor-stencil step.

    Per shard (local position slice [L]):
      1. select the effective KS inputs per position: the capped-subsample D
         with effective sizes min(n, cov) where the per-strand cap applies
         (ref myDetect.py:339-361), the plain D with true sizes otherwise;
      2. ppermute the k boundary rows to the left/right neighbor shard over
         the linearized ('data','pos') axis (shards own contiguous position
         ranges, so mesh-linear neighbors are genome neighbors);
      3. assemble the [2k+1, L] stencil of (D, ne1, ne2, valid) — `valid`
         encodes pos_check (ref myDetect.py:366-371): same join, genomic
         distance == offset, not padding.  ppermute zero-fills the mesh
         edges, and valid=0 marks those slots missing (-> p 1.0 on host).
    """
    nsh = int(np.prod([mesh.shape[a] for a in _AXES]))

    def step(num, cap_num, n1c, n2c, pos, valid):
        """num/cap_num: exact i32 KS numerators (D = num / (ne1*ne2))."""
        L = num.shape[0]
        if cov > 0:
            need = (n1c > cov) | (n2c > cov)
            num_sel = jnp.where(need, cap_num, num)
            ne1 = jnp.where(need, jnp.minimum(n1c, cov), n1c)
            ne2 = jnp.where(need, jnp.minimum(n2c, cov), n2c)
        else:
            num_sel, ne1, ne2 = num, n1c, n2c

        # one all-int payload -> a single ppermute per direction
        pi = jnp.stack([num_sel, ne1, ne2, pos,
                        valid.astype(jnp.int32)])            # [5, L] i32
        if k > 0 and nsh > 1:
            right = [(i, i + 1) for i in range(nsh - 1)]
            left = [(i + 1, i) for i in range(nsh - 1)]
            from_left = jax.lax.ppermute(pi[:, -k:], _AXES, right)
            from_right = jax.lax.ppermute(pi[:, :k], _AXES, left)
            ext = jnp.concatenate([from_left, pi, from_right], axis=1)
        else:
            zi = jnp.zeros((5, k), pi.dtype)
            ext = jnp.concatenate([zi, pi, zi], axis=1)

        rows_d, rows_n1, rows_n2, rows_ok = [], [], [], []
        for off in range(-k, k + 1):
            si = jax.lax.dynamic_slice_in_dim(ext, k + off, L, axis=1)
            if off == 0:
                ok = valid
            else:
                ok = (si[4] > 0) & valid & (si[3] - pos == off)
            rows_d.append(si[0])
            rows_n1.append(si[1])
            rows_n2.append(si[2])
            rows_ok.append(ok)
        return (jnp.stack(rows_d), jnp.stack(rows_n1),
                jnp.stack(rows_n2), jnp.stack(rows_ok))

    spec1 = P(_AXES)
    return jax.jit(jax.shard_map(
        step, mesh=mesh,
        in_specs=(spec1,) * 6,
        out_specs=(P(None, _AXES),) * 4,
        check_vma=False,
    ))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def sharded_join_battery(
    mesh: Mesh,
    values1: np.ndarray, counts1: np.ndarray,
    values2: np.ndarray, counts2: np.ndarray,
    positions: np.ndarray,
    strand: str = "+",
    cfg: StatConfig = StatConfig(),
    want_mstd: bool = False,
    combine: bool = True,
    row_offset: int = 0,
) -> battery.TestResult:
    """Full battery + neighbor combination for ONE (chrom, strand) join,
    position-sharded over `mesh`.

    Drop-in replacement for stats.battery.run_battery inside
    detect.detect_from_pools (plus the per-join combination, which is
    equivalent to the global one because the ±k stencil never crosses
    (chrom, strand) boundaries — pos_check invalidates such neighbors in
    both).  `combine=True` fills res.stcomb/res.pcomb when the config
    calls for a combination column.
    """
    p_total = len(counts1)
    battery._check_i32_bounds(counts1, counts2)
    nsh = int(np.prod([mesh.shape[a] for a in _AXES]))
    shard_len = _round_up(max(_round_up(p_total, nsh) // nsh, 8), 8)
    p_pad = shard_len * nsh

    c1 = battery._capacity_bucket(int(counts1.max(initial=1)))
    c2 = battery._capacity_bucket(int(counts2.max(initial=1)))
    v1, cn1 = battery._tile_slice(values1, counts1, 0, p_total, c1, p_pad)
    v2, cn2 = battery._tile_slice(values2, counts2, 0, p_total, c2, p_pad)
    is_milli = v1.dtype == np.int16 and v2.dtype == np.int16
    n1 = counts1.astype(np.int32)
    n2 = counts2.astype(np.int32)

    row = NamedSharding(mesh, P(_AXES))
    row2 = NamedSharding(mesh, P(_AXES, None))
    packed_spec = NamedSharding(mesh, P(None, _AXES))

    v1d = jax.device_put(v1, row2)
    cn1d = jax.device_put(np.maximum(cn1, 1), row)
    v2d = jax.device_put(v2, row2)
    cn2d = jax.device_put(np.maximum(cn2, 1), row)

    packed = _packed_sharded(v1d, cn1d, v2d, cn2d,
                             out_sharding=packed_spec, milli=is_milli)

    cov = int(cfg.coverages[0 if strand == "+" else 1])
    cap_dev = None
    if cov > 0 and bool(((n1 > cov) | (n2 > cov)).any()):
        q_idx = int(cfg.downsampling * cfg.downsampling_quantile)
        # absolute row index within the join keys the subsample RNG —
        # identical draws to the single-device tiling (kernels.capped_ks_d);
        # row_offset shifts it when this call holds a mid-join row range
        # (multi-host sharded merge, parallel/shardmerge.py)
        rowd = jax.device_put(
            np.arange(row_offset, row_offset + p_pad, dtype=np.int32), row)
        cap_dev = kernels.capped_ks_d(
            v1d, cn1d, v2d, cn2d, rowd,
            cov=cov, repeats=cfg.downsampling, quantile_idx=q_idx,
            seed=cfg.downsampling_seed)

    want_comb = combine and cfg.test_method != "ks" and cfg.neighbor_pvalues > 0
    nb = None
    if want_comb:
        pos_pad = np.full(p_pad, -(2 ** 30), dtype=np.int32)
        if p_total:
            assert int(positions.max()) < 2 ** 31, "position overflows int32"
            pos_pad[:p_total] = positions.astype(np.int32)
        valid = np.zeros(p_pad, dtype=bool)
        valid[:p_total] = True
        capd = (cap_dev if cap_dev is not None
                else jax.device_put(np.zeros(p_pad, np.int32), row))
        fn = _stencil_fn(mesh, int(cfg.neighbor_pvalues), cov)
        num_dev = _bitcast_i32(packed[0])
        nb = fn(num_dev, capd, cn1d, cn2d,
                jax.device_put(pos_pad, row), jax.device_put(valid, row))

    # ---- host float64 finalization, PER SHARD (each host touches only its
    # addressable shard slices — the multi-host layout; in one process all
    # shards are addressable, covering the whole table) ----
    packed_np = np.empty((packed.shape[0], p_pad), np.float32)
    for sh in packed.addressable_shards:
        packed_np[sh.index] = np.asarray(sh.data)
    cap_np = None
    if cap_dev is not None:
        cap_np = np.empty(p_pad, np.int32)
        for sh in cap_dev.addressable_shards:
            cap_np[sh.index] = np.asarray(sh.data)

    out = {k: np.empty(p_total, np.float64)
           for k in ("stu", "pu", "stt", "pt", "stks", "pks")}
    mstd = np.empty((p_total, 4), np.float64) if want_mstd else None
    stcomb = np.empty(p_total, np.float64) if want_comb else None
    pcomb = np.empty(p_total, np.float64) if want_comb else None

    if want_comb:
        nb_np = [np.empty(a.shape, a.dtype) for a in nb]
        for arr_np, arr in zip(nb_np, nb):
            for sh in arr.addressable_shards:
                arr_np[sh.index] = np.asarray(sh.data)
        d_nb, ne1_nb, ne2_nb, ok_nb = nb_np

    w = (special.stouffer_weights(cfg.neighbor_pvalues, cfg.weights_dif)
         if want_comb and cfg.test_method == "stouffer" else None)

    for s in range(nsh):
        lo = s * shard_len
        hi = min(lo + shard_len, p_total)
        if hi <= lo:
            break
        n_rows = hi - lo
        cols = battery.finalize_packed(
            packed_np[:, lo:lo + shard_len], n_rows,
            n1[lo:hi], n2[lo:hi],
            None if cap_np is None else cap_np[lo:lo + shard_len],
            cov, is_milli, want_mstd)
        for key in ("stu", "pu", "stt", "pt", "stks", "pks"):
            out[key][lo:hi] = cols[key]
        if want_mstd:
            mstd[lo:hi] = cols["mstd"]
        if want_comb:
            # neighbor p-values from the halo-exchanged exact components,
            # through the same f64 transform as the center column
            # (bit-identical: D = integer numerator / (ne1*ne2) in f64)
            ne1m = ne1_nb[:, lo:hi].astype(np.float64)
            ne2m = ne2_nb[:, lo:hi].astype(np.float64)
            with np.errstate(divide="ignore", invalid="ignore"):
                dm = d_nb[:, lo:hi].astype(np.float64) / (ne1m * ne2m)
            p_nb = special.clamp_p(special.ks_pvalue(dm, ne1m, ne2m))
            mat = np.where(ok_nb[:, lo:hi], p_nb, 1.0).T   # [n_rows, 2k+1]
            if cfg.test_method == "fisher":
                st, pv = special.fisher_combine(mat, axis=1)
            else:
                st, pv = special.stouffer_combine(mat, w, axis=1)
            stcomb[lo:hi] = special.clamp_stat(st)
            pcomb[lo:hi] = special.clamp_p(pv)

    return battery.TestResult(**out, stcomb=stcomb, pcomb=pcomb, mstd=mstd)
