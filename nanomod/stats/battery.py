"""Per-position two-sample test battery, tiled over positions.

Replaces the reference's per-position Python loop over scipy calls
(ref bin/scripts/myDetect.py:416-438 `mtest2` inner loop / :327-363
`getKStest`).  Only the raw pools (values + counts) cross the host->device
link; masking, pooling and sorting happen on device
(stats/kernels.battery_components); the host applies float64 p-value
transforms (stats/special.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax.numpy as jnp

from nanomod.config import StatConfig
from nanomod.stats import kernels, special


@dataclass
class TestResult:
    """Per-position results, order-aligned with the caller's position list.

    Mirrors the reference's sign_test tuples
    ((chrom,strand,pos,base,cov1,cov2), [(stU,pU),(stT,pT),(stKS,pKS)[,(stC,pC)]])
    (ref myDetect.py:436) as dense arrays.
    """

    __test__ = False   # not a pytest class

    stu: np.ndarray
    pu: np.ndarray
    stt: np.ndarray
    pt: np.ndarray
    stks: np.ndarray
    pks: np.ndarray
    # filled by the caller via combine_neighbor_pvalues when applicable
    stcomb: np.ndarray | None = None
    pcomb: np.ndarray | None = None
    # optional per-group mean/std (--mstd, ref myDetect.py:437-438,540-544)
    mstd: np.ndarray | None = None

    def __len__(self):
        return len(self.stu)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _check_i32_bounds(counts1, counts2):
    """The exact integer device components (KS numerator max|k*n2 - m*n1|,
    tie sums) require n1*n2 < 2^31 and pooled width < ~1290 per position.
    Real per-position coverage is orders of magnitude below this; a
    pathological ultra-deep position must be capped, not silently wrong."""
    c1 = int(counts1.max(initial=0))
    c2 = int(counts2.max(initial=0))
    if c1 * c2 >= 2 ** 31 or (c1 + c2) > 1290:
        raise ValueError(
            f"per-position coverage too deep for exact int32 statistics "
            f"(max n1={c1}, n2={c2}); cap the pools with "
            f"--pool_capacity <= 645")


def _capacity_bucket(c: int) -> int:
    """Round a column capacity up to a power of two (min 8) so jit caches
    stay bounded."""
    c = max(c, 8)
    return 1 << (c - 1).bit_length()


def _tile_slice(values, counts, lo, hi, cap, p_tile):
    """[p_tile, cap] tile + [p_tile] i32 counts (content beyond counts is
    ignored by the device kernel).

    When every value in the tile is an exact multiple of 0.001 within int16
    range — the system-wide 3-decimal rounding invariant (ref
    myRefBaseSignalAnnotation.py:259) — the tile is encoded as int16 milli
    values (value*1000): an exact, order/tie-preserving HALF-size
    host-to-device format.  A tile that fails the
    exactness check (e.g. NaN padding, out-of-range values) ships as plain
    f32; the device kernel accepts either.  Doing the check per tile (not
    over the whole pool array up front) keeps it fused with the slice copy
    and overlapped with the async device dispatch of earlier tiles."""
    w = min(cap, values.shape[1])
    c = np.zeros(p_tile, dtype=np.int32)
    c[: hi - lo] = np.minimum(counts[lo:hi], cap)
    chunk = values[lo:hi, :w]
    if chunk.dtype != np.int16:
        with np.errstate(invalid="ignore"):
            scaled = chunk * np.float32(1000.0)
            r = np.rint(scaled)
            exact = bool(np.abs(scaled).max(initial=0.0) < 32767.0) and bool(
                (np.abs(scaled - r) < 0.01).all())
        if exact:
            chunk = r.astype(np.int16)
    if hi - lo == p_tile and w == cap:
        return np.ascontiguousarray(chunk), c
    v = np.zeros((p_tile, cap), dtype=chunk.dtype)
    v[: hi - lo, :w] = chunk
    return v, c


def finalize_exact_components(ks_num, two_rank_sum, tie_sum, n1, n2,
                              sum1, sumsq1, sum2, sumsq2,
                              cap_np, cov, want_mstd) -> dict:
    """Host float64 finalization from exact integer battery components.

    ks_num/two_rank_sum/tie_sum int32 [P]; sum*/sumsq* exact int64
    milli-domain Σx / Σx²; cap_np the capped-KS numerator (or None); n1/n2
    the TRUE counts.  Shared by the device milli path (finalize_packed),
    the position-sharded multi-chip path (parallel/sharded.py) and the
    native host backend (sort_core.cpp nm_battery_milli) — all three
    produce bit-identical statistics from identical integer components.
    Returns {stu, pu, stt, pt, stks, pks[, mstd]}.
    """
    n_rows = len(ks_num)
    out = {}
    n1f = n1.astype(np.float64)
    n2f = n2.astype(np.float64)

    # Mann-Whitney U (ref myDetect.py:331-333)
    u_min, zstat = kernels.mwu_from_components(two_rank_sum, tie_sum, n1, n2)
    out["stu"] = special.clamp_stat(u_min)
    out["pu"] = special.clamp_p(special.mwu_pvalue(zstat))

    # Welch t (ref myDetect.py:335-337) from exact integer Σ/Σx²
    t, df, (va1, va2), (m1, m2), (ssx1, ssx2) = \
        kernels.welch_finalize_exact(sum1, sumsq1, n1, sum2, sumsq2, n2)
    out["stt"] = special.clamp_stat(t)
    out["pt"] = special.clamp_p(special.welch_pvalue(t, df))
    if want_mstd:
        mstd = np.empty((n_rows, 4), dtype=np.float64)
        mstd[:, 0] = m1
        mstd[:, 2] = m2
        # population std straight from the exact decimal-domain sums
        mstd[:, 1] = np.sqrt(np.maximum(ssx1, 0.0) / np.maximum(n1f, 1))
        mstd[:, 3] = np.sqrt(np.maximum(ssx2, 0.0) / np.maximum(n2f, 1))
        out["mstd"] = mstd

    # KS, with optional capped repeated-subsample variant
    # (ref myDetect.py:339-361).  D = num/(n1*n2) in f64 is bit-identical
    # to an exact rational oracle (no f32 perturbation of formatted
    # p-values).
    d_plain = ks_num.astype(np.float64) / (n1f * n2f)
    if cov > 0:
        need_cap = (n1 > cov) | (n2 > cov)
    else:
        need_cap = np.zeros(n_rows, dtype=bool)
    if cap_np is not None and need_cap.any():
        ne1 = np.minimum(n1f, cov)
        ne2 = np.minimum(n2f, cov)
        with np.errstate(divide="ignore", invalid="ignore"):
            d_cap = cap_np.astype(np.float64) / (ne1 * ne2)
        d_sel = np.where(need_cap, d_cap, d_plain)
        p_ks = np.where(
            need_cap,
            special.ks_pvalue(d_cap, ne1, ne2),
            special.ks_pvalue(d_plain, n1f, n2f),
        )
    else:
        d_sel = d_plain
        p_ks = special.ks_pvalue(d_plain, n1f, n2f)
    out["stks"] = special.clamp_stat(d_sel)
    out["pks"] = special.clamp_p(p_ks)
    return out


def finalize_packed(packed: np.ndarray, n_rows: int, n1: np.ndarray,
                    n2: np.ndarray, cap_np: np.ndarray | None, cov: int,
                    is_milli: bool, want_mstd: bool) -> dict:
    """Host float64 finalization of one fetched packed-component block.

    packed [7|9, >=n_rows] from battery_components_packed[_milli]; cap_np
    the fetched capped-KS D (or None); n1/n2 the TRUE counts [n_rows].
    Shared by the single-device tile loop (run_battery) and the
    position-sharded multi-chip path (parallel/sharded.py) so both produce
    bit-identical statistics from identical device components.
    Returns {stu, pu, stt, pt, stks, pks[, mstd]}.
    """
    sl = slice(0, n_rows)
    i32 = lambda row: packed[row].view(np.int32)[sl]
    cap_sl = None if cap_np is None else cap_np[sl]
    if is_milli:
        sq1 = (i32(4).astype(np.int64) << 15) + i32(5)
        sq2 = (i32(7).astype(np.int64) << 15) + i32(8)
        return finalize_exact_components(
            i32(0), i32(1), i32(2), n1, n2,
            i32(3).astype(np.int64), sq1, i32(6).astype(np.int64), sq2,
            cap_sl, cov, want_mstd)

    # f32 tiles: two-pass f32 device moments with documented ~1e-6
    # relative tolerance on the Welch statistics
    out = {}
    two_rank_sum = i32(1)
    tie_sum = i32(2)
    n1f = n1.astype(np.float64)
    n2f = n2.astype(np.float64)
    u_min, zstat = kernels.mwu_from_components(two_rank_sum, tie_sum, n1, n2)
    out["stu"] = special.clamp_stat(u_min)
    out["pu"] = special.clamp_p(special.mwu_pvalue(zstat))
    m1, m2 = packed[3][sl], packed[5][sl]
    t, df, (va1, va2) = kernels.welch_finalize(
        m1, packed[4][sl], n1, m2, packed[6][sl], n2)
    out["stt"] = special.clamp_stat(t)
    out["pt"] = special.clamp_p(special.welch_pvalue(t, df))
    if want_mstd:
        mstd = np.empty((n_rows, 4), dtype=np.float64)
        mstd[:, 0] = m1
        mstd[:, 2] = m2
        mstd[:, 1] = np.sqrt(va1 * np.maximum(n1f - 1, 1) / np.maximum(n1f, 1))
        mstd[:, 3] = np.sqrt(va2 * np.maximum(n2f - 1, 1) / np.maximum(n2f, 1))
        out["mstd"] = mstd
    d_plain = i32(0).astype(np.float64) / (n1f * n2f)
    if cov > 0:
        need_cap = (n1 > cov) | (n2 > cov)
    else:
        need_cap = np.zeros(n_rows, dtype=bool)
    if cap_sl is not None and need_cap.any():
        ne1 = np.minimum(n1f, cov)
        ne2 = np.minimum(n2f, cov)
        d_cap = cap_sl.astype(np.float64) / (ne1 * ne2)
        d_sel = np.where(need_cap, d_cap, d_plain)
        p_ks = np.where(
            need_cap,
            special.ks_pvalue(d_cap, ne1, ne2),
            special.ks_pvalue(d_plain, n1f, n2f),
        )
    else:
        d_sel = d_plain
        p_ks = special.ks_pvalue(d_plain, n1f, n2f)
    out["stks"] = special.clamp_stat(d_sel)
    out["pks"] = special.clamp_p(p_ks)
    return out


BACKEND_ENV = "NANOMOD_BATTERY_BACKEND"


def battery_backend() -> str:
    """Where the exact integer battery components are computed.

    NANOMOD_BATTERY_BACKEND=device|host overrides; any other value is an
    error.  Otherwise: the device kernels when JAX's default backend is
    the GPU, the native host battery (sort_core.cpp nm_battery_milli) when
    it is the CPU.  On the CPU the O(N^2)-per-row pairwise-count kernel is
    a poor fit, and XLA-CPU recompiles per joined-position-count bucket;
    the native battery computes the same exact components at O(N log N)
    with no compiles."""
    import os

    env = os.environ.get(BACKEND_ENV, "")
    if env:
        if env not in ("device", "host"):
            raise ValueError(
                f"{BACKEND_ENV}={env!r}: expected 'device' or 'host'")
        return env
    import jax
    return "device" if jax.default_backend() == "gpu" else "host"


def _capped_ks_numerators(values1, counts1, values2, counts2, cov, cfg,
                          row_offset, tile_positions,
                          idx1=None, idx2=None) -> np.ndarray | None:
    """Capped-KS numerators for the rows exceeding the per-strand cap,
    scattered into a full-length int32 array (uncapped rows stay 0 and are
    never read by the finalizer).

    ALWAYS computed on device (kernels.capped_ks_d): the subsample RNG is
    jax.random keyed per absolute row, so host- and device-backend runs
    draw bit-identical subsamples (ref myDetect.py:345-361 semantics).
    Rows are gathered compactly so a lightly-capped genome ships only the
    deep positions to the device.
    """
    import jax.numpy as jnp

    idx = np.nonzero((counts1 > cov) | (counts2 > cov))[0]
    if len(idx) == 0:
        return None
    out = np.zeros(len(counts1), dtype=np.int32)
    q_idx = int(cfg.downsampling * cfg.downsampling_quantile)
    for lo in range(0, len(idx), tile_positions):
        rows = idx[lo: lo + tile_positions]
        p_tile = _round_up(len(rows), 8)
        g1 = values1[rows if idx1 is None else idx1[rows]]
        g2 = values2[rows if idx2 is None else idx2[rows]]
        n1 = np.zeros(p_tile, np.int32)
        n2 = np.zeros(p_tile, np.int32)
        n1[: len(rows)] = counts1[rows]
        n2[: len(rows)] = counts2[rows]
        v1 = np.zeros((p_tile, g1.shape[1]), g1.dtype)
        v2 = np.zeros((p_tile, g2.shape[1]), g2.dtype)
        v1[: len(rows)] = g1
        v2[: len(rows)] = g2
        row_index = np.zeros(p_tile, np.int32)
        row_index[: len(rows)] = row_offset + rows
        cap_dev = kernels.capped_ks_d(
            jnp.asarray(v1), jnp.asarray(np.maximum(n1, 1)),
            jnp.asarray(v2), jnp.asarray(np.maximum(n2, 1)),
            jnp.asarray(row_index),
            cov=cov, repeats=cfg.downsampling, quantile_idx=q_idx,
            seed=cfg.downsampling_seed)
        out[rows] = np.asarray(cap_dev)[: len(rows)]
    return out


def _run_battery_host(values1, counts1, values2, counts2, cov, cfg,
                      want_mstd, row_offset, tile_positions,
                      idx1=None, idx2=None):
    """Native host battery (sort_core.cpp nm_battery_milli): bit-identical
    exact integer components without shipping the pools to the device.
    idx1/idx2 gather battery row r from pool row idx*[r] inside the native
    call, so join callers (detect.join_pools) avoid materializing [P, C]
    fancy-index copies.  Returns a TestResult, or None when the native
    path cannot be used (values fail the milli invariant / lib
    unavailable)."""
    import ctypes
    import os

    from nanomod.native.build import load_native
    lib = load_native("sort_core")
    if lib is None or not hasattr(lib, "nm_battery_milli"):
        return None
    if values1.dtype == np.int16:
        is_i16 = 1
    elif values1.dtype == np.float32:
        is_i16 = 0
    else:
        return None
    if values2.dtype != values1.dtype:
        return None
    v1 = np.ascontiguousarray(values1)
    v2 = np.ascontiguousarray(values2)
    c1 = np.ascontiguousarray(counts1, dtype=np.int32)
    c2 = np.ascontiguousarray(counts2, dtype=np.int32)
    p = len(c1)
    ks = np.empty(p, np.int32)
    trs = np.empty(p, np.int32)
    ties = np.empty(p, np.int32)
    s1 = np.empty(p, np.int64)
    sq1 = np.empty(p, np.int64)
    s2 = np.empty(p, np.int64)
    sq2 = np.empty(p, np.int64)
    try:
        nthreads = len(os.sched_getaffinity(0))
    except AttributeError:
        nthreads = os.cpu_count() or 1
    vp = ctypes.c_void_p
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)

    def idx_arg(idx):
        if idx is None:
            return ctypes.cast(None, i64p)
        return np.ascontiguousarray(idx, np.int64).ctypes.data_as(i64p)

    ix1 = None if idx1 is None else np.ascontiguousarray(idx1, np.int64)
    ix2 = None if idx2 is None else np.ascontiguousarray(idx2, np.int64)
    rc = lib.nm_battery_milli(
        vp(v1.ctypes.data), c1.ctypes.data_as(i32p),
        ctypes.c_int64(v1.shape[1]),
        vp(v2.ctypes.data), c2.ctypes.data_as(i32p),
        ctypes.c_int64(v2.shape[1]),
        ctypes.c_int64(p), ctypes.c_int(is_i16),
        idx_arg(ix1), idx_arg(ix2),
        ks.ctypes.data_as(i32p), trs.ctypes.data_as(i32p),
        ties.ctypes.data_as(i32p),
        s1.ctypes.data_as(i64p), sq1.ctypes.data_as(i64p),
        s2.ctypes.data_as(i64p), sq2.ctypes.data_as(i64p),
        ctypes.c_int(nthreads))
    if rc != 0:
        return None
    cap_np = None
    if cov > 0:
        cap_np = _capped_ks_numerators(v1, c1, v2, c2, cov, cfg,
                                       row_offset, tile_positions,
                                       idx1=ix1, idx2=ix2)

    out = {k: np.empty(p, np.float64)
           for k in ("stu", "pu", "stt", "pt", "stks", "pks")}
    mstd = np.empty((p, 4), np.float64) if want_mstd else None

    def fin(lo, hi):
        sl = slice(lo, hi)
        cols = finalize_exact_components(
            ks[sl], trs[sl], ties[sl], c1[sl], c2[sl],
            s1[sl], sq1[sl], s2[sl], sq2[sl],
            None if cap_np is None else cap_np[sl], cov, want_mstd)
        for k in out:
            out[k][sl] = cols[k]
        if want_mstd:
            mstd[sl] = cols["mstd"]

    # rows are independent and the f64 p-transforms (scipy special ufuncs)
    # release the GIL: chunk across threads for large joins.  Bitwise
    # identical to the single pass (pure per-row math).
    if p > 200_000 and nthreads > 1:
        from concurrent.futures import ThreadPoolExecutor
        bounds = np.linspace(0, p, min(nthreads, 8) * 2 + 1, dtype=np.int64)
        with ThreadPoolExecutor(min(nthreads, 8)) as ex:
            list(ex.map(lambda i: fin(int(bounds[i]), int(bounds[i + 1])),
                        range(len(bounds) - 1)))
    else:
        fin(0, p)
    return TestResult(stu=out["stu"], pu=out["pu"], stt=out["stt"],
                      pt=out["pt"], stks=out["stks"], pks=out["pks"],
                      mstd=mstd)


def run_battery(
    values1: np.ndarray,
    counts1: np.ndarray,
    values2: np.ndarray,
    counts2: np.ndarray,
    strand: str = "+",
    cfg: StatConfig = StatConfig(),
    tile_positions: int = 8192,
    want_mstd: bool = False,
    row_offset: int = 0,
    backend: str | None = None,
    idx1: np.ndarray | None = None,
    idx2: np.ndarray | None = None,
) -> TestResult:
    """Run the full KS + MWU + Welch-t battery for P positions.

    values* are [P, C*] float32 pools with valid prefix lengths counts* [P]
    int32 (padding content is ignored).  `strand` selects the per-strand
    coverage cap (ref myDetect.py:339).  `row_offset` is added to the
    capped-KS subsample RNG's row index: a caller holding rows [off, off+P)
    of a larger join (the multi-host position-sharded merge,
    parallel/shardmerge.py) draws the same subsamples the whole-join run
    draws for those rows.

    `backend` picks where the exact integer components are computed:
    "device" (tiled XLA kernels), "host" (native sort_core.cpp), or
    None/"auto" (battery_backend(): the env override, else device on the
    GPU and host on the CPU).  Both backends
    produce bit-identical statistics; capped-KS subsampling always runs on
    device so the RNG stream is backend-invariant.

    `idx1`/`idx2` gather battery row r from pool row idx*[r] — join
    callers (detect.join_pools) pass their index arrays so the host
    backend reads the pools in place; the device path materializes the
    gathered copies up front (its tiler slices row-contiguously).
    """
    p_total = len(counts1)
    _check_i32_bounds(counts1, counts2)
    if backend in (None, "auto"):
        backend = battery_backend()
    if backend == "host":
        cov_h = int(cfg.coverages[0 if strand == "+" else 1])
        res = _run_battery_host(values1, counts1, values2, counts2, cov_h,
                                cfg, want_mstd, row_offset, tile_positions,
                                idx1=idx1, idx2=idx2)
        if res is not None:
            return res
    if idx1 is not None:
        values1 = values1[idx1]
    if idx2 is not None:
        values2 = values2[idx2]
    out = {
        k: np.empty(p_total, dtype=np.float64)
        for k in ("stu", "pu", "stt", "pt", "stks", "pks")
    }
    mstd = np.empty((p_total, 4), dtype=np.float64) if want_mstd else None
    cov = int(cfg.coverages[0 if strand == "+" else 1])

    # Pipelined tiles: encode (milli-int16 rounding + pad copy) on a small
    # thread pool — numpy ufuncs release the GIL so encoding tile i+1
    # overlaps the H2D of tile i — dispatch asynchronously (JAX dispatch is
    # async; fetching later pipelines H2D, compute and D2H), and finalize
    # in a BOUNDED
    # sliding window so at most `max_inflight` tiles of inputs+outputs are
    # resident on device at once (9.2M-position runs would otherwise park
    # every tile in HBM before the first fetch).
    ranges = [(lo, min(lo + tile_positions, p_total))
              for lo in range(0, p_total, tile_positions)]

    def encode(rg):
        """Encode one tile AND push it to the device — device_put from the
        worker threads lets tile transfers overlap each other and the
        dispatch of earlier tiles' kernels."""
        lo, hi = rg
        n1 = counts1[lo:hi].astype(np.int32)
        n2 = counts2[lo:hi].astype(np.int32)
        c1 = _capacity_bucket(int(n1.max(initial=1)))
        c2 = _capacity_bucket(int(n2.max(initial=1)))
        p_tile = _round_up(hi - lo, 8)
        v1, cn1 = _tile_slice(values1, counts1, lo, hi, c1, p_tile)
        v2, cn2 = _tile_slice(values2, counts2, lo, hi, c2, p_tile)
        return (lo, hi, n1, n2,
                jnp.asarray(v1), jnp.asarray(np.maximum(cn1, 1)),
                jnp.asarray(v2), jnp.asarray(np.maximum(cn2, 1)))

    def dispatch(enc):
        """Launch the packed kernel (+ optional capped-KS) for one encoded
        tile; returns the pending record for later finalization."""
        lo, hi, n1, n2, v1d, cn1d, v2d, cn2d = enc
        is_milli = v1d.dtype == jnp.int16 and v2d.dtype == jnp.int16
        if is_milli:
            comp_dev = kernels.battery_components_packed_milli(
                v1d, cn1d, v2d, cn2d)
        else:
            comp_dev = kernels.battery_components_packed(v1d, cn1d, v2d, cn2d)
        cap_dev = None
        if cov > 0 and bool(((n1 > cov) | (n2 > cov)).any()):
            q_idx = int(cfg.downsampling * cfg.downsampling_quantile)
            # row_index keys the subsample RNG per ABSOLUTE row so results
            # do not depend on tile_positions (or on position sharding)
            row_index = jnp.asarray(np.arange(
                row_offset + lo, row_offset + lo + len(cn1d),
                dtype=np.int32))
            cap_dev = kernels.capped_ks_d(
                v1d, cn1d, v2d, cn2d, row_index,
                cov=cov, repeats=cfg.downsampling, quantile_idx=q_idx,
                seed=cfg.downsampling_seed)
        # start the D2H copy now: it rides behind the kernel in the device
        # queue, so finalize()'s np.asarray finds the bytes already on host
        for dev in (comp_dev, cap_dev):
            try:
                if dev is not None:
                    dev.copy_to_host_async()
            except AttributeError:
                pass
        return (lo, hi, n1, n2, comp_dev, cap_dev, is_milli)

    def finalize(rec):
        """Fetch one tile (single packed D2H) + host float64 finalization."""
        lo, hi, n1, n2, comp_dev, cap_dev, is_milli = rec
        packed = np.asarray(comp_dev)   # ONE D2H fetch per tile
        cap_np = None if cap_dev is None else np.asarray(cap_dev)
        cols = finalize_packed(packed, hi - lo, n1, n2, cap_np, cov,
                               is_milli, want_mstd)
        for k in ("stu", "pu", "stt", "pt", "stks", "pks"):
            out[k][lo:hi] = cols[k]
        if want_mstd:
            mstd[lo:hi] = cols["mstd"]

    max_inflight = 8
    if len(ranges) > 1:
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        pool = ThreadPoolExecutor(min(4, len(ranges)))
        try:
            enc_futs = deque()
            pending = deque()
            it = iter(ranges)
            submitted = 0
            while True:
                # keep a bounded window of encodes in flight
                while (len(enc_futs) + len(pending) < max_inflight
                       and submitted < len(ranges)):
                    enc_futs.append(pool.submit(encode, next(it)))
                    submitted += 1
                if enc_futs:
                    pending.append(dispatch(enc_futs.popleft().result()))
                if (len(pending) >= max_inflight
                        or (not enc_futs and pending)):
                    finalize(pending.popleft())
                if not enc_futs and not pending and submitted == len(ranges):
                    break
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
    else:
        for rg in ranges:
            finalize(dispatch(encode(rg)))

    return TestResult(**out, mstd=mstd)
