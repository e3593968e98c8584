"""Position-sharded multi-host detect: observations travel ONCE.

The bootstrap multi-host merge (parallel/dist.merge_pools_across_hosts)
allgathers every observation to every host — N x total bytes over DCN and
full-union RAM per host.  This module implements the SURVEY §5 layout
instead: the global (chrom, strand, position) coordinate space is
partitioned into one contiguous range per host, every observation is routed
to the host OWNING its coordinate with one all-to-all (so each byte crosses
DCN once, not N times), and each host packs, tests and writes only its own
range.  Only tiny metadata (key table, per-key extents, count matrices,
top-site candidates) is allgathered.

Boundary coupling is the neighbor p-value window (±k positions,
ref bin/scripts/myDetect.py:383): ranges OVERLAP by a halo of k coordinates
— observations within k of a cut are duplicated to both neighbors — so each
host runs the completely standard detect locally (stats on halo rows feed
the combination of own rows) and then trims the halo from its output shard.
The capped-KS subsample RNG stays whole-join-exact via per-key row offsets
(detect.detect_from_pools row_offsets), and the pool capacity cap is
position-local (accum.pools pack_observations), so the concatenation of the
per-host output shards is BYTE-IDENTICAL to the single-host run.

The reference's analog is qsub fan-out + text-file merge
(ref bin/scripts/mySimulate.py:344-457); here the "merge" is the DCN
all-to-all plus rank 0 concatenating the per-range result files (ranges are
contiguous ascending in the global (chrom, strand, pos) sort order, so
concatenation in rank order IS the reference-format global file).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

import jax

from nanomod.parallel.dist import (_decode_keys, _encode_keys,
                                       _multihost_gather)

_REC_BYTES = 13          # kid i32 | pos i32 | val f32 | base code i8
_I32_MAX = 2 ** 31 - 1
# records per all-to-all slice: bounds the padded transport transient to
# ~pc x 52 MB per end (overridable for tests/tuning)
_SLICE_RECORDS = int(os.environ.get("NANOMOD_EXCHANGE_SLICE", 4_000_000))


@dataclass
class ShardPlan:
    """Agreed partition of the global (key, position) coordinate space."""

    keys: List[Tuple[str, str]]   # global sorted (chrom, strand) table
    key_lo: np.ndarray            # [K] int64 global min position per key
    key_cum: np.ndarray           # [K+1] int64 concat-space key offsets
    cuts: np.ndarray              # [pc+1] int64 range cut points
    halo: int
    pc: int
    pid: int

    def coord(self, kid: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """Global concatenated coordinate of (key id, genomic position)."""
        kid = np.asarray(kid, dtype=np.int64)
        return self.key_cum[kid] + (np.asarray(pos, np.int64)
                                    - self.key_lo[kid])

    def own_range(self) -> Tuple[int, int]:
        return int(self.cuts[self.pid]), int(self.cuts[self.pid + 1])


def plan_position_shards(pool_dicts, halo: int, gather=None,
                         process_count: Optional[int] = None,
                         process_index: Optional[int] = None) -> ShardPlan:
    """Agree on the key table and a balanced contiguous range partition.

    Hosts gather each key's local [min, max] position extent (int32 — the
    same 2^31 genomic-coordinate bound as the whole wire protocol); the
    concatenation of per-key spans forms one global coordinate axis, cut
    into process_count equal ranges.  Balance is by coordinate span, which
    matches observation balance under the roughly uniform coverage of real
    sequencing runs."""
    pc = jax.process_count() if process_count is None else process_count
    pid = jax.process_index() if process_index is None else process_index
    gather = gather or _multihost_gather

    local_keys = sorted(set().union(*[set(d) for d in pool_dicts]))
    local_w = max((len(f"{c}\t{s}".encode()) for c, s in local_keys),
                  default=0)
    width = int(gather(np.array([local_w], dtype=np.int32)).max(initial=1))
    keys = _decode_keys(gather(_encode_keys(local_keys, width)))
    gid = {key: i for i, key in enumerate(keys)}
    k_n = len(keys)

    ext = np.empty((k_n, 2), dtype=np.int32)
    ext[:, 0] = _I32_MAX          # min sentinel for keys absent locally
    ext[:, 1] = -1
    for d in pool_dicts:
        for key, pp in d.items():
            if len(pp.positions):
                lo = int(pp.positions.min())
                hi = int(pp.positions.max())
                assert hi < _I32_MAX, "position overflows the int32 wire"
                i = gid[key]
                ext[i, 0] = min(ext[i, 0], lo)
                ext[i, 1] = max(ext[i, 1], hi)
    g_ext = np.asarray(gather(ext)).reshape(-1, k_n, 2)
    key_lo = g_ext[:, :, 0].min(axis=0).astype(np.int64)
    key_hi = g_ext[:, :, 1].max(axis=0).astype(np.int64)
    spans = np.maximum(key_hi - key_lo + 1, 0)
    key_cum = np.concatenate([[0], np.cumsum(spans)]).astype(np.int64)
    total = int(key_cum[-1])
    if total < pc * (4 * halo + 8):
        raise ValueError(
            f"coordinate space ({total}) too small to range-shard across "
            f"{pc} hosts with halo {halo}; use merge_mode='union'")
    cuts = (np.arange(pc + 1, dtype=np.int64) * total) // pc
    return ShardPlan(keys=keys, key_lo=key_lo, key_cum=key_cum, cuts=cuts,
                     halo=halo, pc=pc, pid=pid)


def _pack_records(kid, pos, val, cod) -> np.ndarray:
    n = len(kid)
    rec = np.empty((n, _REC_BYTES), dtype=np.uint8)
    rec[:, 0:4] = kid.astype("<i4").view(np.uint8).reshape(n, 4)
    rec[:, 4:8] = pos.astype("<i4").view(np.uint8).reshape(n, 4)
    rec[:, 8:12] = val.astype("<f4").view(np.uint8).reshape(n, 4)
    rec[:, 12] = cod.astype(np.int8).view(np.uint8)
    return rec


def _unpack_records(rec: np.ndarray):
    rec = np.ascontiguousarray(rec, dtype=np.uint8)
    kid = rec[:, 0:4].copy().view("<i4").ravel()
    pos = rec[:, 4:8].copy().view("<i4").ravel().astype(np.int64)
    val = rec[:, 8:12].copy().view("<f4").ravel()
    # copy, not view: a view would pin the whole 13-byte-stride record
    # buffer in memory through its base reference
    cod = rec[:, 12].astype(np.int8)
    return kid, pos, val, cod


def jax_alltoall(send_blocks: np.ndarray, send_counts=None) -> np.ndarray:
    """Real-backend all-to-all over the jax.distributed mesh (one device
    per process): send_blocks [pc, chunk, W] uint8, row d destined to host
    d; returns [pc, chunk, W] where row s came from host s.  XLA's
    all-to-all moves each byte to its destination once (the padded chunk is
    the global max per (src, dst) pair — bounded by the count-matrix gather
    done before this call)."""
    del send_counts    # transport is padded; counts are for fakes/metrics
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    per_proc = {}
    for d in jax.devices():
        per_proc.setdefault(d.process_index, d)
    devs = [per_proc[i] for i in sorted(per_proc)]
    pc = len(devs)
    assert send_blocks.shape[0] == pc
    mesh = Mesh(np.array(devs), ("h",))
    sharding = NamedSharding(mesh, P("h"))
    garr = jax.make_array_from_single_device_arrays(
        (pc * pc,) + send_blocks.shape[1:], sharding,
        [jax.device_put(send_blocks, devs[jax.process_index()])])
    fn = jax.jit(jax.shard_map(
        lambda x: jax.lax.all_to_all(x, "h", split_axis=0, concat_axis=0,
                                     tiled=True),
        mesh=mesh, in_specs=P("h"), out_specs=P("h")))
    out = fn(garr)
    return np.asarray(out.addressable_shards[0].data)


def exchange_group(plan: ShardPlan, pools: Dict, alltoall=None, gather=None,
                   max_capacity: int = 0) -> Dict:
    """Route this host's observations to their owning hosts; return the
    pools for THIS host's halo-padded range, packed with the standard
    canonical-order pack (accum.pools.pack_observations).

    An observation at coordinate c is sent to owner(c), plus the left
    (right) neighbor when c is within halo of the range cut, so each
    host's pools cover [cut[pid]-halo, cut[pid+1]+halo) completely.

    NOTE: `pools` is CONSUMED — the dict is cleared once its observations
    are flattened, so the pre-exchange dense pools don't stay resident
    alongside the routed copy (they are ~1 GB/host at 100M observations).
    """
    from nanomod.accum.pools import (_BASE_TO_CODE, pack_observations)

    alltoall = alltoall or jax_alltoall
    gather = gather or _multihost_gather
    pc, pid, halo = plan.pc, plan.pid, plan.halo
    gid = {key: i for i, key in enumerate(plan.keys)}

    kid_l, pos_l, val_l, cod_l = [], [], [], []
    for key in sorted(pools):
        pp = pools.pop(key)
        cnt = pp.counts
        mask = np.arange(pp.values.shape[1])[None, :] < cnt[:, None]
        pos_l.append(np.repeat(pp.positions, cnt))
        val_l.append(pp.values[mask])
        codes = _BASE_TO_CODE[
            np.frombuffer(pp.base.astype("S1").tobytes(), dtype=np.uint8)]
        cod_l.append(np.repeat(codes, cnt))
        kid_l.append(np.full(int(cnt.sum()), gid[key], np.int32))
        del pp, mask

    def cat(parts, dtype):
        out = (np.concatenate(parts).astype(dtype) if parts
               else np.empty(0, dtype))
        parts.clear()
        return out

    kid = cat(kid_l, np.int32)
    pos = cat(pos_l, np.int64)
    val = cat(val_l, np.float32)
    cod = cat(cod_l, np.int8)

    c = plan.coord(kid, pos)
    owner = np.searchsorted(plan.cuts, c, side="right") - 1
    owner = np.clip(owner, 0, pc - 1).astype(np.int32)
    # halo duplicates to the neighbors whose padded range also contains c
    left = (owner > 0) & (c < plan.cuts[owner] + halo)
    right = (owner < pc - 1) & (c >= plan.cuts[owner + 1] - halo)
    dest = np.concatenate([owner, owner[left] - 1, owner[right] + 1])
    idx = np.concatenate([np.arange(len(c)), np.flatnonzero(left),
                          np.flatnonzero(right)])

    by_dest = np.argsort(dest, kind="stable")
    dest_s, idx_s = dest[by_dest], idx[by_dest]
    send_counts = np.bincount(dest_s, minlength=pc).astype(np.int64)

    count_mat = np.asarray(
        gather(send_counts.astype(np.int32))).reshape(pc, pc)
    # record the off-host bytes this rank actually routes (the padded
    # transport moves chunk-sized rows; this is the useful payload the
    # 1x-per-byte claim is about) — surfaces in metrics as dcn_route
    from nanomod.utils.observe import stage as _stage
    with _stage("dcn_route", unit="bytes") as _s:
        _s.add(int(sum(int(send_counts[d]) for d in range(pc)
                       if d != pid)) * _REC_BYTES)
    rec = _pack_records(kid[idx_s], pos[idx_s], val[idx_s], cod[idx_s])
    del kid, pos, val, cod, idx_s, dest, dest_s, by_dest, c, owner
    starts = np.concatenate([[0], np.cumsum(send_counts)])

    # sliced all-to-all: the padded transport buffer is pc x chunk x 13
    # bytes on BOTH ends — at 100M+ routed observations a single exchange
    # would transiently hold >1 GB/host, so the record space is cut into
    # fixed-chunk slices (one jit shape) and exchanged in rounds
    max_pair = int(count_mat.max(initial=1))
    n_slices = max(1, -(-max_pair // _SLICE_RECORDS))
    chunk = -(-max_pair // n_slices)
    parts = [[] for _ in range(pc)]       # received rows per SOURCE
    for sl in range(n_slices):
        lo = sl * chunk
        send = np.zeros((pc, chunk, _REC_BYTES), dtype=np.uint8)
        slice_counts = np.zeros(pc, np.int64)
        for d in range(pc):
            n = int(min(max(int(send_counts[d]) - lo, 0), chunk))
            slice_counts[d] = n
            if n:
                send[d, :n] = rec[starts[d] + lo: starts[d] + lo + n]
        recv = np.asarray(alltoall(send, slice_counts))
        for src in range(pc):
            n = int(min(max(int(count_mat[src, pid]) - lo, 0), chunk))
            if n:
                parts[src].append(recv[src, :n].copy())
        del send, recv
    del rec
    n_recv = int(count_mat[:, pid].sum())
    flat = np.empty((n_recv, _REC_BYTES), np.uint8)
    off = 0
    for p in parts:
        for blk in p:
            flat[off: off + len(blk)] = blk
            off += len(blk)
        p.clear()
    r_kid, r_pos, r_val, r_cod = _unpack_records(flat)
    del flat

    out = {}
    for k in np.unique(r_kid):
        sel = r_kid == k
        key = plan.keys[int(k)]
        out[key] = pack_observations(key[0], key[1], r_pos[sel], r_val[sel],
                                     r_cod[sel], max_capacity=max_capacity)
    return out


def _slice_table(table, mask: np.ndarray):
    """Row-mask slice of a SignTable (keys list kept as-is)."""
    from nanomod.rank.ranking import SignTable
    from nanomod.stats.battery import TestResult

    def s(a):
        return None if a is None else a[mask]

    r = table.res
    res = TestResult(stu=s(r.stu), pu=s(r.pu), stt=s(r.stt), pt=s(r.pt),
                     stks=s(r.stks), pks=s(r.pks), stcomb=s(r.stcomb),
                     pcomb=s(r.pcomb), mstd=s(r.mstd))
    return SignTable(keys=table.keys, group_ids=s(table.group_ids),
                     positions=s(table.positions), base=s(table.base),
                     cov1=s(table.cov1), cov2=s(table.cov2), res=res)


def _global_top_sites(table, order, plan: ShardPlan, cfg, gather):
    """Global top-N from per-host candidates: each host contributes its
    local top candidates with full sort keys; the merged mini-table is
    ranked exactly like the single-host walk.  Per host the top-N walk can
    consume at most top_n emitted + top_n*(2*closesize) dedup-suppressed
    candidates, so contributing that many rows bounds the merge exactly."""
    from nanomod.rank.ranking import SignTable, sort_sites, top_sites
    from nanomod.stats.battery import TestResult

    closesize = max(cfg.stats.neighbor_pvalues * 2, 1)
    n_cand = cfg.rank.top_n * (2 * closesize + 1) + 8
    cand = order[:n_cand]

    gid_of_key = np.array([plan.keys.index(k) for k in table.keys]
                          if table.keys else [], dtype=np.int32)
    ints = np.empty((len(cand), 5), dtype=np.int32)
    if len(cand):
        ints[:, 0] = gid_of_key[table.group_ids[cand]]
        ints[:, 1] = table.positions[cand].astype(np.int32)
        ints[:, 2] = np.frombuffer(
            table.base[cand].astype("S1").tobytes(), np.uint8)
        ints[:, 3] = table.cov1[cand]
        ints[:, 4] = table.cov2[cand]
    r = table.res
    has_comb = r.pcomb is not None
    fcols = [r.stu, r.pu, r.stt, r.pt, r.stks, r.pks]
    fcols += [r.stcomb, r.pcomb] if has_comb else [r.stks, r.pks]
    flt = (np.stack([col[cand] for col in fcols], axis=1)
           if len(cand) else np.empty((0, 8), np.float64))

    g_ints = np.asarray(gather(ints)).reshape(-1, 5)
    # float64 p-values cross the wire as raw bytes: process_allgather under
    # default JAX config silently downcasts f64 -> f32, which would merge
    # distinct p-values and corrupt the global ranking
    g_flt = np.ascontiguousarray(
        np.asarray(gather(np.ascontiguousarray(flt).view(np.uint8)))
    ).view(np.float64).reshape(-1, 8)
    # global (key, pos) sort so lexsort tie-breaks match the single-host
    # table's row order
    by = np.lexsort((g_ints[:, 1], g_ints[:, 0]))
    g_ints, g_flt = g_ints[by], g_flt[by]

    res = TestResult(stu=g_flt[:, 0], pu=g_flt[:, 1], stt=g_flt[:, 2],
                     pt=g_flt[:, 3], stks=g_flt[:, 4], pks=g_flt[:, 5])
    if has_comb:
        res.stcomb, res.pcomb = g_flt[:, 6], g_flt[:, 7]
    mini = SignTable(
        keys=plan.keys, group_ids=g_ints[:, 0].astype(np.int64),
        positions=g_ints[:, 1].astype(np.int64),
        base=g_ints[:, 2].astype(np.uint8).view("S1").astype("<U1"),
        cov1=g_ints[:, 3], cov2=g_ints[:, 4], res=res)
    g_order = sort_sites(mini, cfg.stats, cfg.rank)
    sites = top_sites(mini, g_order, cfg.stats, cfg.rank,
                      top_n=cfg.rank.top_n)
    for s in sites:
        s.table_index = -1      # indexes the merged candidates, not the
    return sites                # caller's local shard table


def _global_region_sites(full_table, trimmed_table, plan: ShardPlan, cfg,
                         gather):
    """Global region-rank (RegionRankbyST=1, ref myDetect.py:463-516) under
    the sharded merge: each host scores the windows whose CENTER it owns
    (the halo covers every member row and its combination neighbors), using
    the GLOBAL per-key span so the window grid and the ``cp >= pmax`` quirk
    match the single-host walk, then the per-host top candidates merge into
    one exactly-ranked global walk (sort by (q, tie) + overlap dedup +
    top-N min-distance dedup)."""
    from nanomod.rank.ranking import (SignTable, dedup_region_windows,
                                          region_candidates, top_sites)

    gid = {key: i for i, key in enumerate(plan.keys)}
    k_n = len(plan.keys)
    w = cfg.rank.window + 1

    # global per-key span of the JOINED table rows (the trimmed shards
    # partition them): local extents gathered + reduced
    ext = np.empty((k_n, 2), dtype=np.int64)
    ext[:, 0] = np.iinfo(np.int64).max
    ext[:, 1] = np.iinfo(np.int64).min
    if len(trimmed_table):
        for li, key in enumerate(trimmed_table.keys):
            sel = trimmed_table.group_ids == li
            if sel.any():
                i = gid[key]
                p = trimmed_table.positions[sel]
                ext[i, 0] = int(p.min())
                ext[i, 1] = int(p.max())
    g_ext = np.asarray(gather(ext.astype(np.int64))).reshape(-1, k_n, 2)
    span_lo = g_ext[:, :, 0].min(axis=0)
    span_hi = g_ext[:, :, 1].max(axis=0)

    lo_own, hi_own = plan.own_range()
    cand_rows = np.empty((0, 6), np.int64)
    cand_q = np.empty(0, np.float64)
    if len(full_table):
        spans = {}
        for li, key in enumerate(full_table.keys):
            i = gid[key]
            if span_lo[i] <= span_hi[i]:
                spans[li] = (int(span_lo[i]), int(span_hi[i]))
        q, tie, ti, gs, pk = region_candidates(full_table, cfg.stats,
                                               cfg.rank, spans=spans)
        if len(q):
            kmap = np.array([gid[k] for k in full_table.keys], np.int64)
            c = plan.coord(kmap[gs], pk)
            own = (c >= lo_own) & (c < hi_own)
            q, tie, ti, gs, pk = q[own], tie[own], ti[own], gs[own], pk[own]
        if len(q):
            order = np.lexsort((tie, q))
            n_cand = cfg.rank.top_n * (2 * w + 1) + 8
            order = order[:n_cand]
            base_u8 = np.frombuffer(
                full_table.base[ti[order]].astype("S1").tobytes(), np.uint8)
            cand_rows = np.stack([
                kmap[gs[order]], pk[order], tie[order],
                base_u8.astype(np.int64),
                full_table.cov1[ti[order]].astype(np.int64),
                full_table.cov2[ti[order]].astype(np.int64)], axis=1)
            cand_q = q[order]

    g_rows = np.asarray(gather(cand_rows.astype(np.int64))).reshape(-1, 6)
    g_q = np.ascontiguousarray(
        np.asarray(gather(np.ascontiguousarray(cand_q).view(np.uint8)))
    ).view(np.float64)
    # reproduce the single-host windseg append order: (group, pk) ascending
    by = np.lexsort((g_rows[:, 1], g_rows[:, 0]))
    g_rows, g_q = g_rows[by], g_q[by]
    order = np.lexsort((g_rows[:, 2], g_q))
    if cfg.rank.wind_ovlp:
        order = dedup_region_windows(order, g_rows[:, 0], g_rows[:, 1], w)
    mini = SignTable(
        keys=plan.keys, group_ids=g_rows[:, 0],
        positions=g_rows[:, 1],
        base=g_rows[:, 3].astype(np.uint8).view("S1").astype("<U1"),
        cov1=g_rows[:, 4].astype(np.int32),
        cov2=g_rows[:, 5].astype(np.int32), res=None)
    sites = top_sites(mini, order, cfg.stats, cfg.rank, top_n=cfg.rank.top_n)
    for s in sites:
        s.table_index = -1
    return sites


def _sharded_plots(full_table, sites, own1, own2, plan: ShardPlan, cfg,
                   gather, pid: int):
    """Top-site plots under the sharded merge (the union path draws them
    from full pools, ref myDetect.py:257-299): the host OWNING each site's
    coordinate collects that site's ±window signal/p-value payload from its
    halo-padded pools, payloads gather to rank 0, rank 0 renders the
    single reference-named PDF."""
    import pickle

    from nanomod.harness.plots import (collect_site_window,
                                           render_site_pages)

    gid = {key: i for i, key in enumerate(plan.keys)}
    lo_own, hi_own = plan.own_range()
    local = []
    for site in sites[: cfg.rank.top_n]:
        key = (site.chrom, site.strand)
        if key not in gid:
            continue
        c = int(plan.coord(np.array([gid[key]]), np.array([site.pos]))[0])
        if not (lo_own <= c < hi_own):
            continue
        sd = collect_site_window(full_table, site, own1, own2, cfg)
        if sd is not None:
            local.append(sd)
    blob = np.frombuffer(pickle.dumps(local), dtype=np.uint8)
    lens = np.asarray(gather(np.array([len(blob)], np.int64)))
    blobs = np.asarray(gather(blob))
    if pid == 0:
        datas = []
        off = 0
        for n in lens:
            if n:
                datas.extend(pickle.loads(blobs[off: off + int(n)].tobytes()))
            off += int(n)
        os.makedirs(cfg.out_folder, exist_ok=True)
        path = os.path.join(cfg.out_folder, f"rplot_{cfg.file_id}.pdf")
        render_site_pages(path, datas, cfg)
    gather(np.ones(1, np.int32))        # plot visible before returning


def distributed_detect_sharded(cfg, gather=None, alltoall=None,
                               process_count: Optional[int] = None,
                               process_index: Optional[int] = None):
    """Position-sharded multi-host detect: ingest file shard -> route
    observations to range owners (one all-to-all) -> standard local detect
    on the halo-padded range with whole-join-exact capped-KS row offsets ->
    trim halo -> per-range output shards, concatenated by rank 0 into the
    byte-identical reference-format file.

    Returns (local trimmed table, local order, GLOBAL top sites).
    `gather`/`alltoall`/process_* are injectable for tests (thread fakes);
    the real 2-process backend is covered by tests/test_multihost_real.py.
    """
    from nanomod.accum.pools import join_pools
    from nanomod.config import replace
    from nanomod.detect import (detect_from_pools, ingest_group,
                                    save_sign_test)
    from nanomod.io.fast5 import iter_fast5_files
    from nanomod.parallel.dist import shard_list
    from nanomod.rank.ranking import sort_sites
    from nanomod.utils.observe import stage

    pc = jax.process_count() if process_count is None else process_count
    pid = jax.process_index() if process_index is None else process_index
    gather = gather or _multihost_gather

    partials = []
    for folder in (cfg.wrk_base1, cfg.wrk_base2):
        files = shard_list(sorted(iter_fast5_files(folder)),
                           process_id=pid, process_count=pc)
        partials.append(ingest_group(folder, replace(cfg, pool_capacity=0),
                                     files=files))

    halo = max(int(cfg.stats.neighbor_pvalues), 1)
    if cfg.rank.region_rank_by_st:
        # windows of half-width window+1 centered on owned coordinates, and
        # every member row needs its own ±nb combination neighbors valid
        halo = max(halo, cfg.rank.window + 1 + int(cfg.stats.neighbor_pvalues))
    if cfg.make_plots:
        # plot pages span ±window around owned sites, with ranking p-values
        halo = max(halo, cfg.rank.window + int(cfg.stats.neighbor_pvalues))
    plan = plan_position_shards(partials, halo, gather=gather,
                                process_count=pc, process_index=pid)
    with stage("exchange", unit="observations") as s:
        own1 = exchange_group(plan, partials[0], alltoall=alltoall,
                              gather=gather, max_capacity=cfg.pool_capacity)
        own2 = exchange_group(plan, partials[1], alltoall=alltoall,
                              gather=gather, max_capacity=cfg.pool_capacity)
        s.add(sum(int(p.counts.sum()) for p in own1.values())
              + sum(int(p.counts.sum()) for p in own2.values()))

    # whole-join-exact capped-KS row offsets: per key, my first local
    # joined row's global index = (own joined rows on lower-ranked hosts)
    # - (my halo-prefix joined rows)
    f1 = {k: v.filter_min_coverage(cfg.min_coverage)
          for k, v in own1.items()}
    f2 = {k: v.filter_min_coverage(cfg.min_coverage)
          for k, v in own2.items()}
    lo_own, hi_own = plan.own_range()
    gid = {key: i for i, key in enumerate(plan.keys)}
    n_own = np.zeros(len(plan.keys), dtype=np.int32)
    n_prefix = np.zeros(len(plan.keys), dtype=np.int32)
    for key, common, _, _ in join_pools(f1, f2):
        c = plan.coord(np.full(len(common), gid[key]), common)
        n_own[gid[key]] = int(((c >= lo_own) & (c < hi_own)).sum())
        n_prefix[gid[key]] = int((c < lo_own).sum())
    own_mat = np.asarray(gather(n_own)).reshape(pc, -1)
    offsets = {key: int(own_mat[:pid, i].sum()) - int(n_prefix[i])
               for key, i in gid.items()}

    # rank/plot machinery inside detect_from_pools is bypassed here (the
    # global rank is merged from per-host candidates below), so run it in
    # plain per-site mode on the halo-padded pools
    full_table, _ = detect_from_pools(
        own1, own2, replace(cfg, rank=replace(cfg.rank,
                                              region_rank_by_st=0)),
        row_offsets=offsets)

    # trim the halo: keep rows whose coordinate this host owns
    table = full_table
    if len(table):
        kmap = np.array([gid[k] for k in table.keys], dtype=np.int64)
        c = plan.coord(kmap[table.group_ids], table.positions)
        table = _slice_table(table, (c >= lo_own) & (c < hi_own))
    order = sort_sites(table, cfg.stats, cfg.rank)

    if cfg.save_test:
        with stage("save", unit="positions") as s:
            part_id = f"{cfg.file_id}@shard{pid:05d}"
            save_sign_test(table, replace(cfg, file_id=part_id))
            s.add(len(table))
        gather(np.ones(1, np.int32))          # all parts written
        if pid == 0:
            _concat_parts(cfg, pc, "_sign_test.txt")
            if cfg.mstd:
                _concat_parts(cfg, pc, "_meanstd.cvs")
        gather(np.ones(1, np.int32))          # final file visible to all

    if cfg.rank.region_rank_by_st:
        sites = _global_region_sites(full_table, table, plan, cfg, gather)
    else:
        sites = _global_top_sites(table, order, plan, cfg, gather)
    if cfg.make_plots:
        _sharded_plots(full_table, sites, own1, own2, plan, cfg, gather, pid)
    return table, order, sites


def _concat_parts(cfg, pc: int, suffix: str):
    """Rank 0: concatenate per-range shard files (rank order IS global
    (chrom, strand, pos) order) into the reference-format file; parts are
    removed.  Requires the out_folder to be shared across hosts (or
    single-node multi-process) — the same assumption the reference's qsub
    merge made of its SGE cluster (ref mySimulate.py:454-464)."""
    final = os.path.join(cfg.out_folder, f"{cfg.file_id}{suffix}")
    with open(final, "wb") as out:
        for r in range(pc):
            part = os.path.join(cfg.out_folder,
                                f"{cfg.file_id}@shard{r:05d}{suffix}")
            with open(part, "rb") as f:
                out.write(f.read())
            os.remove(part)
