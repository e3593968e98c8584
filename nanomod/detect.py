"""End-to-end two-group modification detection.

Rebuild of ``NanoMod.py detect`` (ref bin/scripts/myDetect.py:635
``mDetect``): ingest corrected FAST5 events for both groups into dense
position pools, filter coverage, run the vectorized test battery per
(chrom, strand), combine neighbor p-values, save the reference-format
results table, and rank sites.
"""

from __future__ import annotations

import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np

from nanomod.accum.pools import PoolBuilder, PositionPools, join_pools
from nanomod.config import DetectConfig, OUTPUT_INFO
from nanomod.io.fast5 import iter_fast5_files, read_corrected_events
from nanomod.rank.ranking import SignTable, region_rank, sort_sites, top_sites
from nanomod.stats.battery import TestResult, run_battery
from nanomod.stats.combine import combine_neighbor_pvalues
from nanomod.utils.observe import device_trace, observer, report, stage


def _read_passes_filters(rd, cfg: DetectConfig,
                         start_end: Optional[Tuple[int, int]]) -> bool:
    """Replicates mReadSignalBase's read-level filters
    (ref myDetect.py:74-102)."""
    n = len(rd.norm_mean)
    if cfg.chrom is not None and rd.chrom != cfg.chrom:
        return False
    if cfg.pos is not None and cfg.pos2 is not None:
        if rd.start > cfg.pos2 or rd.start + n < cfg.pos:
            return False
    if start_end is not None:
        if rd.start > start_end[0] or rd.start + n < start_end[1]:
            return False
    if cfg.min_lr_nb < 1:
        if n < cfg.min_lr:
            return False
    else:
        lo = cfg.min_lr - cfg.min_lr_nb
        hi = cfg.min_lr + cfg.min_lr_nb
        if not (lo < n < hi):
            return False
        # amplicon start/end band check (ref myDetect.py:98-102)
        def in_band(x):
            nb = cfg.min_lr_nb
            return (x < nb) or (8000 - nb < x < 8000 + nb) or (16000 - nb < x < 16000 + nb)
        if not (in_band(rd.start) and in_band(rd.start + n)):
            return False
    return True


def ingest_group(folder: str, cfg: DetectConfig,
                 files=None) -> Dict[Tuple[str, str], PositionPools]:
    """Walk a group folder, read corrected events, build position pools.

    Mirrors ReadAllFast5/readsubfolder/mReadSignalBase
    (ref myDetect.py:33-127,547-633) with a thread pool for the HDF5 reads.
    `files` overrides discovery (multi-host mode passes this host's shard,
    parallel/dist.py:ingest_group_multihost).
    """
    start_end = None
    pos_filter = None
    if cfg.pos is not None and cfg.pos2 is None:
        lo = max(cfg.pos - cfg.rank.window, 0)
        hi = cfg.pos + cfg.rank.window
        start_end = (lo, hi)           # read must span the window
        pos_filter = (lo, hi)          # events outside are dropped
    elif cfg.pos is not None and cfg.pos2 is not None:
        pos_filter = None              # Pos2 mode filters reads only

    builder = PoolBuilder()
    if files is None:
        files = list(iter_fast5_files(folder))

    with stage("ingest", unit="reads") as s:
        reads = None
        if cfg.native_ingest:
            from nanomod.native.fast5_bind import read_corrected_batch
            reads = read_corrected_batch(files, nthreads=cfg.num_workers)
        if reads is None:                          # h5py fallback
            with ThreadPoolExecutor(max_workers=cfg.num_workers) as ex:
                reads = list(ex.map(read_corrected_events, files))
        # count successfully parsed reads, not files — unparseable FAST5s
        # must not inflate the reported reads/s
        s.add(sum(1 for r in reads if r is not None))

    with stage("accumulate", unit="reads") as s:
        for rd in reads:
            if rd is None:
                continue
            if not _read_passes_filters(rd, cfg, start_end):
                continue
            builder.add_read(rd.chrom, rd.strand, rd.start,
                             rd.norm_mean, rd.base, pos_filter=pos_filter)
            s.add(1)
    if cfg.out_level <= OUTPUT_INFO:
        print(f"Number of files in {folder} is {len(files)}")
    with stage("finalize_pools", unit="observations") as s:
        pools = builder.finalize(max_capacity=cfg.pool_capacity,
                                 nthreads=cfg.num_workers)
        s.add(sum(int(p.counts.sum()) for p in pools.values()))
    return pools


def detect_from_pools(
    pools1: Dict, pools2: Dict, cfg: DetectConfig,
    row_offsets: Optional[Dict[Tuple[str, str], int]] = None,
) -> Tuple[SignTable, np.ndarray]:
    """Coverage-filter, test, combine and rank two groups of pools.

    Returns (table, order): `table` row order is (chrom, strand, pos) — the
    reference's sign_test order — and `order` are table indices by rank.

    `row_offsets` maps (chrom, strand) -> the global join-row index of this
    call's first joined row for that key; the multi-host sharded merge
    (parallel/shardmerge.py) passes it so the capped-KS subsample RNG draws
    match the whole-join run.  None = these pools ARE the whole join.
    """
    with stage("coverage_filter", unit="positions") as s:
        pools1 = {k: v.filter_min_coverage(cfg.min_coverage) for k, v in pools1.items()}
        pools2 = {k: v.filter_min_coverage(cfg.min_coverage) for k, v in pools2.items()}
        pools1 = {k: v for k, v in pools1.items() if v.num_positions}
        pools2 = {k: v for k, v in pools2.items() if v.num_positions}
        s.add(sum(v.num_positions for v in pools1.values())
              + sum(v.num_positions for v in pools2.values()))

    mesh = None
    if cfg.n_devices and cfg.n_devices > 1:
        from nanomod.parallel.mesh import make_mesh
        from nanomod.parallel.sharded import sharded_join_battery
        mesh = make_mesh(cfg.n_devices)

    keys = []
    parts = []
    with stage("test_battery", unit="positions") as s:
        for key, common, i1, i2 in join_pools(pools1, pools2):
            g1, g2 = pools1[key], pools2[key]
            # base disagreement warning (ref myDetect.py:432-434)
            bad = g1.base[i1] != g2.base[i2]
            if bad.any() and cfg.out_level <= OUTPUT_INFO:
                print(f"Warning: {bad.sum()} base mismatches between groups at {key}")
            off = row_offsets.get(key, 0) if row_offsets else 0
            if mesh is not None:
                # position-sharded multi-chip path: battery + halo-exchanged
                # neighbor combination per join (parallel/sharded.py)
                res = sharded_join_battery(
                    mesh, g1.values[i1], g1.counts[i1],
                    g2.values[i2], g2.counts[i2], positions=common,
                    strand=key[1], cfg=cfg.stats, want_mstd=cfg.mstd,
                    row_offset=off,
                )
            else:
                res = run_battery(
                    g1.values, g1.counts[i1], g2.values, g2.counts[i2],
                    strand=key[1], cfg=cfg.stats, tile_positions=cfg.tile_positions,
                    want_mstd=cfg.mstd, row_offset=off,
                    idx1=i1, idx2=i2,
                )
            keys.append(key)
            parts.append((key, common, g2.base[i2], g1.counts[i1], g2.counts[i2], res))
            s.add(len(common))

    if not parts:
        empty = TestResult(*(np.empty(0) for _ in range(6)))
        table = SignTable([], np.empty(0, np.int64), np.empty(0, np.int64),
                          np.empty(0, "<U1"), np.empty(0, np.int32),
                          np.empty(0, np.int32), empty)
        return table, np.empty(0, np.int64)

    group_ids = np.concatenate(
        [np.full(len(p[1]), gi, dtype=np.int64) for gi, p in enumerate(parts)]
    )
    positions = np.concatenate([p[1] for p in parts])
    base = np.concatenate([p[2] for p in parts]).astype("<U1")
    cov1 = np.concatenate([p[3] for p in parts]).astype(np.int32)
    cov2 = np.concatenate([p[4] for p in parts]).astype(np.int32)

    def cat(attr):
        return np.concatenate([getattr(p[5], attr) for p in parts])

    res = TestResult(
        stu=cat("stu"), pu=cat("pu"), stt=cat("stt"), pt=cat("pt"),
        stks=cat("stks"), pks=cat("pks"),
        mstd=(np.concatenate([p[5].mstd for p in parts]) if cfg.mstd else None),
    )

    # neighbor combination (ref myDetect.py:443: skipped for testMethod 'ks')
    if cfg.stats.test_method != "ks":
        if cfg.stats.neighbor_pvalues == 0:
            # ref myDetect.py:413: the KS tuple is reused as the 4th column
            res.stcomb, res.pcomb = res.stks.copy(), res.pks.copy()
        elif mesh is not None:
            # already combined per join on the mesh (halo exchange covers
            # shard boundaries; join boundaries are invalid neighbors in
            # both paths, so per-join == global combination)
            res.stcomb, res.pcomb = cat("stcomb"), cat("pcomb")
        else:
            with stage("combine_pvalues", unit="positions") as s:
                res.stcomb, res.pcomb = combine_neighbor_pvalues(
                    group_ids, positions, res.pks, cfg.stats
                )
                s.add(len(positions))

    table = SignTable(keys=[p[0] for p in parts], group_ids=group_ids,
                      positions=positions, base=base, cov1=cov1, cov2=cov2,
                      res=res)

    with stage("rank", unit="positions") as s:
        if cfg.rank.region_rank_by_st:
            order = region_rank(table, cfg.stats, cfg.rank)
        else:
            order = sort_sites(table, cfg.stats, cfg.rank)
        s.add(len(positions))
    return table, order


def save_sign_test(table: SignTable, cfg: DetectConfig) -> str:
    """Write <outFolder>/<FileID>_sign_test.txt in the reference's exact
    format (ref myDetect.py:522-545): chrom strand pos1 base cov1 cov2
    stU pU stT pT stKS pKS [stComb pComb], positions 1-based.

    Rendering runs in the threaded C++ formatter (native/format_core.cpp,
    ~10x the interpreted loop at 9M rows); the Python loop below is the
    byte-identical fallback/spec (parity pinned by the golden fixtures and
    tests/test_detect_e2e.py::test_native_formatter_parity).
    """
    os.makedirs(cfg.out_folder, exist_ok=True)
    path = os.path.join(cfg.out_folder, f"{cfg.file_id}_sign_test.txt")
    r = table.res
    # ref myDetect.py:531-536: the 4th column pair reaches the file only when
    # neighborPvalues > 0 AND testMethod != 'ks'.  At neighborPvalues == 0 the
    # KS-copy tuple (myDetect.py:413) still exists internally as the rank key
    # (res.stcomb/pcomb set in detect_from_pools) but is never written.
    has_comb = (cfg.stats.test_method != "ks"
                and cfg.stats.neighbor_pvalues > 0
                and r.pcomb is not None)

    native_ok = False
    if cfg.native_ingest:          # one knob gates all native host paths
        from nanomod.native.format_bind import write_sign_test_native
        native_ok = write_sign_test_native(table, path, has_comb,
                                           nthreads=cfg.num_workers)
    if not native_ok:
        with open(path, "w") as f:
            for i in range(len(table)):
                chrom, strand = table.chrom_strand(i)
                line = "%s %s %d %s %d %d %.3f %.3E %.3f %.3E %.3f %.3E" % (
                    chrom, strand, table.positions[i] + 1, table.base[i],
                    table.cov1[i], table.cov2[i],
                    r.stu[i], r.pu[i], r.stt[i], r.pt[i], r.stks[i], r.pks[i],
                )
                if has_comb:
                    line += " %.3f %.3E" % (r.stcomb[i], r.pcomb[i])
                f.write(line + "\n")

    if cfg.mstd and r.mstd is not None:
        mpath = os.path.join(cfg.out_folder, f"{cfg.file_id}_meanstd.cvs")
        m_ok = False
        if cfg.native_ingest:
            from nanomod.native.format_bind import write_meanstd_native
            m_ok = write_meanstd_native(table, mpath,
                                        nthreads=cfg.num_workers)
        if not m_ok:
            with open(mpath, "w") as f:
                for i in range(len(table)):
                    chrom, strand = table.chrom_strand(i)
                    f.write("%s %s %d %s %.3f %.3f %.3f %.3f\n" % (
                        chrom, strand, table.positions[i], table.base[i],
                        r.mstd[i, 0], r.mstd[i, 1], r.mstd[i, 2], r.mstd[i, 3],
                    ))
    return path


def _plot_top_sites(table, sites, pools1, pools2, cfg):
    """Site plots where matplotlib is installed; the ranked table is the
    result, so without it the plots are skipped."""
    try:
        from nanomod.harness.plots import plot_top_sites
    except ImportError as e:
        print(f"nanomod: site plots skipped ({e})", file=sys.stderr)
        return
    plot_top_sites(table, sites, pools1, pools2, cfg)


def run_detect(cfg: DetectConfig):
    """Full detect pipeline (ref myDetect.py:635-643).

    Per-stage wall/throughput counters are recorded in the global Observer
    (reset at the start of each run so repeated library/harness calls in
    one process report per-run numbers, not cumulative ones);
    cfg.metrics_file dumps them as JSON and cfg.profile_dir (or
    NANOMOD_PROFILE_DIR) wraps the run in a jax.profiler device trace."""
    import nanomod
    nanomod.tune_malloc()
    observer().reset()
    if cfg.merge_mode not in ("union", "sharded"):
        raise ValueError(f"bad merge_mode {cfg.merge_mode!r}")
    with device_trace(cfg.profile_dir):
        import jax
        if jax.process_count() > 1 and cfg.merge_mode == "sharded":
            # position-sharded multi-host path: observations routed once to
            # range owners, per-range compute + output shard concatenation
            # (parallel/shardmerge.py) — byte-identical to the union path
            from nanomod.parallel.shardmerge import (
                distributed_detect_sharded)
            table, order, sites = distributed_detect_sharded(cfg)
            report(cfg.out_level)
            if cfg.metrics_file:
                observer().to_json(cfg.metrics_file)
            return table, order, sites
        if jax.process_count() > 1:
            # multi-host launch (jax.distributed): each process ingests its
            # file shard, pools merge over DCN (parallel/dist.py)
            from nanomod.parallel.dist import ingest_group_multihost
            pools1 = ingest_group_multihost(cfg.wrk_base1, cfg)
            pools2 = ingest_group_multihost(cfg.wrk_base2, cfg)
        else:
            pools1 = ingest_group(cfg.wrk_base1, cfg)
            pools2 = ingest_group(cfg.wrk_base2, cfg)
        table, order = detect_from_pools(pools1, pools2, cfg)
        if cfg.save_test:
            with stage("save", unit="positions") as s:
                save_sign_test(table, cfg)
                s.add(len(table))
        sites = top_sites(table, order, cfg.stats, cfg.rank, top_n=cfg.rank.top_n)
        if cfg.make_plots:
            _plot_top_sites(table, sites, pools1, pools2, cfg)
    report(cfg.out_level)
    if cfg.metrics_file:
        observer().to_json(cfg.metrics_file)
    return table, order, sites
