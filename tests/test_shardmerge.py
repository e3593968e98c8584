"""Position-sharded multi-host merge (parallel/shardmerge.py).

Thread-fake collectives (barrier gather + barrier all-to-all) run every
rank's code path concurrently, asserting:
  * the concatenated per-range output shards are BYTE-IDENTICAL to the
    single-host run — including the capped repeated-subsample KS (row
    offsets) and the pool capacity cap (position-local priorities);
  * the global top sites match the single-host walk;
  * at 10M+ observations the routed exchange moves each observation
    (at most) once over the fake DCN — a small fraction of what the
    full-union allgather merge would move.
"""

import os
import threading

import numpy as np
import pytest

from fixtures import make_corrected_dataset, make_genome

jax = pytest.importorskip("jax")


def make_thread_gather(n_hosts):
    barrier = threading.Barrier(n_hosts)
    slots = [None] * n_hosts

    def gather_for(rank):
        def g(x):
            slots[rank] = np.asarray(x)
            barrier.wait()
            out = np.concatenate([slots[i] for i in range(n_hosts)])
            barrier.wait()
            return out
        return g
    return gather_for


def make_thread_alltoall(n_hosts, byte_meter=None):
    """Barrier all-to-all over threads: rank r deposits [pc, chunk, W]
    (row d destined to host d) and receives [pc, chunk, W] (row s from
    host s).  byte_meter, if given, accumulates the UNPADDED off-diagonal
    bytes actually routed (what a real DCN all-to-all transports)."""
    barrier = threading.Barrier(n_hosts)
    slots = [None] * n_hosts

    def for_rank(rank):
        def a2a(send, send_counts=None):
            if byte_meter is not None and send_counts is not None:
                w = send.shape[-1]
                byte_meter[0] += int(sum(
                    int(send_counts[d]) * w
                    for d in range(n_hosts) if d != rank))
            slots[rank] = np.asarray(send)
            barrier.wait()
            out = np.stack([slots[s][rank] for s in range(n_hosts)])
            barrier.wait()
            return out
        return a2a
    return for_rank


def run_ranks(n, fn):
    """fn(rank, gather, alltoall) on one thread per rank."""
    gather_for = make_thread_gather(n)
    a2a_for = make_thread_alltoall(n)
    results = [None] * n
    errors = []

    def worker(rank):
        try:
            results[rank] = fn(rank, gather_for(rank), a2a_for(rank))
        except BaseException as e:
            errors.append(e)
            raise

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if errors:
        raise errors[0]
    return results


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("shardmerge"))
    chrom, genome = make_genome(length=400, seed=7)
    make_corrected_dataset(os.path.join(root, "control"), chrom, genome,
                           n_reads=24, seed=1)
    make_corrected_dataset(os.path.join(root, "case"), chrom, genome,
                           n_reads=24, seed=2, mod_pos=173, mod_delta=1.0)
    return root


def _cfg(root, out, **kw):
    from nanomod.config import DetectConfig, RankConfig, StatConfig
    return DetectConfig(
        wrk_base1=os.path.join(root, "control"),
        wrk_base2=os.path.join(root, "case"),
        out_folder=out, file_id="sm", min_lr=0,
        # exercise the order/offset-sensitive paths: capped KS + pool cap
        stats=StatConfig(coverages=(12, 12), downsampling=10,
                         downsampling_quantile=0.25),
        pool_capacity=16, rank=RankConfig(window=4), **kw)


@pytest.mark.parametrize("n_hosts", [2, 3])
def test_sharded_detect_matches_single_host(dataset, tmp_path, n_hosts):
    from nanomod.detect import run_detect
    from nanomod.parallel.shardmerge import distributed_detect_sharded

    single_out = os.path.join(str(tmp_path), "single")
    table, order, want_sites = run_detect(_cfg(dataset, single_out))
    with open(os.path.join(single_out, "sm_sign_test.txt"), "rb") as f:
        want = f.read()
    assert len(want) > 1000

    shard_out = os.path.join(str(tmp_path), f"sharded{n_hosts}")
    res = run_ranks(n_hosts, lambda rank, g, a: distributed_detect_sharded(
        _cfg(dataset, shard_out), gather=g, alltoall=a,
        process_count=n_hosts, process_index=rank))

    with open(os.path.join(shard_out, "sm_sign_test.txt"), "rb") as f:
        got = f.read()
    assert got == want, "concatenated shard output differs from single-host"
    # no leftover part files
    assert not [f for f in os.listdir(shard_out) if "@shard" in f]

    # shards partition the table: row counts sum to the single-host table
    assert sum(len(t) for t, _, _ in res) == len(table)
    # every rank reports the same global top sites == single-host
    for _, _, sites in res:
        assert [(s.chrom, s.strand, s.pos) for s in sites] == \
            [(s.chrom, s.strand, s.pos) for s in want_sites]


def test_sharded_detect_mstd_parts_concatenate(dataset, tmp_path):
    from nanomod.detect import run_detect
    from nanomod.parallel.shardmerge import distributed_detect_sharded

    single_out = os.path.join(str(tmp_path), "single")
    run_detect(_cfg(dataset, single_out, mstd=True))
    with open(os.path.join(single_out, "sm_meanstd.cvs"), "rb") as f:
        want = f.read()

    shard_out = os.path.join(str(tmp_path), "sharded")
    run_ranks(2, lambda rank, g, a: distributed_detect_sharded(
        _cfg(dataset, shard_out, mstd=True), gather=g, alltoall=a,
        process_count=2, process_index=rank))
    with open(os.path.join(shard_out, "sm_meanstd.cvs"), "rb") as f:
        assert f.read() == want


@pytest.mark.parametrize("wind_ovlp", [0, 1])
@pytest.mark.parametrize("n_hosts", [2, 3])
def test_sharded_region_rank_matches_single_host(dataset, tmp_path, n_hosts,
                                                 wind_ovlp):
    """RegionRankbyST=1 under the sharded merge: global window grid, the
    cp>=pmax quirk, (q, tie) ordering, overlap dedup and the top-N walk all
    must reproduce the single-host region ranking exactly."""
    from nanomod.config import RankConfig, replace
    from nanomod.detect import run_detect
    from nanomod.parallel.shardmerge import distributed_detect_sharded

    def cfg(out):
        base = _cfg(dataset, out)
        return replace(base, rank=RankConfig(
            window=4, region_rank_by_st=1, wind_ovlp=wind_ovlp))

    single_out = os.path.join(str(tmp_path), "single")
    _, _, want_sites = run_detect(cfg(single_out))
    assert len(want_sites) > 2

    shard_out = os.path.join(str(tmp_path), f"sharded{n_hosts}")
    res = run_ranks(n_hosts, lambda rank, g, a: distributed_detect_sharded(
        cfg(shard_out), gather=g, alltoall=a,
        process_count=n_hosts, process_index=rank))
    for _, _, sites in res:
        assert [(s.chrom, s.strand, s.pos, s.base) for s in sites] == \
            [(s.chrom, s.strand, s.pos, s.base) for s in want_sites]
    # the sign_test file itself is region-mode-independent and still
    # byte-matches
    with open(os.path.join(single_out, "sm_sign_test.txt"), "rb") as f:
        want = f.read()
    with open(os.path.join(shard_out, "sm_sign_test.txt"), "rb") as f:
        assert f.read() == want


def _pdf_pages(path):
    with open(path, "rb") as f:
        data = f.read()
    return data.count(b"/Type /Page") - data.count(b"/Type /Pages")


def test_sharded_plots_match_single_host(dataset, tmp_path):
    """make_plots under the sharded merge: owners collect their sites'
    window payloads, rank 0 renders the single reference-named PDF with
    the same pages as the single-host run."""
    from nanomod.config import replace
    from nanomod.detect import run_detect
    from nanomod.parallel.shardmerge import distributed_detect_sharded

    single_out = os.path.join(str(tmp_path), "single")
    run_detect(replace(_cfg(dataset, single_out), make_plots=True))
    want_pdf = os.path.join(single_out, "rplot_sm.pdf")
    assert os.path.exists(want_pdf) and _pdf_pages(want_pdf) > 0

    shard_out = os.path.join(str(tmp_path), "sharded")
    run_ranks(2, lambda rank, g, a: distributed_detect_sharded(
        replace(_cfg(dataset, shard_out), make_plots=True), gather=g,
        alltoall=a, process_count=2, process_index=rank))
    got_pdf = os.path.join(shard_out, "rplot_sm.pdf")
    assert os.path.exists(got_pdf)
    assert _pdf_pages(got_pdf) == _pdf_pages(want_pdf)


def test_exchange_transfer_volume_10m_observations():
    """≥10M observations across 4 hosts: the routed exchange transports
    each observation at most once (plus tiny halo duplicates) — measured
    off-host bytes must be a small fraction of the full-union allgather's
    pc x total — and the owned ranges reassemble the exact single-host
    pools."""
    from nanomod.accum.pools import PoolBuilder, pack_observations
    from nanomod.parallel.shardmerge import (exchange_group,
                                                 plan_position_shards)

    n_hosts, p_len, reads_per_host = 4, 250_000, 10
    rng = np.random.default_rng(0)
    genome = np.frombuffer(rng.choice([b"A", b"C", b"G", b"T"],
                                      p_len).tobytes(), dtype="S1")

    def host_pools(seed):
        b = PoolBuilder()
        r = np.random.default_rng(seed)
        for _ in range(reads_per_host):
            b.add_read("chr", "+", 0,
                       np.round(r.normal(0, 1, p_len), 3).astype(np.float32),
                       genome)
        return b.finalize()

    partials = [host_pools(s) for s in range(n_hosts)]
    total_obs = sum(int(p[("chr", "+")].counts.sum()) for p in partials)
    assert total_obs >= 10_000_000

    meter = [0]
    gather_for = make_thread_gather(n_hosts)
    a2a_for = make_thread_alltoall(n_hosts, byte_meter=meter)
    results = [None] * n_hosts
    errors = []

    def worker(rank):
        try:
            plan = plan_position_shards([partials[rank]], halo=2,
                                        gather=gather_for(rank),
                                        process_count=n_hosts,
                                        process_index=rank)
            # exchange_group CONSUMES its pools dict; hand it a shallow
            # copy so the assertions below can still read the originals
            results[rank] = (plan, exchange_group(
                plan, dict(partials[rank]), alltoall=a2a_for(rank),
                gather=gather_for(rank)))
        except BaseException as e:
            errors.append(e)
            raise

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_hosts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors:
        raise errors[0]

    rec_bytes = 13
    union_bytes = n_hosts * total_obs * rec_bytes    # allgather merge cost
    # each obs crosses once unless its owner == its source (1/pc on
    # average), plus halo duplicates: comfortably under 0.85x one-copy
    assert meter[0] <= 0.85 * total_obs * rec_bytes, meter[0]
    assert meter[0] <= 0.25 * union_bytes
    print(f"routed {meter[0]/1e6:.1f} MB vs union {union_bytes/1e6:.1f} MB")

    # correctness at scale: own ranges reassemble the single-host pack
    allv = np.concatenate([
        p[("chr", "+")].values[
            np.arange(p[("chr", "+")].values.shape[1])[None, :]
            < p[("chr", "+")].counts[:, None]]
        for p in partials])
    allp = np.concatenate([
        np.repeat(p[("chr", "+")].positions, p[("chr", "+")].counts)
        for p in partials])
    single = pack_observations(
        "chr", "+", allp, allv,
        np.zeros(len(allp), np.int8), max_capacity=0)

    covered = np.zeros(p_len, dtype=bool)
    for rank, (plan, own) in enumerate(results):
        lo, hi = plan.own_range()
        pp = own[("chr", "+")]
        c = plan.coord(np.zeros(len(pp.positions), np.int64), pp.positions)
        own_rows = (c >= lo) & (c < hi)
        own_pos = pp.positions[own_rows]
        covered[own_pos] = True
        sidx = np.searchsorted(single.positions, own_pos)
        np.testing.assert_array_equal(single.counts[sidx],
                                      pp.counts[own_rows])
        got = pp.values[own_rows]
        want = single.values[sidx, : got.shape[1]]
        np.testing.assert_array_equal(got, want)
    assert covered.all(), "own ranges must partition the position space"
