"""Multi-chip sharding tests on the 8-virtual-device CPU mesh."""

import numpy as np
import jax
import pytest

from nanomod.parallel.mesh import (distributed_detect_step, make_mesh,
                                       shard_pools_over_positions)
from nanomod.stats import kernels


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return make_mesh(8, data=2)


def _pools(p, n, seed=0):
    rng = np.random.default_rng(seed)
    z = np.where(rng.random((p, n)) < 0.8, rng.normal(0, 1, (p, n)), np.inf)
    z = np.sort(z, axis=1).astype(np.float32)  # pads to the end per row
    lab = (rng.random((p, n)) < 0.5).astype(np.float32)
    lab[~np.isfinite(z)] = 0.0
    n1 = np.maximum((lab * np.isfinite(z)).sum(1), 1).astype(np.float32)
    n2 = np.maximum(((1 - lab) * np.isfinite(z)).sum(1), 1).astype(np.float32)
    return z, lab, n1, n2


def test_mesh_shape(mesh):
    assert mesh.shape == {"data": 2, "pos": 4}


def test_sharded_battery_matches_single_device(mesh):
    z, lab, n1, n2 = _pools(64, 32)
    d_ref, trs_ref, ties_ref = (np.asarray(x) for x in
                                kernels.pooled_rank_components(z, lab, n1, n2))
    zs, labs, n1s, n2s = shard_pools_over_positions(mesh, z, lab, n1, n2)
    d, trs, ties = (np.asarray(x) for x in
                    kernels.pooled_rank_components(zs, labs, n1s, n2s))
    np.testing.assert_allclose(d, d_ref, rtol=1e-6)
    np.testing.assert_array_equal(trs, trs_ref)


def test_distributed_detect_step(mesh):
    genome_len = 128
    rng = np.random.default_rng(1)
    n_reads, read_len = 8, 32
    read_pos = rng.integers(0, genome_len, (n_reads, read_len)).astype(np.int32)
    read_val = rng.normal(0, 1, (n_reads, read_len)).astype(np.float32)
    read_ok = rng.random((n_reads, read_len)) < 0.9

    z, lab, n1, n2 = _pools(64, 32)
    cnt, s1, s2, d_all, trs, ties = distributed_detect_step(
        mesh, genome_len, read_pos, read_val, read_ok, z, lab, n1, n2)
    cnt = np.asarray(cnt)
    s1 = np.asarray(s1)

    # psum-merged accumulation equals the host-side scatter-add
    cnt_ref = np.zeros(genome_len)
    s1_ref = np.zeros(genome_len)
    for r in range(n_reads):
        for j in range(read_len):
            if read_ok[r, j]:
                cnt_ref[read_pos[r, j]] += 1
                s1_ref[read_pos[r, j]] += read_val[r, j]
    np.testing.assert_allclose(cnt, cnt_ref, rtol=1e-6)
    np.testing.assert_allclose(s1, s1_ref, rtol=1e-5, atol=1e-5)

    # gathered D equals single-device computation
    d_ref, _, _ = (np.asarray(x) for x in
                   kernels.pooled_rank_components(z, lab, n1, n2))
    np.testing.assert_allclose(np.asarray(d_all), d_ref, rtol=1e-6)


@pytest.fixture(scope="module")
def corrected_dataset(tmp_path_factory):
    import os
    from fixtures import make_genome, make_corrected_dataset
    root = str(tmp_path_factory.mktemp("shds"))
    chrom, genome = make_genome(length=400, seed=7)
    ctrl = os.path.join(root, "control")
    case = os.path.join(root, "case")
    make_corrected_dataset(ctrl, chrom, genome, n_reads=24, seed=1)
    make_corrected_dataset(case, chrom, genome, n_reads=24, seed=2,
                           mod_pos=173, mod_delta=1.0)
    return root, ctrl, case


def _detect_bytes(root, ctrl, case, file_id, **kw):
    import os
    from nanomod.config import DetectConfig, RankConfig, replace
    from nanomod.detect import run_detect
    cfg = DetectConfig(wrk_base1=ctrl, wrk_base2=case,
                       out_folder=os.path.join(root, "out"),
                       file_id=file_id, min_lr=0, rank=RankConfig(window=4))
    cfg = replace(cfg, **kw)
    run_detect(cfg)
    with open(os.path.join(root, "out", f"{file_id}_sign_test.txt"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("method", ["stouffer", "fisher", "ks"])
def test_sharded_detect_byte_identical(corrected_dataset, method):
    """`detect --n_devices 8` must produce a _sign_test.txt byte-identical
    to the single-device run (VERDICT r1 next-step #1).  Exercises the
    position-sharded battery, the exact milli Welch path and the
    halo-exchanged neighbor combination on the 8-CPU mesh."""
    root, ctrl, case = corrected_dataset
    kw = {"stats.test_method": method}
    single = _detect_bytes(root, ctrl, case, f"single_{method}", **kw)
    sharded = _detect_bytes(root, ctrl, case, f"shard_{method}",
                            n_devices=8, **kw)
    assert len(single) > 1000
    assert sharded == single


def test_sharded_detect_byte_identical_capped(corrected_dataset):
    """Byte identity with the capped repeated-subsample KS active (the
    per-absolute-row RNG keying makes the draws sharding-invariant)."""
    root, ctrl, case = corrected_dataset
    kw = {"stats.coverages": (10, 10), "mstd": True}
    single = _detect_bytes(root, ctrl, case, "single_cap", **kw)
    sharded = _detect_bytes(root, ctrl, case, "shard_cap", n_devices=8, **kw)
    assert sharded == single
    import os
    with open(os.path.join(root, "out", "single_cap_meanstd.cvs"), "rb") as f:
        m1 = f.read()
    with open(os.path.join(root, "out", "shard_cap_meanstd.cvs"), "rb") as f:
        m2 = f.read()
    assert m1 == m2 and len(m1) > 100


def test_stencil_halo_uses_collective_permute(mesh):
    """The neighbor stencil's halo exchange must compile to
    collective-permute (fixed-size boundary transfer), not all-gather."""
    import jax.numpy as jnp
    from nanomod.parallel.sharded import _stencil_fn
    fn = _stencil_fn(mesh, 2, 0)
    P = 64
    args = (jnp.zeros(P, jnp.int32), jnp.zeros(P, jnp.int32),
            jnp.ones(P, jnp.int32), jnp.ones(P, jnp.int32),
            jnp.arange(P, dtype=jnp.int32), jnp.ones(P, bool))
    hlo = fn.lower(*args).compile().as_text()
    assert "collective-permute" in hlo
    assert "all-gather" not in hlo


def test_shard_list_round_robin():
    from nanomod.parallel.dist import shard_list
    items = list(range(10))
    shards = [shard_list(items, process_id=i, process_count=3) for i in range(3)]
    assert sorted(sum(shards, [])) == items
    assert shards[0] == [0, 3, 6, 9]


def test_merge_pools_single_host_identity():
    from nanomod.parallel.dist import merge_pools_across_hosts
    from nanomod.accum.pools import PoolBuilder
    b = PoolBuilder()
    b.add_read("c", "+", 5, np.array([1.0, 2.0], np.float32),
               np.array([b"A", b"C"], "S1"))
    pools = b.finalize()
    assert merge_pools_across_hosts(pools) is pools


def _reads_for_host(seed, chroms=("cA", "cB")):
    """Reads with genome-consistent bases (real corrected reads carry the
    reference base, so per-position bases agree across hosts; the merge's
    count-weighted base vote is only exact under that invariant)."""
    rng = np.random.default_rng(seed)
    genome = np.random.default_rng(99).choice(
        [b"A", b"C", b"G", b"T"], 64).astype("S1")
    reads = []
    for _ in range(12):
        chrom = chroms[int(rng.integers(len(chroms)))]
        strand = "+-"[int(rng.integers(2))]
        start = int(rng.integers(0, 30))
        n = int(rng.integers(5, 15))
        vals = np.round(rng.normal(0, 1, n), 3).astype(np.float32)
        gpos = (start + np.arange(n) if strand == "+"
                else start + n - 1 - np.arange(n))
        reads.append((chrom, strand, start, vals, genome[gpos]))
    return reads


def make_thread_gather(n_hosts):
    """Barrier-based allgather over threads: each call deposits this rank's
    array, waits for every rank, and returns the rank-ordered concatenation
    — semantically identical to process_allgather but protocol-agnostic, so
    the merge wire format can change without breaking this test."""
    import threading

    barrier = threading.Barrier(n_hosts)
    slots = [None] * n_hosts

    def gather_for(rank):
        def g(x):
            slots[rank] = np.asarray(x)
            barrier.wait()
            out = np.concatenate([slots[i] for i in range(n_hosts)])
            barrier.wait()  # all ranks read before the next round deposits
            return out
        return g
    return gather_for


def run_threaded_merge(per_host_pools, merge_fn):
    """Run merge_fn(pools, gather, rank) on one thread per host under a
    barrier gather; returns each host's merged result (or raises the first
    thread exception)."""
    import threading

    n = len(per_host_pools)
    gather_for = make_thread_gather(n)
    results = [None] * n
    errors = []

    def worker(rank):
        try:
            results[rank] = merge_fn(per_host_pools[rank],
                                     gather_for(rank), rank)
        except BaseException as e:  # surface into the test
            errors.append(e)
            raise

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    if errors:
        raise errors[0]
    return results


def _build_pools(reads):
    from nanomod.accum.pools import PoolBuilder
    b = PoolBuilder()
    for r in reads:
        b.add_read(*r)
    return b.finalize()


def assert_pools_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        g, w = got[key], want[key]
        np.testing.assert_array_equal(g.positions, w.positions)
        np.testing.assert_array_equal(g.counts, w.counts)
        np.testing.assert_array_equal(g.base, w.base)
        for i in range(len(w.positions)):
            assert sorted(g.values[i, :g.counts[i]].tolist()) == \
                sorted(w.values[i, :w.counts[i]].tolist()), (key, i)


def test_merge_pools_two_hosts_matches_single_host():
    """The packed-observation allgather merge must reconstruct exactly the
    pools a single host would build from the union of reads (values as
    multisets per position, counts, majority bases) — exercised with both
    hosts' merges running concurrently under a barrier-based thread gather
    standing in for jax.distributed, covering the real merge code path
    symmetrically on every rank."""
    from nanomod.parallel.dist import merge_pools_across_hosts

    reads_a = _reads_for_host(1)
    reads_b = _reads_for_host(2, chroms=("cA", "cC"))  # asymmetric keys

    pools_a, pools_b = _build_pools(reads_a), _build_pools(reads_b)
    want = _build_pools(reads_a + reads_b)

    got_a, got_b = run_threaded_merge(
        [pools_a, pools_b],
        lambda pools, gather, rank: merge_pools_across_hosts(
            pools, gather=gather, process_count=2))

    assert_pools_equal(got_a, want)
    assert_pools_equal(got_b, want)


def test_merge_pools_three_hosts_one_empty():
    """A host with zero reads (empty pool dict) must participate in the
    collective without corrupting the union — the all-hosts-identical
    invariant is what run_detect relies on downstream."""
    from nanomod.parallel.dist import merge_pools_across_hosts

    reads_a = _reads_for_host(3)
    reads_b = _reads_for_host(4, chroms=("cA", "cD"))
    pools = [_build_pools(reads_a), {}, _build_pools(reads_b)]
    want = _build_pools(reads_a + reads_b)

    results = run_threaded_merge(
        pools,
        lambda p, gather, rank: merge_pools_across_hosts(
            p, gather=gather, process_count=3))
    for got in results:
        assert_pools_equal(got, want)


def test_merge_annotate_stats_two_hosts():
    """Annotate run stats (ok count, error path lists, resegment histogram)
    merge to identical global totals on every rank."""
    from nanomod.parallel.dist import merge_annotate_stats

    per_host = [
        (5, {"Not in alignment sam": ["a.fast5"], "X": ["b.fast5"]}, {4: 3}),
        (7, {"Not in alignment sam": ["c.fast5"]}, {4: 1, 1: 2}),
    ]
    got = run_threaded_merge(
        [None, None],
        lambda _, gather, rank: merge_annotate_stats(
            *per_host[rank], gather=gather, process_count=2))
    for n_ok, errors, hist in got:
        assert n_ok == 12
        assert sorted(errors["Not in alignment sam"]) == ["a.fast5", "c.fast5"]
        assert errors["X"] == ["b.fast5"]
        assert hist == {4: 4, 1: 2}


def test_merge_annotate_stats_single_host_identity():
    from nanomod.parallel.dist import merge_annotate_stats

    errs, hist = {"k": ["p"]}, {2: 1}
    n, e, h = merge_annotate_stats(3, errs, hist, process_count=1)
    assert (n, e, h) == (3, errs, hist)
