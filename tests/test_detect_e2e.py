"""End-to-end detect: synthetic corrected FAST5 groups -> ranked sites.

Mirrors the reference's validation strategy: a known modified site must rank
first (ref mySimulate.py getTopRank semantics)."""

import os

import numpy as np
import pytest

from fixtures import make_genome, make_corrected_dataset
from nanomod.config import DetectConfig, StatConfig, RankConfig, replace
from nanomod.detect import run_detect, ingest_group, detect_from_pools, save_sign_test

MOD_POS = 173          # 0-based
MOD_STRAND_DELTA = 1.0


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    chrom, genome = make_genome(length=400, seed=7)
    ctrl = os.path.join(root, "control")
    case = os.path.join(root, "case")
    make_corrected_dataset(ctrl, chrom, genome, n_reads=24, seed=1)
    make_corrected_dataset(case, chrom, genome, n_reads=24, seed=2,
                           mod_pos=MOD_POS, mod_delta=MOD_STRAND_DELTA)
    return root, chrom, genome, ctrl, case


def _cfg(root, ctrl, case, **kw):
    cfg = DetectConfig(
        wrk_base1=ctrl, wrk_base2=case,
        out_folder=os.path.join(root, "out"),
        min_lr=0,
        rank=RankConfig(window=4),
    )
    return replace(cfg, **kw) if kw else cfg


def test_detect_finds_planted_site(dataset):
    root, chrom, genome, ctrl, case = dataset
    table, order, sites = run_detect(_cfg(root, ctrl, case))
    # both strands carry the shift; the top site must be at MOD_POS (either strand)
    assert sites[0].pos == MOD_POS
    assert sites[0].chrom == chrom

    # output table format: reference's 12(+2)-column text
    out = os.path.join(root, "out", "mod_sign_test.txt")
    with open(out) as f:
        lines = f.read().strip().split("\n")
    assert len(lines) == len(table)
    cols = lines[0].split()
    assert len(cols) == 14          # stouffer default adds comb columns
    assert cols[0] == chrom and cols[1] in "+-"
    int(cols[2]); int(cols[4]); int(cols[5])
    float(cols[7]); float(cols[13])

    # positions are 1-based in the file
    first_pos = int(lines[0].split()[2])
    assert first_pos == table.positions[0] + 1


def test_detect_ks_method_no_comb_column(dataset):
    root, chrom, genome, ctrl, case = dataset
    cfg = _cfg(root, ctrl, case, **{"stats.test_method": "ks", "file_id": "ksrun"})
    table, order, sites = run_detect(cfg)
    out = os.path.join(root, "out", "ksrun_sign_test.txt")
    with open(out) as f:
        assert len(f.readline().split()) == 12
    assert sites[0].pos == MOD_POS


def test_detect_min_coverage_filters(dataset):
    root, chrom, genome, ctrl, case = dataset
    pools1 = ingest_group(ctrl, _cfg(root, ctrl, case))
    pools2 = ingest_group(case, _cfg(root, ctrl, case))
    # with absurd coverage requirement everything is filtered
    cfg = _cfg(root, ctrl, case, min_coverage=1000)
    table, order = detect_from_pools(pools1, pools2, cfg)
    assert len(table) == 0 and len(order) == 0


def test_detect_chrom_filter(dataset):
    root, chrom, genome, ctrl, case = dataset
    cfg = _cfg(root, ctrl, case, chrom="nonexistent")
    pools = ingest_group(ctrl, cfg)
    assert pools == {}


def test_pos_window_filter(dataset):
    root, chrom, genome, ctrl, case = dataset
    cfg = _cfg(root, ctrl, case, chrom=chrom, pos=MOD_POS)
    pools1 = ingest_group(ctrl, cfg)
    pools2 = ingest_group(case, cfg)
    table, order = detect_from_pools(pools1, pools2, cfg)
    # only the ±window neighborhood is accumulated
    w = cfg.rank.window
    assert np.all((table.positions >= MOD_POS - w) & (table.positions <= MOD_POS + w))


def test_mstd_output(dataset, tmp_path):
    root, chrom, genome, ctrl, case = dataset
    cfg = _cfg(root, ctrl, case, mstd=True, file_id="withmstd",
               out_folder=str(tmp_path))
    table, order, sites = run_detect(cfg)
    save_sign_test(table, cfg)
    mpath = os.path.join(str(tmp_path), "withmstd_meanstd.cvs")
    with open(mpath) as f:
        line = f.readline().split()
    assert len(line) == 8
    # mean/std columns are plausible normalized-signal values
    assert abs(float(line[4])) < 5


def test_native_formatter_parity(tmp_path):
    """The threaded C++ results formatter must render byte-identically to
    the Python %-format spec on adversarial values: NaN (both signs), inf,
    negative zero, denormals, huge magnitudes, exponent >= 100, and exact
    rounding-boundary decimals."""
    from nanomod.native.build import native_available
    from nanomod.rank.ranking import SignTable
    from nanomod.stats.battery import TestResult
    from nanomod.config import DetectConfig, StatConfig, replace

    if not native_available("format_core"):
        pytest.skip("no native toolchain")

    tricky = np.array([
        0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf,
        1e-310, -1e-310, 5e-324, 1.7976931348623157e308,
        0.0005, -0.0005, 0.0015, 1234.56785, -1234.56775,
        9.9995e-5, 1.00049999e2, 3.0724e-101, -2.5e-200, 7.77e250,
    ])
    n = len(tricky)
    rng = np.random.default_rng(0)

    def col(shift):
        return np.roll(tricky, shift)

    res = TestResult(stu=col(0), pu=np.abs(col(1)), stt=col(2),
                     pt=np.abs(col(3)), stks=col(4), pks=np.abs(col(5)),
                     stcomb=col(6), pcomb=np.abs(col(7)),
                     mstd=np.stack([col(0), np.abs(col(1)),
                                    col(2), np.abs(col(3))], axis=1))
    table = SignTable(
        keys=[("chrA", "+"), ("chrB", "-")],
        group_ids=rng.integers(0, 2, n).astype(np.int64),
        positions=rng.integers(0, 10**9, n).astype(np.int64),
        base=rng.choice(list("ACGT"), n).astype("<U1"),
        cov1=rng.integers(1, 10**6, n).astype(np.int32),
        cov2=rng.integers(1, 10**6, n).astype(np.int32),
        res=res)

    cfg = DetectConfig(out_folder=str(tmp_path), file_id="nat", mstd=True,
                       stats=StatConfig(test_method="stouffer"))
    p_nat = save_sign_test(table, cfg)
    nat = open(p_nat, "rb").read()
    nat_m = open(os.path.join(str(tmp_path), "nat_meanstd.cvs"), "rb").read()

    cfg_py = replace(cfg, native_ingest=False, file_id="py")
    p_py = save_sign_test(table, cfg_py)
    py = open(p_py, "rb").read()
    py_m = open(os.path.join(str(tmp_path), "py_meanstd.cvs"), "rb").read()

    assert nat == py
    assert nat_m == py_m
    assert b"NAN" in py and b"nan" in py     # the tricky values landed


def test_pool_capacity_cap():
    """finalize(max_capacity=N) bounds the reservoir; shallow positions
    keep everything and deep positions keep a deterministic subsample."""
    import numpy as np

    from nanomod.accum.pools import PoolBuilder

    def build(cap):
        b = PoolBuilder()
        rng = np.random.default_rng(0)
        # 50 reads covering pos 0..9; one ultra-deep position 5
        for i in range(50):
            b.add_read("c", "+", 0, rng.normal(size=10).astype(np.float32),
                       np.array(list("ACGTACGTAC")))
        for i in range(500):
            b.add_read("c", "+", 5, np.array([1.0], np.float32),
                       np.array(["A"]))
        return b.finalize(max_capacity=cap)[("c", "+")]

    exact = build(0)
    assert exact.capacity == 550
    capped = build(64)
    assert capped.capacity == 64
    np.testing.assert_array_equal(capped.counts,
                                  np.minimum(exact.counts, 64))
    # shallow positions keep the exact same observations (order-preserved
    # sets); values for pos 0 must match
    i0 = np.searchsorted(exact.positions, 0)
    assert set(np.round(capped.values[i0, :capped.counts[i0]], 5)) == \
        set(np.round(exact.values[i0, :exact.counts[i0]], 5))
    # determinism
    again = build(64)
    np.testing.assert_array_equal(capped.values, again.values)


def test_native_pack_matches_numpy_pipeline():
    """The fused native pool build (sort_core.cpp nm_pack_*) must produce
    byte-identical PositionPools to the numpy pipeline, including the
    first-max majority base vote and zero padding."""
    import unittest.mock as mock

    import numpy as np

    from nanomod.accum import pools as P

    if not P.load_native_available():
        return
    for seed in range(3):
        rng = np.random.default_rng(seed)
        n = 300_000
        pos = rng.integers(0, 40_000, n).astype(np.int64)
        val = np.round(rng.normal(0, 1, n), 3).astype(np.float32)
        cod = rng.integers(0, 5, n).astype(np.int8)
        a = P.pack_observations("c", "+", pos, val, cod)
        with mock.patch.object(P, "_pack_native", lambda *a_, **k: None):
            b = P.pack_observations("c", "+", pos, val, cod)
        assert np.array_equal(a.positions, b.positions)
        assert np.array_equal(a.counts, b.counts)
        assert a.values.shape == b.values.shape
        assert a.values.tobytes() == b.values.tobytes()
        assert np.array_equal(a.base, b.base)
    # vote tie -> np.argmax first-max semantics
    pos = np.zeros(4, np.int64)
    val = np.float32([1, 2, 3, 4])
    cod = np.int8([1, 1, 0, 0])
    a = P.pack_observations("c", "+", pos, val, cod)
    with mock.patch.object(P, "_pack_native", lambda *a_, **k: None):
        b = P.pack_observations("c", "+", pos, val, cod)
    assert np.array_equal(a.base, b.base)
