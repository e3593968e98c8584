"""Ranking-mode tests: per-site sort keys, 'st' ranking, and the
region-window mode (RegionRankbyST=1, ref myDetect.py:463-516)."""

import numpy as np
import pytest

from nanomod.config import RankConfig, StatConfig
from nanomod.rank.ranking import (SignTable, region_rank,
                                      region_rank_spec, sort_sites,
                                      top_sites)
from nanomod.stats.battery import TestResult


def _table(p=60, seed=0, planted=30):
    rng = np.random.default_rng(seed)
    pks = rng.uniform(0.01, 1.0, p)
    pu = rng.uniform(0.01, 1.0, p)
    pcomb = rng.uniform(0.01, 1.0, p)
    pcomb[planted] = 1e-12
    pks[planted] = 1e-10
    res = TestResult(
        stu=rng.uniform(0, 100, p), pu=pu,
        stt=rng.normal(0, 1, p), pt=rng.uniform(0.01, 1, p),
        stks=rng.uniform(0, 1, p), pks=pks,
        stcomb=-np.log(pcomb), pcomb=pcomb,
    )
    return SignTable(
        keys=[("chr1", "+")],
        group_ids=np.zeros(p, np.int64),
        positions=np.arange(100, 100 + p, dtype=np.int64),
        base=np.full(p, "A"), cov1=np.full(p, 10, np.int32),
        cov2=np.full(p, 10, np.int32), res=res,
    )


def test_sort_by_pv_uses_comb_then_ks_then_u():
    t = _table()
    order = sort_sites(t, StatConfig(), RankConfig())
    assert order[0] == 30
    # ties on primary break by ks then u
    t.res.pcomb[:] = 0.5
    t.res.pks[:] = 0.5
    t.res.pu[:] = np.arange(len(t))[::-1]
    order = sort_sites(t, StatConfig(), RankConfig())
    assert order[0] == len(t) - 1          # smallest pu wins the tie


def test_sort_by_st_reverses():
    t = _table()
    t.res.stcomb = np.arange(len(t), dtype=float)
    order = sort_sites(t, StatConfig(), RankConfig(rank_use="st"))
    assert order[0] == len(t) - 1


def test_ks_method_ranks_by_ks_column():
    t = _table()
    t.res.pcomb = None
    t.res.stcomb = None
    cfg = StatConfig(test_method="ks")
    order = sort_sites(t, cfg, RankConfig())
    assert order[0] == 30                  # pks[30] is the minimum


def test_top_sites_dedup_radius():
    t = _table()
    t.res.pcomb[31] = 1e-11                # neighbor of the planted site
    order = sort_sites(t, StatConfig(), RankConfig())
    sites = top_sites(t, order, StatConfig(neighbor_pvalues=2), RankConfig(),
                      top_n=5)
    poss = [s.pos for s in sites]
    # 130 and 131 are closer than closesize=4: only one survives
    assert (130 in poss) != (131 in poss)


def test_region_rank_prefers_planted_window():
    t = _table(p=80, planted=40)
    # make a contiguous low-p region around the planted site
    t.res.pcomb[38:43] = 1e-10
    cfg_r = RankConfig(window=3, region_rank_by_st=True, percentile=0.1)
    order = region_rank(t, StatConfig(), cfg_r)
    assert len(order) > 0
    top_pos = t.positions[order[0]]
    # the winning window center should be within window+1 of the planted site
    assert abs(int(top_pos) - 140) <= 4


def test_region_rank_na_filter():
    t = _table(p=80, planted=40)
    t.base[:] = "C"
    t.base[40] = "A"
    cfg_r = RankConfig(window=3, region_rank_by_st=True, percentile=0.1,
                       na="G")
    # no G positions at all -> pvlists are empty -> len<=5 -> no windows
    order = region_rank(t, StatConfig(), cfg_r)
    assert len(order) == 0


def _random_table(seed, p=120, gaps=True, groups=2):
    rng = np.random.default_rng(seed)
    keys = [("chr1", "+"), ("chr2", "-")][:groups]
    gid = np.sort(rng.integers(0, groups, p)).astype(np.int64)
    positions = np.empty(p, np.int64)
    for g in range(groups):
        n = int((gid == g).sum())
        step = rng.integers(1, 3, n) if gaps else np.ones(n, np.int64)
        positions[gid == g] = 50 + np.cumsum(step)
    pcomb = rng.uniform(1e-12, 1.0, p)
    res = TestResult(
        stu=rng.uniform(0, 100, p), pu=rng.uniform(0.01, 1, p),
        stt=rng.normal(0, 1, p), pt=rng.uniform(0.01, 1, p),
        stks=rng.uniform(0, 1, p), pks=rng.uniform(1e-10, 1, p),
        stcomb=-np.log(pcomb), pcomb=pcomb,
    )
    base = rng.choice(list("ACGT"), p)
    return SignTable(keys=keys, group_ids=gid, positions=positions,
                     base=base.astype("<U1"),
                     cov1=np.full(p, 10, np.int32),
                     cov2=np.full(p, 10, np.int32), res=res)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("wind_ovlp", [False, True])
@pytest.mark.parametrize("na", ["", "A"])
@pytest.mark.parametrize("rank_use", ["pv", "st"])
def test_region_rank_matches_spec(seed, wind_ovlp, na, rank_use):
    """The vectorized region_rank must reproduce the direct reference port
    (region_rank_spec) on randomized tables with gaps, multiple groups, NA
    filtering and both overlap modes."""
    t = _random_table(seed, gaps=(seed % 2 == 0))
    cfg = RankConfig(window=3, region_rank_by_st=True, percentile=0.25,
                     wind_ovlp=wind_ovlp, na=na, rank_use=rank_use)
    got = region_rank(t, StatConfig(), cfg)
    want = region_rank_spec(t, StatConfig(), cfg)
    np.testing.assert_array_equal(got, want)


def test_region_rank_scales():
    """region mode must survive large position counts (the reference's
    per-position Python walk was minutes at genome scale)."""
    import time
    t = _random_table(9, p=200_000, gaps=False, groups=1)
    cfg = RankConfig(window=10, region_rank_by_st=True, wind_ovlp=True)
    t0 = time.time()
    order = region_rank(t, StatConfig(), cfg)
    assert time.time() - t0 < 10.0
    assert len(order) > 0


def test_region_rank_overlap_dedup():
    t = _table(p=80, planted=40)
    t.res.pcomb[30:50] = 1e-8
    cfg = RankConfig(window=3, region_rank_by_st=True, wind_ovlp=True)
    order = region_rank(t, StatConfig(), cfg)
    pos = t.positions[order]
    # overlapping windows within `window+1` of a higher-ranked one are dropped
    assert (np.abs(np.diff(np.sort(pos))) >= 4).all()
