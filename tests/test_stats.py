"""Parity tests for the two-sample statistic kernels.

Oracles are modern scipy calls whose semantics are unchanged since 1.2.1
(KS D statistic, rankdata, Welch t, combine_pvalues); where 1.2.1 semantics
differ from modern defaults (KS p-value's Stephens correction, legacy
mannwhitneyu p), the 1.2.1 formula is checked directly against scipy's
distribution primitives.
"""

import numpy as np
import pytest
import scipy.stats as ss

from nanomod.config import StatConfig
from nanomod.stats import special
from nanomod.stats.battery import run_battery
from nanomod.stats.combine import combine_neighbor_pvalues, neighbor_matrix

RNG = np.random.default_rng(42)


def _make_pools(p, c1max, c2max, shift=0.0, ties=False):
    counts1 = RNG.integers(5, c1max + 1, size=p).astype(np.int32)
    counts2 = RNG.integers(5, c2max + 1, size=p).astype(np.int32)
    v1 = RNG.normal(0.0, 1.0, size=(p, c1max)).astype(np.float32)
    v2 = RNG.normal(shift, 1.2, size=(p, c2max)).astype(np.float32)
    if ties:
        # round to 1 decimal to force heavy ties (reference signals are
        # rounded to 3 decimals; 1 decimal stresses the tie machinery)
        v1 = np.round(v1, 1)
        v2 = np.round(v2, 1)
    return v1, counts1, v2, counts2


def _rows(v1, c1, v2, c2):
    for i in range(len(c1)):
        yield v1[i, : c1[i]].astype(np.float64), v2[i, : c2[i]].astype(np.float64)


@pytest.mark.parametrize("ties", [False, True])
def test_battery_matches_scipy(ties):
    p = 64
    v1, c1, v2, c2 = _make_pools(p, 40, 30, shift=0.4, ties=ties)
    res = run_battery(v1, c1, v2, c2, tile_positions=32)

    for i, (a, b) in enumerate(_rows(v1, c1, v2, c2)):
        # --- KS D: unchanged across scipy versions ---
        d_ref = ss.ks_2samp(a, b, method="asymp").statistic
        assert res.stks[i] == pytest.approx(d_ref, abs=2e-6), f"row {i} KS D"
        # 1.2.1 p-value formula
        en = np.sqrt(len(a) * len(b) / (len(a) + len(b)))
        p_ref = ss.distributions.kstwobign.sf((en + 0.12 + 0.11 / en) * d_ref)
        assert res.pks[i] == pytest.approx(max(p_ref, special.FLOAT_MIN), rel=1e-4)

        # --- MWU: u = min(u1,u2); legacy p = modern two-sided asymp / 2 ---
        m = ss.mannwhitneyu(a, b, use_continuity=True,
                            alternative="two-sided", method="asymptotic")
        u_min = min(m.statistic, len(a) * len(b) - m.statistic)
        assert res.stu[i] == pytest.approx(u_min, abs=1e-6), f"row {i} U"
        assert res.pu[i] == pytest.approx(m.pvalue / 2.0, rel=1e-5), f"row {i} pU"

        # --- Welch t: unchanged across versions ---
        t = ss.ttest_ind(a, b, equal_var=False)
        assert res.stt[i] == pytest.approx(t.statistic, rel=1e-4, abs=1e-5)
        assert res.pt[i] == pytest.approx(t.pvalue, rel=1e-4, abs=1e-300)


def test_rank_sum_exact_with_ties():
    # doubled rank sums must be exactly the (integer) 2*scipy rankdata sums
    from nanomod.stats import kernels
    import jax.numpy as jnp

    v1, c1, v2, c2 = _make_pools(16, 20, 25, ties=True)
    comp = kernels.battery_components(
        jnp.asarray(v1), jnp.asarray(c1), jnp.asarray(v2), jnp.asarray(c2))
    trs = np.asarray(comp["two_rank_sum"])
    ties = np.asarray(comp["tie_sum"])
    for i, (a, b) in enumerate(_rows(v1, c1, v2, c2)):
        ranks = ss.rankdata(np.concatenate([a, b]))
        assert trs[i] == int(round(2 * ranks[: len(a)].sum()))
        _, cnt = np.unique(np.concatenate([a, b]), return_counts=True)
        assert ties[i] == pytest.approx((cnt ** 3 - cnt).sum(), rel=1e-6)


def test_mwu_small_sample_legacy_formula():
    # direct check of the 1.2.1 formula on a tiny hand-checked case
    a = np.array([1.0, 2.0, 3.0], np.float64)
    b = np.array([4.0, 5.0, 6.0, 7.0], np.float64)
    v1 = np.zeros((1, 8), np.float32); v1[0, :3] = a
    v2 = np.zeros((1, 8), np.float32); v2[0, :4] = b
    res = run_battery(v1, np.array([3], np.int32), v2, np.array([4], np.int32))
    # ranks of a = 1,2,3 -> R1=6; u1 = 12 + 6 - 6 = 12; u2 = 0
    assert res.stu[0] == 0.0
    sd = np.sqrt(12 * (3 + 4 + 1) / 12.0)
    z = (12 - (6 + 0.5)) / sd
    assert res.pu[0] == pytest.approx(ss.distributions.norm.sf(abs(z)))


def test_capped_ks_deterministic_and_plausible():
    p = 24
    v1, c1, v2, c2 = _make_pools(p, 200, 200, shift=1.5)
    c1[:] = 200
    c2[:] = 200
    cfg = StatConfig(coverages=(50, 50), downsampling=40,
                     downsampling_quantile=0.25, downsampling_seed=7)
    r1 = run_battery(v1, c1, v2, c2, strand="+", cfg=cfg)
    r2 = run_battery(v1, c1, v2, c2, strand="+", cfg=cfg)
    np.testing.assert_array_equal(r1.pks, r2.pks)  # stateless RNG
    # capped p computed at effective size 50, shift=1.5 -> strongly significant
    assert (r1.pks < 1e-6).all()
    # p-values live in the size-50 scale: larger than full-200 uncapped p
    r_uncapped = run_battery(v1, c1, v2, c2, strand="+", cfg=StatConfig())
    assert np.median(r1.pks / r_uncapped.pks) > 1.0


def test_capped_ks_respects_strand_cap():
    v1, c1, v2, c2 = _make_pools(8, 100, 100, shift=1.0)
    c1[:] = 100
    c2[:] = 100
    cfg = StatConfig(coverages=(0, 30))  # only '-' strand capped
    r_plus = run_battery(v1, c1, v2, c2, strand="+", cfg=cfg)
    r_plain = run_battery(v1, c1, v2, c2, strand="+", cfg=StatConfig())
    np.testing.assert_array_equal(r_plus.pks, r_plain.pks)
    r_minus = run_battery(v1, c1, v2, c2, strand="-", cfg=cfg)
    assert not np.array_equal(r_minus.pks, r_plain.pks)


def test_welch_exact_from_milli_sums():
    # 3-decimal pools take the int16 milli wire format, whose Welch moments
    # are EXACT integer sums -> t/df match scipy's f64 computation to ~1e-12
    # (the f32-moment path only promises ~1e-4)
    p = 48
    v1, c1, v2, c2 = _make_pools(p, 60, 45, shift=0.2)
    v1 = np.round(v1, 3).astype(np.float32)
    v2 = np.round(v2, 3).astype(np.float32)
    res = run_battery(v1, c1, v2, c2, tile_positions=16, want_mstd=True)
    # the oracle sees the DECIMAL-exact doubles (the reference stores f8
    # round(x,3) values, myRefBaseSignalAnnotation.py:702; the milli wire
    # format reconstructs exactly those, not the f32-rounded doubles)
    for i, (a, b) in enumerate(_rows(v1, c1, v2, c2)):
        a = np.rint(a * 1000.0) / 1000.0
        b = np.rint(b * 1000.0) / 1000.0
        t = ss.ttest_ind(a, b, equal_var=False)
        assert res.stt[i] == pytest.approx(t.statistic, rel=1e-12), f"row {i}"
        assert res.pt[i] == pytest.approx(t.pvalue, rel=1e-10, abs=1e-300)
        # mstd columns (population std, ref myDetect.py:437-438)
        assert res.mstd[i, 0] == pytest.approx(a.mean(), rel=1e-12)
        assert res.mstd[i, 1] == pytest.approx(a.std(), rel=1e-9, abs=1e-12)
        assert res.mstd[i, 2] == pytest.approx(b.mean(), rel=1e-12)
        assert res.mstd[i, 3] == pytest.approx(b.std(), rel=1e-9, abs=1e-12)


def test_degenerate_pools_defined_behavior():
    # All pooled values identical: scipy 1.2.1 raised ValueError (the
    # reference crashed, myDetect.py:331).  Defined divergence: pU = 1.0,
    # finite stU; Welch keeps scipy's NaN (0/0).  See DIVERGENCES.md.
    v1 = np.full((2, 8), 0.5, np.float32)
    v2 = np.full((2, 8), 0.5, np.float32)
    v2[1] = 0.75                      # row 1: constant but different pools
    c = np.array([6, 6], np.int32)
    res = run_battery(v1, c, v2, c, tile_positions=8)
    assert res.pu[0] == 1.0
    assert np.isfinite(res.stu[0])
    assert np.isnan(res.stt[0])       # scipy parity: 0/0 -> nan
    assert res.pks[0] == pytest.approx(1.0, abs=1e-6)
    # constant-but-different pools are NOT degenerate: fully separable
    assert res.pu[1] < 0.05
    assert res.pks[1] < 0.05
    m = ss.mannwhitneyu(np.full(6, 0.5), np.full(6, 0.75),
                        use_continuity=True, alternative="two-sided",
                        method="asymptotic")
    assert res.pu[1] == pytest.approx(m.pvalue / 2.0, rel=1e-6)


def test_too_deep_pools_raise():
    # exact int32 components bound the pooled width; ultra-deep positions
    # must fail loudly with the pool_capacity remedy, not overflow silently
    v = np.zeros((1, 700), np.float32)
    c = np.array([700], np.int32)
    with pytest.raises(ValueError, match="pool_capacity"):
        run_battery(v, c, v, c)


def test_capped_ks_invariant_to_tiling():
    # the subsample RNG is keyed per absolute row (fold_in), so the capped
    # KS results must not depend on tile_positions — the property that makes
    # the position-sharded multi-chip path byte-identical to single-device
    p = 40
    v1, c1, v2, c2 = _make_pools(p, 120, 120, shift=0.8)
    c1[:] = 120
    c2[:] = 120
    cfg = StatConfig(coverages=(40, 40), downsampling=30,
                     downsampling_quantile=0.25, downsampling_seed=3)
    r_one = run_battery(v1, c1, v2, c2, strand="+", cfg=cfg,
                        tile_positions=4096)
    r_tiled = run_battery(v1, c1, v2, c2, strand="+", cfg=cfg,
                          tile_positions=7)
    np.testing.assert_array_equal(r_one.pks, r_tiled.pks)
    np.testing.assert_array_equal(r_one.stks, r_tiled.stks)


def test_combine_matches_scipy_contiguous():
    p = 40
    pks = RNG.uniform(1e-12, 1.0, size=p)
    gid = np.zeros(p, dtype=np.int64)
    pos = np.arange(100, 100 + p, dtype=np.int64)

    for method in ("fisher", "stouffer"):
        cfg = StatConfig(test_method=method, neighbor_pvalues=2, weights_dif=2.0)
        stat, pv = combine_neighbor_pvalues(gid, pos, pks, cfg)
        w = [25.0, 50.0, 100.0, 50.0, 25.0]
        for i in range(2, p - 2):
            window = pks[i - 2 : i + 3]
            if method == "fisher":
                s_ref, p_ref = ss.combine_pvalues(window, method="fisher")
            else:
                s_ref, p_ref = ss.combine_pvalues(window, method="stouffer", weights=w)
            assert stat[i] == pytest.approx(s_ref, rel=1e-10)
            assert pv[i] == pytest.approx(max(p_ref, special.FLOAT_MIN), rel=1e-10)


def test_combine_missing_neighbors_give_one():
    # stouffer with any p=1.0 neighbor (missing) collapses to combined p=1.0
    # (ref myDetect.py:383-401 edge semantics)
    pks = np.array([1e-8, 1e-8, 1e-8, 1e-8])
    gid = np.array([0, 0, 1, 1])
    pos = np.array([5, 6, 100, 101])
    cfg = StatConfig(test_method="stouffer", neighbor_pvalues=2)
    stat, pv = combine_neighbor_pvalues(gid, pos, pks, cfg)
    np.testing.assert_allclose(pv, 1.0)  # every row is missing >=1 neighbor

    # fisher degrades gracefully instead
    cfg = StatConfig(test_method="fisher", neighbor_pvalues=2)
    _, pv = combine_neighbor_pvalues(gid, pos, pks, cfg)
    assert (pv < 1e-4).all()


def test_neighbor_matrix_gap_handling():
    gid = np.zeros(5, dtype=np.int64)
    pos = np.array([10, 11, 13, 14, 15], dtype=np.int64)  # gap at 12
    pks = np.array([0.1, 0.2, 0.3, 0.4, 0.5])
    mat = neighbor_matrix(gid, pos, pks, 1)
    # row 1 (pos 11): right neighbor would be pos 12 -> missing -> 1.0
    np.testing.assert_allclose(mat[1], [0.1, 0.2, 1.0])
    # row 2 (pos 13): left neighbor missing
    np.testing.assert_allclose(mat[2], [1.0, 0.3, 0.4])


def test_stencil_combine_matches_neighbor_matrix():
    """The transform-once stencil must be BITWISE equal to combining the
    explicit neighbor matrix, for both methods, across gaps and group
    boundaries."""
    from nanomod.config import StatConfig
    from nanomod.stats import special

    rng = np.random.default_rng(9)
    n = 5000
    gid = np.sort(rng.integers(0, 3, n)).astype(np.int64)
    pos = np.concatenate([np.cumsum(rng.integers(1, 3, (gid == g).sum()))
                          for g in range(3)]).astype(np.int64)
    pks = 10.0 ** rng.uniform(-200, 0, n)
    for method in ("stouffer", "fisher"):
        cfg = StatConfig(test_method=method)
        stat, p = combine_neighbor_pvalues(gid, pos, pks, cfg)
        mat = neighbor_matrix(gid, pos, pks, cfg.neighbor_pvalues)
        if method == "fisher":
            st2, p2 = special.fisher_combine(mat, axis=1)
        else:
            w = special.stouffer_weights(cfg.neighbor_pvalues,
                                         cfg.weights_dif)
            st2, p2 = special.stouffer_combine(mat, w, axis=1)
        np.testing.assert_array_equal(stat, special.clamp_stat(st2))
        np.testing.assert_array_equal(p, special.clamp_p(p2))
