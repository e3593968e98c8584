#!/usr/bin/env python
"""Independent ground truth for the scipy-1.2.1 statistical semantics.

VERDICT r4 (missing #2): the in-repo scipy-1.2.1 replicas
(stats/special.py, tests/golden/make_golden.py) validated each other —
the 1.2.1 formulas themselves were self-referential.  This generator
produces `tests/golden/scipy121_cases.json` WITHOUT importing scipy or
any nanomod code: statistics are computed in EXACT rational
arithmetic (fractions.Fraction over the integer milli domain) and
p-values by 60-digit mpmath evaluation of the closed-form definitions
scipy 1.2.1 implements:

  * Mann-Whitney U (ref myDetect.py:331, scipy 1.2.1 defaults):
      ranks/ties exact rationals; z = (max(U1,U2) - (n1 n2/2 + 1/2)) / sd,
      sd^2 = T n1 n2 (n+1)/12, T = 1 - sum(t^3-t)/(n^3-n);
      p = norm.sf(|z|) = erfc(|z|/sqrt(2))/2.
  * Welch t (ref myDetect.py:335, ttest_ind(equal_var=False)):
      means/variances exact rationals; p = 2 t.sf(|t|, df)
      = I_{df/(df+t^2)}(df/2, 1/2)   (regularized incomplete beta).
  * KS (ref myDetect.py:341, scipy 1.2.1 ks_2samp — ALWAYS the
      Stephens-corrected asymptotic tail; 1.2.1 has no exact switch):
      D exact rational; p = K_sf((en + 0.12 + 0.11/en) D),
      en = sqrt(n1 n2/(n1+n2));
      K_sf(x) = 2 sum_{k>=1} (-1)^{k-1} exp(-2 k^2 x^2)   [x >= 0.7]
      K_sf(x) = 1 - sqrt(2 pi)/x sum_{k>=1} exp(-(2k-1)^2 pi^2/(8 x^2))
                                                          [0 < x < 0.7]

Cases cover the regimes the VERDICT named: heavy ties, tiny n, the
small-statistic region, p underflow, and deep pools.

Run from the repo root:  python tools/make_scipy121_fixture.py
"""

import json
import os
from fractions import Fraction

import mpmath as mp
import numpy as np

mp.mp.dps = 60

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "..", "tests", "golden", "scipy121_cases.json")


# ---------------------------------------------------------------------------
# exact statistics (Fraction arithmetic over integer milli values)
# ---------------------------------------------------------------------------

def exact_mwu(a, b):
    """(u_min Fraction, z mpf or None, tie_sum int) with average tie
    ranks computed exactly."""
    n1, n2 = len(a), len(b)
    pooled = sorted(a + b)
    # average rank (1-based) per value: (cnt_lt + cnt_le + 1) / 2
    from collections import Counter
    cnt = Counter(pooled)
    lt = {}
    run = 0
    for v in sorted(cnt):
        lt[v] = run
        run += cnt[v]
    r1 = Fraction(0)
    for x in a:
        r1 += Fraction(lt[x] + (lt[x] + cnt[x] - 1) + 2, 2)
    u1 = Fraction(n1 * n2) + Fraction(n1 * (n1 + 1), 2) - r1
    u2 = Fraction(n1 * n2) - u1
    tie_sum = sum(t ** 3 - t for t in cnt.values())
    n = n1 + n2
    t_corr = Fraction(1) - Fraction(tie_sum, n ** 3 - n)
    var = t_corr * Fraction(n1 * n2 * (n + 1), 12)
    if var == 0:
        return min(u1, u2), None, tie_sum
    bigu = max(u1, u2)
    meanrank = Fraction(n1 * n2, 2) + Fraction(1, 2)
    z = (mp.mpf(bigu.numerator) / bigu.denominator
         - mp.mpf(meanrank.numerator) / meanrank.denominator) \
        / mp.sqrt(mp.mpf(var.numerator) / var.denominator)
    return min(u1, u2), z, tie_sum


def exact_welch(a_milli, b_milli):
    """(t mpf, df mpf) from exact integer milli sums (values = milli/1000)."""
    n1, n2 = len(a_milli), len(b_milli)
    s1 = sum(a_milli)
    s2 = sum(b_milli)
    q1 = sum(x * x for x in a_milli)
    q2 = sum(x * x for x in b_milli)
    m1 = Fraction(s1, 1000 * n1)
    m2 = Fraction(s2, 1000 * n2)
    # sample variance (ddof=1), value domain
    v1 = (Fraction(q1, 10 ** 6) - Fraction(s1 * s1, 10 ** 6 * n1)) \
        / (n1 - 1) if n1 > 1 else Fraction(0)
    v2 = (Fraction(q2, 10 ** 6) - Fraction(s2 * s2, 10 ** 6 * n2)) \
        / (n2 - 1) if n2 > 1 else Fraction(0)
    vn1 = v1 / n1
    vn2 = v2 / n2
    denom = vn1 + vn2
    if denom == 0:
        return None, None
    t = (mp.mpf((m1 - m2).numerator) / (m1 - m2).denominator) \
        / mp.sqrt(mp.mpf(denom.numerator) / denom.denominator)
    df_den = (vn1 * vn1 / (n1 - 1) if n1 > 1 else Fraction(0)) \
        + (vn2 * vn2 / (n2 - 1) if n2 > 1 else Fraction(0))
    if df_den == 0:
        df = mp.mpf(1)
    else:
        fr = denom * denom / df_den
        df = mp.mpf(fr.numerator) / fr.denominator
    return t, df


def exact_ks_num(a, b):
    n1, n2 = len(a), len(b)
    sa, sb = sorted(a), sorted(b)
    import bisect
    best = 0
    for v in sa + sb:
        k = bisect.bisect_right(sa, v)
        m = bisect.bisect_right(sb, v)
        best = max(best, abs(k * n2 - m * n1))
    return best


# ---------------------------------------------------------------------------
# p-value definitions in mpmath
# ---------------------------------------------------------------------------

def norm_sf(z):
    return mp.erfc(z / mp.sqrt(2)) / 2


def t_sf_two_sided(t, df):
    # 2 * P(T > |t|) = I_{df/(df+t^2)}(df/2, 1/2), regularized
    x = df / (df + t * t)
    return mp.betainc(df / 2, mp.mpf(1) / 2, 0, x, regularized=True)


def kolmogorov_sf(x):
    if x <= 0:
        return mp.mpf(1)
    if x >= mp.mpf("0.7"):
        s = mp.nsum(lambda k: (-1) ** (k - 1) * mp.e ** (-2 * k * k * x * x),
                    [1, mp.inf])
        return 2 * s
    s = mp.nsum(
        lambda k: mp.e ** (-((2 * k - 1) ** 2) * mp.pi ** 2 / (8 * x * x)),
        [1, mp.inf])
    return 1 - mp.sqrt(2 * mp.pi) / x * s


def ks_p(d_frac, n1, n2):
    en = mp.sqrt(mp.mpf(n1 * n2) / (n1 + n2))
    d = mp.mpf(d_frac.numerator) / d_frac.denominator
    return kolmogorov_sf((en + mp.mpf("0.12") + mp.mpf("0.11") / en) * d)


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def make_cases():
    rng = np.random.default_rng(20260821)
    cases = []

    def add(name, a, b):
        cases.append((name, [int(x) for x in a], [int(x) for x in b]))

    # moderate normal samples (typical position)
    add("normal_50x50",
        np.rint(rng.normal(0, 1, 50) * 1000), np.rint(rng.normal(0, 1, 50) * 1000))
    # heavy ties: coarse grid
    add("heavy_ties",
        rng.choice(np.arange(-2000, 2001, 500), 40),
        rng.choice(np.arange(-2000, 2001, 500), 60))
    # tie-heavy AND shifted
    add("ties_shifted",
        rng.choice(np.arange(-2000, 2001, 500), 45),
        rng.choice(np.arange(-1000, 3001, 500), 55))
    # tiny n
    add("tiny_2x3", [100, 300], [200, 250, 900])
    add("tiny_5x5", np.rint(rng.normal(0, 1, 5) * 1000),
        np.rint(rng.normal(0, 1, 5) * 1000))
    # one group constant (ties within group; pooled not degenerate)
    add("const_group1", [500] * 20, np.rint(rng.normal(0, 1, 25) * 1000))
    # strong shift -> p underflow regimes
    add("underflow_200", np.rint(rng.normal(0, 1, 200) * 1000),
        np.rint(rng.normal(9, 1, 200) * 1000))
    add("underflow_60", np.rint(rng.normal(0, 1, 60) * 1000),
        np.rint(rng.normal(6, 1, 60) * 1000))
    # deep pools with ties (battery i32 bound region)
    add("deep_500", np.rint(rng.normal(0, 1, 500) * 100) * 10,
        np.rint(rng.normal(0.2, 1, 500) * 100) * 10)
    # small KS statistic (p ~ 1, the small-x theta-series branch)
    add("near_identical", np.rint(rng.normal(0, 1, 80) * 1000),
        np.rint(rng.normal(0, 1, 80) * 1000))
    # asymmetric sizes
    add("asym_8x120", np.rint(rng.normal(0, 1, 8) * 1000),
        np.rint(rng.normal(0.5, 1, 120) * 1000))
    return cases


def main():
    out = []
    for name, a, b in make_cases():
        n1, n2 = len(a), len(b)
        u_min, z, tie_sum = exact_mwu(a, b)
        t, df = exact_welch(a, b)
        num = exact_ks_num(a, b)
        d = Fraction(num, n1 * n2)
        rec = {
            "name": name,
            "a_milli": a,
            "b_milli": b,
            "stu": str(u_min),                     # exact rational
            "tie_sum": tie_sum,
            "ks_num": num,                          # exact integer
            "stks": str(d),                         # exact rational
            "pu": (mp.nstr(norm_sf(abs(z)), 30) if z is not None else None),
            "stt": (mp.nstr(t, 30) if t is not None else None),
            "df": (mp.nstr(df, 30) if t is not None else None),
            "pt": (mp.nstr(t_sf_two_sided(abs(t), df), 30)
                   if t is not None else None),
            "pks": mp.nstr(ks_p(d, n1, n2), 30),
        }
        out.append(rec)
    with open(OUT, "w") as f:
        json.dump({"provenance": __doc__.split("\n")[0],
                   "generator": "tools/make_scipy121_fixture.py",
                   "mpmath_dps": 60,
                   "cases": out}, f, indent=1)
    print(f"wrote {len(out)} cases -> {OUT}")


if __name__ == "__main__":
    main()
