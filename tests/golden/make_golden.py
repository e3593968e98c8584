#!/usr/bin/env python
"""Golden-fixture generator: an INDEPENDENT oracle for detect parity.

Produces `reads.npz` (a deterministic synthetic corrected-read dataset) and
golden `_sign_test.txt` / `_meanstd.cvs` files computed WITHOUT importing
any nanomod statistics code: the oracle re-implements the reference's
detect math (ref bin/scripts/myDetect.py) directly from scipy primitives
and the scipy-1.2.1 formulas the reference ran under:

  * accumulation + strand coordinate flip      myDetect.py:33-127
  * coverage filter                            myDetect.py:301-314
  * Mann-Whitney U, 1.2.1 defaults             scipy 1.2.1 mannwhitneyu
  * Welch t                                    scipy ttest_ind(equal_var=0)
  * KS D (exact integer numerator) + Stephens-corrected asymptotic p
                                               scipy 1.2.1 ks_2samp
  * capped repeated-subsample KS + quantile    myDetect.py:339-361
  * neighbor combination (fisher / weighted stouffer), pos_check,
    missing->1.0                               myDetect.py:366-414
  * float clamps m_min_float/m_max_float       myDetect.py:317-325
  * output formatting %.3f / %.3E, 1-based pos myDetect.py:522-545

The ONLY nanomod-coupled piece is the capped-KS subsample index stream
(jax.random fold_in keying — the reference used an unseeded global numpy
RNG, myDetect.py:351-354, so no implementation-independent stream exists);
everything computed FROM those indices is scipy.  The generator also
verifies the quantile-of-D monotonicity trick independently: the p-values
of the subsamples sorted ascending must equal the p-values of the integer
D numerators sorted descending.

Run from the repo root:  python tests/golden/make_golden.py
"""

import os
import sys

import numpy as np
import scipy.stats as ss

HERE = os.path.dirname(os.path.abspath(__file__))

FLOAT_MIN = sys.float_info.min
FLOAT_MAX = sys.float_info.max
MIN_COVERAGE = 5
NEIGHBOR_K = 2
WEIGHTS_DIF = 2.0


# ---------------------------------------------------------------------------
# dataset
# ---------------------------------------------------------------------------

def make_reads(path):
    """Two groups of fixed-length corrected reads over two chromosomes,
    both strands, 3-decimal values, a planted +1.2 shift at gA:150 in the
    case group, and a tie-heavy low-resolution window at gB:[50,90)."""
    rng = np.random.default_rng(20260818)
    genomes = {"gA": rng.choice(list("ACGT"), 300),
               "gB": rng.choice(list("ACGT"), 200)}
    L = 100
    recs = {"group1": [], "group2": []}
    for group in ("group1", "group2"):
        for chrom, g in genomes.items():
            glen = len(g)
            for strand in "+-":
                for _ in range(14):
                    start = int(rng.integers(0, glen - L + 1))
                    vals = rng.normal(0.0, 1.0, L)
                    # genomic position of event i
                    if strand == "+":
                        pos = start + np.arange(L)
                    else:
                        pos = start + L - 1 - np.arange(L)
                    if chrom == "gB":
                        coarse = (pos >= 50) & (pos < 90)
                        vals[coarse] = np.round(vals[coarse], 1)
                    if group == "group2" and chrom == "gA":
                        vals[pos == 150] += 1.2
                    bases = g[pos]
                    recs[group].append((chrom, strand, start,
                                        np.round(vals, 3), bases))
    out = {}
    for group, rs in recs.items():
        out[f"{group}_chrom"] = np.array([r[0] for r in rs])
        out[f"{group}_strand"] = np.array([r[1] for r in rs])
        out[f"{group}_start"] = np.array([r[2] for r in rs], np.int64)
        out[f"{group}_vals"] = np.array([r[3] for r in rs], np.float32)
        out[f"{group}_bases"] = np.array([r[4] for r in rs]).astype("S1")
    np.savez_compressed(path, **out)
    return out


def load_reads(path):
    z = np.load(path)
    groups = []
    for group in ("group1", "group2"):
        rs = []
        for i in range(len(z[f"{group}_chrom"])):
            rs.append((str(z[f"{group}_chrom"][i]),
                       str(z[f"{group}_strand"][i]),
                       int(z[f"{group}_start"][i]),
                       z[f"{group}_vals"][i],
                       z[f"{group}_bases"][i]))
        groups.append(rs)
    return groups


# ---------------------------------------------------------------------------
# oracle: accumulation (myDetect.py:33-127) + coverage filter (:301-314)
# ---------------------------------------------------------------------------

def accumulate(reads):
    vals = {}
    bases = {}
    for chrom, strand, start, v, b in reads:
        key = (chrom, strand)
        vals.setdefault(key, {})
        bases.setdefault(key, {})
        n = len(v)
        for i in range(n):
            pos = start + i if strand == "+" else start + n - 1 - i
            vals[key].setdefault(pos, []).append(float(v[i]))
            bases[key][pos] = b[i].decode()
    return vals, bases


def coverage_filter(vals, min_cov=MIN_COVERAGE):
    out = {}
    for key, d in vals.items():
        kept = {p: v for p, v in d.items() if len(v) >= min_cov}
        if kept:
            out[key] = kept
    return out


# ---------------------------------------------------------------------------
# oracle: the statistical tests (scipy 1.2.1 semantics)
# ---------------------------------------------------------------------------

def ks_numerator(a, b):
    """Exact integer KS numerator: D = max|k*n2 - m*n1| / (n1*n2)."""
    n1, n2 = len(a), len(b)
    z = np.concatenate([a, b])
    k = np.searchsorted(np.sort(a), z, side="right")
    m = np.searchsorted(np.sort(b), z, side="right")
    return int(np.abs(k * n2 - m * n1).max()), n1, n2


def ks_p_121(d, n1, n2):
    """scipy 1.2.1 ks_2samp p: Stephens-corrected kstwobign tail."""
    en = np.sqrt(n1 * n2 / (n1 + n2))
    p = ss.distributions.kstwobign.sf((en + 0.12 + 0.11 / en) * d)
    return p if np.isfinite(p) else 1.0


def mwu_121(a, b):
    """scipy 1.2.1 mannwhitneyu defaults: u = min(u1,u2), z from max with
    continuity correction and tie-corrected sd, p = norm.sf(|z|)."""
    n1, n2 = len(a), len(b)
    ranked = ss.rankdata(np.concatenate([a, b]))
    r1 = ranked[:n1].sum()
    u1 = n1 * n2 + n1 * (n1 + 1.0) / 2.0 - r1
    u2 = n1 * n2 - u1
    t_corr = ss.tiecorrect(ranked)
    assert t_corr > 0, "degenerate pool: scipy 1.2.1 raised ValueError here"
    sd = np.sqrt(t_corr * n1 * n2 * (n1 + n2 + 1.0) / 12.0)
    meanrank = n1 * n2 / 2.0 + 0.5
    z = (max(u1, u2) - meanrank) / sd
    return min(u1, u2), ss.distributions.norm.sf(abs(z))


def capped_ks(a, b, row_index, cov, repeats, quantile, seed):
    """myDetect.py:345-361: repeat KS on `repeats` subsamples of size cov
    (with replacement) and keep the p at sorted index int(repeats*quantile).

    Index draws replicate kernels.capped_ks_d's per-absolute-row fold_in
    stream (see module docstring); all statistics from them are scipy.
    """
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.random as jr

    n1, n2 = len(a), len(b)
    k1, k2 = jr.split(jr.fold_in(jr.PRNGKey(seed), row_index))
    i1 = np.asarray(jr.randint(k1, (repeats, cov), 0, max(n1, 1)))
    i2 = np.asarray(jr.randint(k2, (repeats, cov), 0, max(n2, 1)))
    ne1, ne2 = min(n1, cov), min(n2, cov)
    nums, ps = [], []
    for r in range(repeats):
        aa = a[i1[r]] if n1 > cov else a
        bb = b[i2[r]] if n2 > cov else b
        num, _, _ = ks_numerator(aa, bb)
        d = num / float(ne1 * ne2)
        nums.append(num)
        ps.append(ks_p_121(d, ne1, ne2))
    # independent check of the quantile-of-D monotonicity trick
    by_p = np.sort(ps)
    by_num = np.array(ps)[np.argsort(-np.array(nums), kind="stable")]
    assert np.array_equal(by_p, by_num), "p not monotone in D?!"
    q_idx = int(repeats * quantile)
    num_sel = -np.sort(-np.array(nums))[q_idx]
    d_sel = num_sel / float(ne1 * ne2)
    return d_sel, ks_p_121(d_sel, ne1, ne2), ne1, ne2


def exact_mean_std(x):
    """Mean and population std in the EXACT 3-decimal domain: integer
    Σ/Σx² over milli values, finalized in f64.  The pairwise-summation
    np.mean lands on the wrong side of `%.3f` half-boundaries (a mean of
    3-decimal values is often exactly x.xxx5); the decimal-exact value is
    order-independent and is what the engine reports (documented
    divergence from the reference's np.mean, DIVERGENCES.md)."""
    m = np.rint(np.asarray(x) * 1000.0).astype(np.int64)
    s = float(m.sum())
    sq = float((m.astype(object) ** 2).sum())   # exact int -> f64 once
    n = float(len(m))
    mean = s / (1e3 * n)
    ss = (sq - s * s / n) / 1e6
    return mean, np.sqrt(max(ss, 0.0) / n)


def clamp_p(p):
    return FLOAT_MIN if p < FLOAT_MIN else p


def clamp_stat(s):
    return FLOAT_MAX if s > FLOAT_MAX else s


# ---------------------------------------------------------------------------
# oracle: one detect variant end-to-end
# ---------------------------------------------------------------------------

def stouffer_weights(k, dif):
    w = [100.0]
    for _ in range(k):
        w.insert(0, w[0] / dif)
        w.append(w[-1] / dif)
    return np.asarray(w)


def run_variant(reads1, reads2, *, test_method="stouffer", neighbor=NEIGHBOR_K,
                coverages=(0, 0), downsampling=20, quantile=0.25, seed=0,
                mstd=False):
    v1, b1 = accumulate(reads1)
    v2, b2 = accumulate(reads2)
    v1 = coverage_filter(v1)
    v2 = coverage_filter(v2)

    rows = []          # (key, pos, base, n1, n2, stu, pu, stt, pt, stks, pks)
    mstd_rows = []
    for key in sorted(set(v1) & set(v2)):
        cov = coverages[0 if key[1] == "+" else 1]
        common = sorted(set(v1[key]) & set(v2[key]))
        for row_i, pos in enumerate(common):
            # canonical per-position order (ascending values): the engine's
            # pools store each position's reservoir sorted so results are
            # invariant to file order / host sharding (accum/pools.py
            # pack_observations); the capped-KS subsample draws index into
            # that canonical order
            a = np.sort(np.asarray(v1[key][pos], np.float64))
            b = np.sort(np.asarray(v2[key][pos], np.float64))
            stu, pu = mwu_121(a, b)
            t = ss.ttest_ind(a, b, equal_var=False)
            if cov > 0 and (len(a) > cov or len(b) > cov):
                stks, pks, _, _ = capped_ks(a, b, row_i, cov, downsampling,
                                            quantile, seed)
            else:
                num, n1, n2 = ks_numerator(a, b)
                stks = num / (float(n1) * float(n2))
                pks = ks_p_121(stks, n1, n2)
            rows.append([key, pos, b2[key][pos], len(a), len(b),
                         clamp_stat(stu), clamp_p(pu),
                         clamp_stat(t.statistic), clamp_p(t.pvalue),
                         clamp_stat(stks), clamp_p(pks)])
            if mstd:
                m1, s1 = exact_mean_std(a)
                m2, s2 = exact_mean_std(b)
                mstd_rows.append([key, pos, b2[key][pos], m1, s1, m2, s2])

    lines = []
    w = stouffer_weights(neighbor, WEIGHTS_DIF)
    for i, row in enumerate(rows):
        key, pos, base, n1, n2, stu, pu, stt, pt, stks, pks = row
        line = "%s %s %d %s %d %d %.3f %.3E %.3f %.3E %.3f %.3E" % (
            key[0], key[1], pos + 1, base, n1, n2, stu, pu, stt, pt,
            stks, pks)
        # ref myDetect.py:531-536: the 4th column pair is written only when
        # neighborPvalues > 0 (the nb=0 KS-copy tuple, myDetect.py:413, is an
        # internal rank key only and never reaches the file)
        if test_method != "ks" and neighbor > 0:
            window = []
            for off in range(-neighbor, neighbor + 1):
                j = i + off
                ok = (0 <= j < len(rows) and rows[j][0] == key
                      and rows[j][1] - pos == off)
                window.append(rows[j][10] if ok else 1.0)
            if test_method == "fisher":
                stc, pc = ss.combine_pvalues(window, method="fisher")
            else:
                stc, pc = ss.combine_pvalues(window, method="stouffer",
                                             weights=w)
            stc, pc = clamp_stat(stc), clamp_p(pc)
            line += " %.3f %.3E" % (stc, pc)
        lines.append(line + "\n")

    mlines = ["%s %s %d %s %.3f %.3f %.3f %.3f\n" % (
        key[0], key[1], pos, base, m1, s1, m2, s2)
        for key, pos, base, m1, s1, m2, s2 in mstd_rows]
    return "".join(lines), "".join(mlines)


VARIANTS = {
    "stouffer": dict(test_method="stouffer"),
    "fisher": dict(test_method="fisher"),
    "ks": dict(test_method="ks"),
    "nb0": dict(test_method="stouffer", neighbor=0),
    "capped": dict(test_method="stouffer", coverages=(8, 8),
                   downsampling=20, quantile=0.25, seed=0, mstd=True),
}


def main():
    reads_path = os.path.join(HERE, "reads.npz")
    make_reads(reads_path)
    reads1, reads2 = load_reads(reads_path)
    for name, kw in VARIANTS.items():
        text, mtext = run_variant(reads1, reads2, **kw)
        with open(os.path.join(HERE, f"golden_{name}_sign_test.txt"), "w") as f:
            f.write(text)
        if kw.get("mstd"):
            with open(os.path.join(HERE, f"golden_{name}_meanstd.cvs"), "w") as f:
                f.write(mtext)
        print(f"{name}: {text.count(chr(10))} rows")


if __name__ == "__main__":
    main()
