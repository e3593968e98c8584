#!/usr/bin/env python
"""Benchmark: detect battery throughput (primary) + Annotate resquiggle
throughput (secondary), in ONE JSON line, on an NVIDIA GPU.

Primary workload: the detect hot path at E. coli scale — P genome positions
with ~C-deep signal pools per group, full KS + Mann-Whitney U + Welch-t
battery plus weighted-Stouffer neighbor combination and ranking.  Baseline:
the reference's per-position scipy loop (ref bin/scripts/myDetect.py:416-438,
single-threaded), measured on a sample each run and extrapolated.

Secondary workload (the reference's HEAVIEST phase, SURVEY.md §3.1): the
full Annotate pipeline — HDF5 ingest, event extraction, normalization,
seeding, banded-DP alignment, native indel correction, FAST5 write-back —
on synthetic 2 kb raw reads with 3% basecall errors.  Baseline: the FIXED
reference-equivalent rate recorded in BASELINE.md (5.5 reads/s/core,
override with NANOMOD_REF_ANNOTATE_RATE); set BENCH_SKIP_ANNOTATE=1 to
skip it.

All datasets are regenerated from FIXED seeds (battery: rng(0); annotate:
genome seed 1 / reads seed 2; e2e: seeds 11/1/2) so every round measures
the identical workload, and each metric reports the MEDIAN of N timed runs
with min/max dispersion.

Prints ONE JSON line:
  {"metric", "value", "unit", "vs_baseline", "dispersion", "device",
   "secondary": {...annotate...}, "e2e": {...detect pipeline...}}
where "device" names the JAX platform, device kind and count and the
card's name and power limit.  Exits non-zero without a GPU.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def bench_ours(values1, counts1, values2, counts2, positions, repeat=5):
    """Median-of-`repeat` battery throughput on the PRODUCTION path
    (stats/battery.battery_backend).  Returns (median sites/s, dispersion
    dict, backend)."""
    from nanomod.stats.battery import battery_backend, run_battery
    from nanomod.stats.combine import combine_neighbor_pvalues
    from nanomod.config import StatConfig

    cfg = StatConfig()
    gid = np.zeros(len(positions), dtype=np.int64)
    tile = 16384
    backend = battery_backend()

    def once():
        res = run_battery(values1, counts1, values2, counts2,
                          cfg=cfg, tile_positions=tile)
        stc, pc = combine_neighbor_pvalues(gid, positions, res.pks, cfg)
        order = np.lexsort((res.pu, res.pks, pc))
        return order[0]

    once()  # warmup/compile
    rates = []
    for _ in range(repeat):
        t0 = time.time()
        once()
        rates.append(len(positions) / (time.time() - t0))
    rates.sort()
    disp = {"min": round(rates[0], 1), "max": round(rates[-1], 1),
            "n": repeat}
    return float(np.median(rates)), disp, backend


def bench_reference_equiv(values1, counts1, values2, counts2, sample=300):
    """Reference-equivalent cost: per-position scipy calls in a Python loop
    (the reference's exact structure, myDetect.py:430-436)."""
    from scipy.stats import mannwhitneyu, ttest_ind, ks_2samp
    n = min(sample, len(counts1))
    t0 = time.time()
    for i in range(n):
        a = values1[i, : counts1[i]].astype(np.float64)
        b = values2[i, : counts2[i]].astype(np.float64)
        try:
            mannwhitneyu(a, b)
        except ValueError:
            pass
        ttest_ind(a, b, equal_var=False)
        ks_2samp(a, b, method="asymp")
    dt = time.time() - t0
    return n / dt


def bench_annotate():
    """Full Annotate pipeline throughput (reads resquiggled/s) on a
    synthetic raw dataset."""
    import tempfile
    import numpy as np

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "tests"))
    from fixtures import make_genome, make_raw_dataset
    from nanomod.config import AnnotateConfig
    from nanomod.io.fasta import FastaIndex
    from nanomod.resquiggle import annotate_files
    from nanomod.resquiggle.seed import SeedIndex

    n_reads = int(os.environ.get("BENCH_READS", 512))
    read_len = int(os.environ.get("BENCH_READ_LEN", 2000))

    root = tempfile.mkdtemp()
    chrom, genome = make_genome(length=read_len + 500, seed=1)
    fasta_p = os.path.join(root, "ref.fa")
    with open(fasta_p, "w") as f:
        f.write(f">{chrom}\n{genome}\n")
    reads_dir = os.path.join(root, "reads")
    make_raw_dataset(reads_dir, chrom, genome, n_reads=n_reads, seed=2,
                     read_len=read_len, error_rate=0.03)
    paths = sorted(os.path.join(reads_dir, f) for f in os.listdir(reads_dir))

    cfg = AnnotateConfig(wrk_base1=reads_dir, ref_fasta=fasta_p)
    fasta = FastaIndex(fasta_p)
    sidx = SeedIndex(fasta.seqs, k=cfg.seed_k)

    from nanomod.utils.observe import observer

    annotate_files(paths, cfg, fasta, sidx)      # warmup/compile
    repeat = int(os.environ.get("BENCH_ANNOTATE_REPEAT", 3))
    rates = []
    stages = {}
    for _ in range(repeat):
        observer().reset()
        t0 = time.time()
        n_ok, _, _ = annotate_files(paths, cfg, fasta, sidx)
        rates.append(n_ok / (time.time() - t0))
        stages = {name: d["seconds"]
                  for name, d in observer().snapshot().items()}
    rates.sort()
    rate = float(np.median(rates))
    ref_rate = float(os.environ.get("NANOMOD_REF_ANNOTATE_RATE", 5.5))
    return {"metric": "reads_resquiggled_per_sec", "value": round(rate, 1),
            "unit": "reads/s", "vs_baseline": round(rate / ref_rate, 2),
            # the reference's practical operating point: 12 worker
            # processes/node (ref myRefBaseSignalAnnotation.py:1452-1483)
            # ~= 12 x 5.5 reads/s
            "vs_ref_12thread": round(rate / (12 * ref_rate), 2),
            "dispersion": {"min": round(rates[0], 1),
                           "max": round(rates[-1], 1), "n": repeat},
            "stage_seconds": stages}


def bench_e2e_detect():
    """End-to-end detect (FAST5 ingest -> pools -> battery -> combine ->
    rank -> save) on a pinned corrected-fixture dataset; positions/s of
    wall clock.  Covers the host stages the battery metric does not."""
    import tempfile

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "tests"))
    from fixtures import make_genome, make_corrected_dataset
    from nanomod.config import DetectConfig
    from nanomod.detect import run_detect

    n_reads = int(os.environ.get("BENCH_E2E_READS", 120))
    glen = int(os.environ.get("BENCH_E2E_GENOME", 4000))
    root = tempfile.mkdtemp()
    chrom, genome = make_genome(length=glen, seed=11)
    d1 = os.path.join(root, "g1")
    d2 = os.path.join(root, "g2")
    make_corrected_dataset(d1, chrom, genome, n_reads=n_reads, seed=1)
    make_corrected_dataset(d2, chrom, genome, n_reads=n_reads, seed=2,
                           mod_pos=glen // 3, mod_delta=1.5)
    cfg = DetectConfig(wrk_base1=d1, wrk_base2=d2,
                       out_folder=os.path.join(root, "out"),
                       file_id="bench", min_lr=0, out_level=3)
    table, order, sites = run_detect(cfg)          # warmup/compile
    repeat = int(os.environ.get("BENCH_E2E_REPEAT", 3))
    rates = []
    for _ in range(repeat):
        t0 = time.time()
        table, order, sites = run_detect(cfg)
        rates.append(len(table) / (time.time() - t0))
    rates.sort()
    return {"metric": "e2e_detect_positions_per_sec",
            "value": round(float(np.median(rates)), 1), "unit": "positions/s",
            "top_site_pos": int(sites[0].pos) if len(sites) else -1,
            "dispersion": {"min": round(rates[0], 1),
                           "max": round(rates[-1], 1), "n": repeat}}


def device_line():
    """The device every number was measured on; exits without a GPU."""
    import subprocess

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"bench.py: no GPU (JAX platform {devs[0].platform!r})")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0]
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "count": len(devs), "card": card.strip()}


def main():
    from nanomod import use_compile_cache

    device = device_line()
    use_compile_cache()

    if os.environ.get("BENCH_ONLY_ANNOTATE"):
        print(json.dumps({"device": device, "secondary": bench_annotate()}))
        return

    p_total = int(os.environ.get("BENCH_POSITIONS", 200_000))
    cov = int(os.environ.get("BENCH_COVERAGE", 50))
    rng = np.random.default_rng(0)
    c_max = cov + 14
    counts1 = rng.integers(cov - 10, c_max, p_total).astype(np.int32)
    counts2 = rng.integers(cov - 10, c_max, p_total).astype(np.int32)
    values1 = np.round(rng.normal(0, 1, (p_total, c_max)), 3).astype(np.float32)
    values2 = np.round(rng.normal(0, 1, (p_total, c_max)), 3).astype(np.float32)
    positions = np.arange(p_total, dtype=np.int64)

    ours, disp, backend = bench_ours(values1, counts1, values2, counts2,
                                     positions)
    ref = bench_reference_equiv(values1, counts1, values2, counts2)

    line = {
        "metric": "sites_tested_per_sec",
        "value": round(ours, 1),
        "unit": "sites/s",
        "vs_baseline": round(ours / ref, 2),
        "dispersion": disp,
        "battery_backend": backend,
        "device": device,
    }
    if not os.environ.get("BENCH_SKIP_ANNOTATE"):
        line["secondary"] = bench_annotate()
    if not os.environ.get("BENCH_SKIP_E2E"):
        line["e2e"] = bench_e2e_detect()
    print(json.dumps(line))


if __name__ == "__main__":
    main()
