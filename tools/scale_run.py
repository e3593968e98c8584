#!/usr/bin/env python
"""E. coli-scale end-to-end detect run.

Generates a synthetic 4.6 Mb genome and two groups of corrected-FAST5 reads
(default 35k x 3 kb per group, ~11x coverage per strand — override with
SCALE_READS / SCALE_READ_LEN / SCALE_GENOME), plants 20 modified sites in
the case group, then measures the PRODUCT path end to end:

    ingest (native C++ FAST5 parse) -> pools -> full battery -> neighbor
    combination -> ranking -> _sign_test.txt

reporting wall-clock per phase, peak RSS, and whether every planted site
ranks in the top-50.

Run from the repo root:   python tools/scale_run.py [out_dir]
Delete the out_dir afterwards (it holds ~1-3 GB of FAST5s).
"""

import json
import os
import resource
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nanomod.config import DetectConfig, RankConfig  # noqa: E402
from nanomod.detect import run_detect  # noqa: E402
from nanomod.harness.synth import (scale_genome,  # noqa: E402
                                   write_corrected_group)

GENOME_LEN = int(os.environ.get("SCALE_GENOME", 4_600_000))
N_READS = int(os.environ.get("SCALE_READS", 35_000))
READ_LEN = int(os.environ.get("SCALE_READ_LEN", 3_000))
N_SITES = 20
MOD_DELTA = 1.5
CHROM = "ecoli_syn"


def rss_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def main():
    import nanomod
    # tune BEFORE generation: the dataset-writing phase churns GB-sized
    # buffers, and a warm arena is what keeps the detect-phase pool build
    # at full speed
    nanomod.tune_malloc()
    nanomod.use_compile_cache()
    root = sys.argv[1] if len(sys.argv) > 1 else "/tmp/nanomod_scale"
    os.makedirs(root, exist_ok=True)
    genome_arr, levels, planted = scale_genome(0, GENOME_LEN, N_SITES)

    t0 = time.time()
    ctrl, case = os.path.join(root, "ctrl"), os.path.join(root, "case")
    if not os.path.isdir(ctrl):
        write_corrected_group(ctrl, CHROM, genome_arr, levels,
                              np.random.default_rng(1), N_READS, READ_LEN)
        write_corrected_group(case, CHROM, genome_arr, levels,
                              np.random.default_rng(2), N_READS, READ_LEN,
                              planted=planted, mod_delta=MOD_DELTA)
    t_gen = time.time() - t0
    print(f"[scale] generated 2x{N_READS} reads x {READ_LEN} bases "
          f"({2 * N_READS * READ_LEN / 1e6:.0f}M events) in {t_gen:.0f}s, "
          f"rss {rss_gb():.1f} GB", flush=True)

    cfg = DetectConfig(
        wrk_base1=ctrl, wrk_base2=case,
        out_folder=os.path.join(root, "out"), file_id="scale",
        min_lr=0, rank=RankConfig(window=10),
        tile_positions=int(os.environ.get("SCALE_TILE", 16384)),
        pool_capacity=int(os.environ.get("SCALE_POOL_CAP", 0)),
        metrics_file=os.path.join(root, "out", "metrics.json"),
        out_level=1,
    )
    t0 = time.time()
    table, order, sites = run_detect(cfg)
    t_detect = time.time() - t0

    top50 = {(s.chrom, s.pos) for s in sites[:50]}
    found = sum(1 for p in planted if (CHROM, p) in top50)
    summary = {
        "genome_len": GENOME_LEN,
        "reads_per_group": N_READS,
        "positions_tested": int(len(table)),
        "detect_wall_s": round(t_detect, 1),
        "positions_per_s": round(len(table) / t_detect, 1),
        "peak_rss_gb": round(rss_gb(), 2),
        "planted_in_top50": f"{found}/{N_SITES}",
    }
    print("[scale] " + json.dumps(summary), flush=True)
    with open(os.path.join(root, "out", "scale_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)


if __name__ == "__main__":
    main()
