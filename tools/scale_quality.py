#!/usr/bin/env python
"""Multi-seed, manifest-pinned detection quality at E. coli scale.

For each seed: generate a 4.6 Mb genome + two groups of corrected reads
with 20 planted modified sites (harness/synth.py — the planted
sites and genome derive ONLY from the seed), then run detect in four
modes and record planted-site recall in the top-50:

    stouffer   — the reference default (weighted Stouffer combination)
    fisher     — Fisher combination (ref myDetect.py:392-393)
    capped     — per-strand coverage cap + repeated-subsample KS
                 (ref myDetect.py:339-361)
    region     — RegionRankbyST window ranking (ref myDetect.py:463-516)

The manifest (seed -> genome sha256, planted positions) is written next
to this script and committed, so the claim is reproducible:
    python tools/scale_quality.py [out_root] [seeds...]
Defaults: /tmp/nanomod_squality, seeds 0 1 2.  Each seed's dataset is
deleted after its runs (they are ~2 GB each).
"""

import hashlib
import json
import os
import shutil
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from nanomod.config import DetectConfig, RankConfig, StatConfig  # noqa: E402
from nanomod.detect import run_detect  # noqa: E402
from nanomod.harness.synth import (scale_genome,  # noqa: E402
                                   write_corrected_group)
from scale_run import CHROM  # noqa: E402

GENOME_LEN = int(os.environ.get("SCALE_GENOME", 4_600_000))
N_READS = int(os.environ.get("SCALE_READS", 35_000))
READ_LEN = int(os.environ.get("SCALE_READ_LEN", 3_000))
N_SITES = 20
MANIFEST = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scale_manifest.json")


def dataset_for_seed(root, seed):
    genome_arr, levels, planted = scale_genome(seed, GENOME_LEN, N_SITES)
    ctrl = os.path.join(root, f"s{seed}_ctrl")
    case = os.path.join(root, f"s{seed}_case")
    write_corrected_group(ctrl, CHROM, genome_arr, levels,
                          np.random.default_rng(seed * 10 + 1),
                          N_READS, READ_LEN)
    write_corrected_group(case, CHROM, genome_arr, levels,
                          np.random.default_rng(seed * 10 + 2),
                          N_READS, READ_LEN, planted=planted)
    digest = hashlib.sha256(genome_arr.tobytes()).hexdigest()
    return ctrl, case, planted, digest


MODES = {
    "stouffer": dict(stats=StatConfig(test_method="stouffer")),
    "fisher": dict(stats=StatConfig(test_method="fisher")),
    "capped": dict(stats=StatConfig(test_method="stouffer",
                                    coverages=(10, 10), downsampling=100)),
    "region": dict(stats=StatConfig(test_method="stouffer"),
                   rank=RankConfig(window=10, region_rank_by_st=True,
                                   percentile=0.1)),
}


def recall(sites, planted, close, top_n=50):
    """Planted sites with a top-`top_n` site within `close` positions —
    the reference's own tolerance semantics (getTopRank dedup window,
    ref mySimulate.py:287-328: 2*neighborPvalues for site ranking, the
    region window for RegionRankbyST)."""
    top = np.array([s.pos for s in sites[:top_n] if s.chrom == CHROM],
                   dtype=np.int64)
    if len(top) == 0:
        return 0
    return sum(1 for p in planted if np.abs(top - p).min() <= close)


def main():
    import jax
    if os.environ.get("SCALE_CPU"):
        # recall is hardware-independent (the capped-KS subsample stream
        # is platform-invariant stateless jax.random)
        jax.config.update("jax_platforms", "cpu")
    from nanomod import use_compile_cache
    use_compile_cache()
    root = sys.argv[1] if len(sys.argv) > 1 else "/tmp/nanomod_squality"
    seeds = [int(s) for s in sys.argv[2:]] or [0, 1, 2]
    os.makedirs(root, exist_ok=True)
    manifest = {"genome_len": GENOME_LEN, "reads_per_group": N_READS,
                "read_len": READ_LEN, "n_sites": N_SITES,
                "generator": "tools/scale_quality.py", "seeds": {}}
    results = {}
    for seed in seeds:
        t0 = time.time()
        ctrl, case, planted, digest = dataset_for_seed(root, seed)
        print(f"[squality] seed {seed}: generated in {time.time()-t0:.0f}s",
              flush=True)
        manifest["seeds"][str(seed)] = {
            "genome_sha256": digest, "planted": planted}
        results[seed] = {}
        for mode, kw in MODES.items():
            cfg = DetectConfig(
                wrk_base1=ctrl, wrk_base2=case,
                out_folder=os.path.join(root, "out"),
                file_id=f"s{seed}_{mode}", min_lr=0,
                rank=kw.get("rank", RankConfig(window=10)),
                stats=kw["stats"], save_test=False, out_level=2,
            )
            t0 = time.time()
            table, order, sites = run_detect(cfg)
            close = (cfg.rank.window + 1 if cfg.rank.region_rank_by_st
                     else 2 * cfg.stats.neighbor_pvalues)
            r = recall(sites, planted, close)
            results[seed][mode] = {
                "recall_top50": f"{r}/{N_SITES}",
                "wall_s": round(time.time() - t0, 1),
            }
            print(f"[squality] seed {seed} {mode}: "
                  f"{json.dumps(results[seed][mode])}", flush=True)
        shutil.rmtree(ctrl)
        shutil.rmtree(case)
    with open(MANIFEST, "w") as f:
        json.dump(manifest, f, indent=1)
    out = os.path.join(root, "quality_summary.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    print("[squality] " + json.dumps(results))
    print(f"[squality] manifest -> {MANIFEST}")


if __name__ == "__main__":
    main()
