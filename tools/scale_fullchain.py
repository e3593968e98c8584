#!/usr/bin/env python
"""Full-chain scale run: raw FAST5 -> Annotate -> detect — the whole
pipeline the reference runs: Annotate's FAST5 write-back feeding detect's
ingest (ref myRefBaseSignalAnnotation.py:689-749 -> myDetect.py:547-633).

Generates two groups of RAW basecalled FAST5s (harness/synth.py:
albacore2-style event tables + DAC signal), with 20 modified sites
planted as pA-level shifts in the case group, then runs:

    Annotate (ingest -> events -> MAD normalize -> seed -> banded DP ->
              indel correction -> FAST5 write-back)          x 2 groups
    detect   (corrected ingest -> pools -> battery -> combine -> rank)

and reports per-stage wall, reads/s, positions/s, and planted-site
recall in the top-50.

    python tools/scale_fullchain.py [out_root]
Env: FC_GENOME (4.6M), FC_READS (12000/group), FC_READ_LEN (3000),
FC_ERR (0.03), FC_DELTA_PA (6), SCALE_CPU=1 to force jax CPU.
"""

import json
import os
import resource
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GENOME_LEN = int(os.environ.get("FC_GENOME", 4_600_000))
N_READS = int(os.environ.get("FC_READS", 12_000))
READ_LEN = int(os.environ.get("FC_READ_LEN", 3_000))
ERR = float(os.environ.get("FC_ERR", 0.03))
DELTA_PA = float(os.environ.get("FC_DELTA_PA", 6.0))
N_SITES = 20
CHROM = "ecoli_syn"


def rss_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def main():
    import jax
    if os.environ.get("SCALE_CPU"):
        jax.config.update("jax_platforms", "cpu")
    from nanomod import use_compile_cache
    use_compile_cache()

    from nanomod.config import AnnotateConfig, DetectConfig, RankConfig
    from nanomod.detect import run_detect
    from nanomod.io.fasta import FastaIndex
    from nanomod.resquiggle import annotate_files
    from nanomod.io.fast5 import iter_fast5_files
    from nanomod.harness.synth import scale_genome, write_raw_group
    from nanomod.resquiggle.seed import SeedIndex

    root = sys.argv[1] if len(sys.argv) > 1 else "/tmp/nanomod_fullchain"
    os.makedirs(root, exist_ok=True)
    genome_u8, _, planted = scale_genome(0, GENOME_LEN, N_SITES)

    fasta_p = os.path.join(root, "ref.fa")
    if not os.path.isfile(fasta_p):
        with open(fasta_p, "w") as f:
            f.write(f">{CHROM}\n")
            g = genome_u8.tobytes().decode()
            for lo in range(0, GENOME_LEN, 80):
                f.write(g[lo: lo + 80] + "\n")

    summary = {"genome_len": GENOME_LEN, "reads_per_group": N_READS,
               "read_len": READ_LEN, "error_rate": ERR,
               "delta_pa": DELTA_PA}
    ctrl, case = os.path.join(root, "ctrl"), os.path.join(root, "case")
    t0 = time.time()
    if not os.path.isdir(ctrl):
        write_raw_group(ctrl, genome_u8, np.random.default_rng(1), N_READS,
                        READ_LEN, error_rate=ERR)
        write_raw_group(case, genome_u8, np.random.default_rng(2), N_READS,
                        READ_LEN, planted=planted, mod_delta_pa=DELTA_PA,
                        error_rate=ERR)
        summary["generated"] = [N_READS, N_READS]
    summary["gen_wall_s"] = round(time.time() - t0, 1)
    print("[fullchain] gen: " + json.dumps(summary), flush=True)

    fasta = FastaIndex(fasta_p)
    acfg = AnnotateConfig(wrk_base1=ctrl, ref_fasta=fasta_p, out_level=2)
    sidx = SeedIndex(fasta.seqs, k=acfg.seed_k)
    for name, folder in (("annotate_ctrl", ctrl), ("annotate_case", case)):
        paths = list(iter_fast5_files(folder, recursive=True))
        t0 = time.time()
        n_ok, errors, _ = annotate_files(paths, acfg, fasta, sidx)
        dt = time.time() - t0
        summary[name] = {
            "reads": len(paths), "annotated": n_ok,
            "wall_s": round(dt, 1), "reads_per_s": round(n_ok / dt, 1),
            "errors": {k: len(v) for k, v in errors.items()},
        }
        print(f"[fullchain] {name}: " + json.dumps(summary[name]),
              flush=True)

    dcfg = DetectConfig(
        wrk_base1=ctrl, wrk_base2=case,
        out_folder=os.path.join(root, "out"), file_id="fullchain",
        min_lr=500, rank=RankConfig(window=10), out_level=2,
        metrics_file=os.path.join(root, "out", "metrics.json"))
    t0 = time.time()
    table, order, sites = run_detect(dcfg)
    dt = time.time() - t0
    top = np.array([s.pos for s in sites[:50] if s.chrom == CHROM],
                   np.int64)
    found = (sum(1 for p in planted if len(top) and np.abs(top - p).min() <= 4)
             if len(top) else 0)
    summary["detect"] = {
        "positions_tested": int(len(table)),
        "wall_s": round(dt, 1),
        "positions_per_s": round(len(table) / dt, 1),
        "planted_in_top50": f"{found}/{N_SITES}",
    }
    summary["peak_rss_gb"] = round(rss_gb(), 2)
    print("[fullchain] " + json.dumps(summary), flush=True)
    with open(os.path.join(root, "fullchain_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
