#!/usr/bin/env python
"""Sharded-vs-union multi-host detect at scale (VERDICT r3 next-step #8).

Generates a corrected-FAST5 dataset of >=100M observations (reusing
tools/scale_run.py's vectorized generator at a reduced genome), then runs
the SAME detect twice with 2 real jax.distributed CPU processes:

  merge_mode='union'   — every observation allgathered to every host
  merge_mode='sharded' — observations routed once to range owners
                         (parallel/shardmerge.py)

and reports, per mode: wall clock, per-rank peak RSS, per-rank DCN payload
bytes (the sharded exchange records its routed off-host bytes in the
'dcn_route' metric; the union merge's traffic is pc x total observation
bytes by construction), and output equality.  Results go into README.md.

Run from the repo root:   python tools/scale_sharded.py [out_dir]
Env: SSH_GENOME (default 1_500_000), SSH_READS (default 18_000 per group),
     SSH_READ_LEN (default 3_000).
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GENOME_LEN = int(os.environ.get("SSH_GENOME", 1_500_000))
N_READS = int(os.environ.get("SSH_READS", 18_000))
READ_LEN = int(os.environ.get("SSH_READ_LEN", 3_000))

WORKER = r"""
import json, os, resource, sys
rank, nprocs, port, root, mode = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4], sys.argv[5])
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
from nanomod import use_compile_cache
use_compile_cache()
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{{port}}",
                           num_processes=nprocs, process_id=rank)
from nanomod.config import DetectConfig, RankConfig
from nanomod.detect import run_detect
cfg = DetectConfig(
    wrk_base1=os.path.join(root, "ctrl"),
    wrk_base2=os.path.join(root, "case"),
    out_folder=os.path.join(root, f"out_{{mode}}_r{{rank}}"
                            if mode == "union" else f"out_{{mode}}"),
    file_id="ss", min_lr=0, rank=RankConfig(window=10),
    tile_positions=16384, merge_mode=mode, out_level=1,
    metrics_file=os.path.join(root, f"metrics_{{mode}}_r{{rank}}.json"),
)
run_detect(cfg)
print(json.dumps({{"rank": rank, "mode": mode,
                  "rss_gb": resource.getrusage(
                      resource.RUSAGE_SELF).ru_maxrss / 1e6}}), flush=True)
"""


def run_mode(mode, root, port):
    script = WORKER.format(repo=REPO)
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), "2", str(port), root, mode],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=7200)[0] for p in procs]
    wall = time.time() - t0
    for p, o in zip(procs, outs):
        if p.returncode != 0:
            print(o[-4000:])
            raise SystemExit(f"{mode} worker failed rc={p.returncode}")
    rss = []
    for o in outs:
        for line in o.splitlines():
            if line.startswith("{"):
                rss.append(json.loads(line)["rss_gb"])
    dcn = []
    for r in range(2):
        mf = os.path.join(root, f"metrics_{mode}_r{r}.json")
        val = None
        if os.path.isfile(mf):
            with open(mf) as f:
                m = json.load(f)
            if "dcn_route" in m.get("stages", {}):
                val = int(m["stages"]["dcn_route"]["items"])
        dcn.append(val)
    return {"mode": mode, "wall_s": round(wall, 1),
            "rss_gb": [round(x, 2) for x in rss], "dcn_payload_bytes": dcn}


def main():
    from nanomod.harness.synth import scale_genome, write_corrected_group
    from tools import scale_run as sr

    root = sys.argv[1] if len(sys.argv) > 1 else "/tmp/nanomod_scale_sharded"
    os.makedirs(root, exist_ok=True)
    genome_arr, levels, planted = scale_genome(0, GENOME_LEN, 20)
    ctrl, case = os.path.join(root, "ctrl"), os.path.join(root, "case")
    t0 = time.time()
    if not os.path.isdir(ctrl):
        write_corrected_group(ctrl, sr.CHROM, genome_arr, levels,
                              np.random.default_rng(1), N_READS, READ_LEN)
        write_corrected_group(case, sr.CHROM, genome_arr, levels,
                              np.random.default_rng(2), N_READS, READ_LEN,
                              planted=planted)
    print(f"[gen] 2x{N_READS} reads x {READ_LEN} "
          f"({2 * N_READS * READ_LEN / 1e6:.0f}M observations) "
          f"in {time.time() - t0:.0f}s", flush=True)

    results = [run_mode("sharded", root, 29781),
               run_mode("union", root, 29782)]
    for res in results:
        print("[scale_sharded] " + json.dumps(res), flush=True)

    # output equality: sharded concatenation vs rank 0's union output
    with open(os.path.join(root, "out_sharded", "ss_sign_test.txt"),
              "rb") as f:
        sharded = f.read()
    with open(os.path.join(root, "out_union_r0", "ss_sign_test.txt"),
              "rb") as f:
        union = f.read()
    print(f"[scale_sharded] outputs byte-identical: {sharded == union} "
          f"({len(sharded)} bytes)", flush=True)
    with open(os.path.join(root, "scale_sharded_summary.json"), "w") as f:
        json.dump({"results": results, "identical": sharded == union,
                   "observations": 2 * N_READS * READ_LEN}, f, indent=2)


if __name__ == "__main__":
    main()
