"""Worker for tests/test_multihost_real.py: one real jax.distributed
process of an N-process CPU cluster.

Modes:
  detect   — full multi-host detect (host-sharded ingest -> DCN pool merge
             -> battery -> sign_test); parent asserts each rank's
             out_r<rank>/mh_sign_test.txt byte-matches single-process.
  annotate — host-sharded Annotate (each rank resquiggles its round-robin
             file shard in place + merged stats report); parent asserts
             the corrected FAST5 contents match the single-process run.

Usage: python _multihost_worker.py <mode> <rank> <nprocs> <port> <root>
"""

import os
import sys


def main():
    mode, rank, nprocs, port, root = (sys.argv[1], int(sys.argv[2]),
                                      int(sys.argv[3]), sys.argv[4],
                                      sys.argv[5])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)

    import jax
    jax.config.update("jax_platforms", "cpu")
    from nanomod import use_compile_cache
    use_compile_cache()
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=nprocs, process_id=rank)
    assert jax.process_count() == nprocs

    if mode == "detect":
        from nanomod.config import DetectConfig, RankConfig
        from nanomod.detect import run_detect

        cfg = DetectConfig(
            wrk_base1=os.path.join(root, "control"),
            wrk_base2=os.path.join(root, "case"),
            out_folder=os.path.join(root, f"out_r{rank}"),
            file_id="mh", min_lr=0, rank=RankConfig(window=4),
        )
        run_detect(cfg)
    elif mode == "detect_sharded":
        # position-sharded merge over the real backend: one all-to-all
        # routes observations to range owners; ranks write output shards
        # and rank 0 concatenates into out_sharded/mh_sign_test.txt
        from nanomod.config import DetectConfig, RankConfig, StatConfig
        from nanomod.detect import run_detect

        cfg = DetectConfig(
            wrk_base1=os.path.join(root, "control"),
            wrk_base2=os.path.join(root, "case"),
            out_folder=os.path.join(root, "out_sharded"),
            file_id="mh", min_lr=0, rank=RankConfig(window=4),
            stats=StatConfig(coverages=(12, 12), downsampling=10),
            pool_capacity=16, merge_mode="sharded",
        )
        _, _, sites = run_detect(cfg)
        print(f"TOP_SITE={sites[0].chrom}:{sites[0].strand}:{sites[0].pos}",
              flush=True)
    elif mode == "annotate":
        from nanomod.config import AnnotateConfig
        from nanomod.resquiggle import annotate_folder

        cfg = AnnotateConfig(
            wrk_base1=os.path.join(root, "reads_multi"),
            ref_fasta=os.path.join(root, "ref.fa"),
        )
        n_ok, errors = annotate_folder(cfg)
        # every rank must report the MERGED global totals
        print(f"MERGED_OK={n_ok}", flush=True)
    else:
        raise SystemExit(f"unknown mode {mode!r}")
    print(f"rank {rank}: done", flush=True)


if __name__ == "__main__":
    main()
