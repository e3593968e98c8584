"""Real-backend multi-host tests: 2 actual jax.distributed processes on the
CPU backend run the production multi-host paths, and the results must match
the single-process run over the union of the work.

  * detect: host-sharded ingest -> packed-observation pool merge over the
    Gloo allgather -> battery -> rank -> sign_test; every rank's output
    byte-matches the single-process run.
  * Annotate: each rank resquiggles its round-robin FAST5 shard in place;
    the corrected events written across both ranks' shards equal the
    single-process annotation of the same dataset, file for file, and the
    merged stats report shows the global ok-count on every rank.

This is the jax.distributed replacement for the reference's qsub fan-out + file
merge (ref bin/scripts/mySimulate.py:344-457) and its SGE-scaled Annotate
(ref bin/scripts/myRefBaseSignalAnnotation.py:1452-1483).
"""

import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest

from fixtures import make_corrected_dataset, make_genome, make_raw_dataset

HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_cluster(mode, root, nprocs=2, timeout=300):
    """Launch nprocs real jax.distributed worker processes; returns their
    stdouts. Asserts every rank exits 0."""
    port = _free_port()
    worker = os.path.join(HERE, "_multihost_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, mode, str(rank), str(nprocs),
             str(port), root],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=dict(os.environ),
        )
        for rank in range(nprocs)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode(errors="replace"))
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
    return outs


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mhreal"))
    chrom, genome = make_genome(length=400, seed=7)
    make_corrected_dataset(os.path.join(root, "control"), chrom, genome,
                           n_reads=24, seed=1)
    make_corrected_dataset(os.path.join(root, "case"), chrom, genome,
                           n_reads=24, seed=2, mod_pos=173, mod_delta=1.0)
    return root


def _single_host_bytes(root):
    from nanomod.config import DetectConfig, RankConfig
    from nanomod.detect import run_detect
    cfg = DetectConfig(
        wrk_base1=os.path.join(root, "control"),
        wrk_base2=os.path.join(root, "case"),
        out_folder=os.path.join(root, "out_single"),
        file_id="mh", min_lr=0, rank=RankConfig(window=4),
    )
    run_detect(cfg)
    with open(os.path.join(root, "out_single", "mh_sign_test.txt"), "rb") as f:
        return f.read()


def test_two_process_detect_matches_single_process(dataset):
    root = dataset
    want = _single_host_bytes(root)
    assert len(want) > 1000

    _run_cluster("detect", root)

    for rank in range(2):
        path = os.path.join(root, f"out_r{rank}", "mh_sign_test.txt")
        with open(path, "rb") as f:
            got = f.read()
        assert got == want, f"rank {rank} sign_test differs from single-host"


def test_two_process_sharded_detect_matches_single_process(dataset):
    """merge_mode='sharded' over the real backend: observations route once
    to range owners (jax all-to-all over Gloo), each rank computes/writes
    its range, rank 0 concatenates — byte-identical to single-host."""
    from nanomod.config import DetectConfig, RankConfig, StatConfig
    from nanomod.detect import run_detect

    root = dataset
    cfg = DetectConfig(
        wrk_base1=os.path.join(root, "control"),
        wrk_base2=os.path.join(root, "case"),
        out_folder=os.path.join(root, "out_single_capped"),
        file_id="mh", min_lr=0, rank=RankConfig(window=4),
        stats=StatConfig(coverages=(12, 12), downsampling=10),
        pool_capacity=16,
    )
    _, _, sites = run_detect(cfg)
    with open(os.path.join(root, "out_single_capped",
                           "mh_sign_test.txt"), "rb") as f:
        want = f.read()
    assert len(want) > 1000

    outs = _run_cluster("detect_sharded", root)
    top = f"TOP_SITE={sites[0].chrom}:{sites[0].strand}:{sites[0].pos}"
    for rank, out in enumerate(outs):
        assert top in out, f"rank {rank} global top site differs:\n{out}"

    with open(os.path.join(root, "out_sharded", "mh_sign_test.txt"),
              "rb") as f:
        assert f.read() == want


def test_two_process_annotate_matches_single_process(tmp_path):
    from nanomod.config import AnnotateConfig
    from nanomod.io.fast5 import read_corrected_events
    from nanomod.resquiggle import annotate_folder

    root = str(tmp_path)
    chrom, genome = make_genome(length=500, seed=11)
    with open(os.path.join(root, "ref.fa"), "w") as f:
        f.write(f">{chrom}\n{genome}\n")
    single_dir = os.path.join(root, "reads_single")
    make_raw_dataset(single_dir, chrom, genome, n_reads=10, seed=3,
                     read_len=400, error_rate=0.03)
    multi_dir = os.path.join(root, "reads_multi")
    shutil.copytree(single_dir, multi_dir)

    n_ok, _ = annotate_folder(AnnotateConfig(
        wrk_base1=single_dir, ref_fasta=os.path.join(root, "ref.fa")))
    assert n_ok >= 8

    outs = _run_cluster("annotate", root)
    for rank, out in enumerate(outs):
        assert f"MERGED_OK={n_ok}" in out, (
            f"rank {rank} did not report the merged global ok-count:\n{out}")

    for name in sorted(os.listdir(single_dir)):
        a = read_corrected_events(os.path.join(single_dir, name))
        b = read_corrected_events(os.path.join(multi_dir, name))
        assert (a is None) == (b is None), name
        if a is None:
            continue
        assert (a.chrom, a.strand, a.start) == (b.chrom, b.strand, b.start)
        np.testing.assert_array_equal(a.norm_mean, b.norm_mean, err_msg=name)
        np.testing.assert_array_equal(a.ev_start, b.ev_start, err_msg=name)
        np.testing.assert_array_equal(a.base, b.base, err_msg=name)
