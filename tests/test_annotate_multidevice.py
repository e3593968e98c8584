"""Multi-device Annotate fan-out (AnnotateConfig.n_devices).

The reference saturates a host with 12 worker processes
(ref bin/scripts/myRefBaseSignalAnnotation.py:1452-1483); the rebuild
round-robins banded-DP sub-batches over local jax devices
(resquiggle/pipeline.py process_prepared).  Contract: the corrected FAST5
output is BYTE-identical for any n_devices — the DP is deterministic and
write order follows dispatch order.  Runs on the 8-virtual-CPU mesh
(tests/conftest.py).
"""

import os

import numpy as np

from fixtures import make_genome, make_raw_dataset
from nanomod.config import AnnotateConfig, replace
from nanomod.io.fast5 import read_corrected_events
from nanomod.io.fasta import FastaIndex
from nanomod.resquiggle import annotate_files
from nanomod.resquiggle.seed import SeedIndex


def _run(tmp_path, tag, n_devices, n_reads=48):
    chrom, genome = make_genome(length=900, seed=3)
    fasta_p = os.path.join(str(tmp_path), f"ref_{tag}.fa")
    with open(fasta_p, "w") as f:
        f.write(f">{chrom}\n{genome}\n")
    reads_dir = os.path.join(str(tmp_path), f"reads_{tag}")
    make_raw_dataset(reads_dir, chrom, genome, n_reads=n_reads, seed=5,
                     read_len=600, error_rate=0.05)
    paths = sorted(os.path.join(reads_dir, f) for f in os.listdir(reads_dir))
    cfg = AnnotateConfig(wrk_base1=reads_dir, ref_fasta=fasta_p,
                         n_devices=n_devices, dp_batch_size=16)
    fasta = FastaIndex(fasta_p)
    sidx = SeedIndex(fasta.seqs, k=cfg.seed_k)
    n_ok, errors, _ = annotate_files(paths, cfg, fasta, sidx)
    assert n_ok > n_reads * 0.8, (n_ok, errors)
    return paths


def test_multidevice_annotate_byte_identical(tmp_path):
    import jax
    assert len(jax.local_devices()) >= 4, "conftest should provide 8 cpus"
    p1 = _run(tmp_path, "d1", n_devices=1)
    p4 = _run(tmp_path, "d4", n_devices=4)
    n_same = 0
    for a, b in zip(p1, p4):
        ra = read_corrected_events(a)
        rb = read_corrected_events(b)
        assert (ra is None) == (rb is None), (a, b)
        if ra is None:
            continue
        assert ra.chrom == rb.chrom and ra.strand == rb.strand
        assert ra.start == rb.start
        np.testing.assert_array_equal(ra.norm_mean, rb.norm_mean)
        np.testing.assert_array_equal(ra.norm_stdev, rb.norm_stdev)
        np.testing.assert_array_equal(ra.base, rb.base)
        np.testing.assert_array_equal(ra.ev_start, rb.ev_start)
        np.testing.assert_array_equal(ra.ev_length, rb.ev_length)
        n_same += 1
    assert n_same > 30
