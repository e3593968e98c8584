"""Seeded synthetic FAST5 datasets (harness/synth.py) and the profiler
trace reduction (utils/observe.device_time)."""

import hashlib
import json
import os

import numpy as np
import pytest

from nanomod.harness import synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_scale_genome_matches_pinned_manifest():
    with open(os.path.join(REPO, "tools", "scale_manifest.json")) as f:
        want = json.load(f)["seeds"]["0"]
    genome, levels, planted = synth.scale_genome(0, 4_600_000, 20)
    assert hashlib.sha256(genome.tobytes()).hexdigest() == \
        want["genome_sha256"]
    assert planted == want["planted"]
    assert len(levels) == 2 and levels[0].shape == (4_600_000,)


def test_corrected_group_reads_back(tmp_path):
    from nanomod.native.fast5_bind import read_corrected_batch

    genome, levels, _ = synth.scale_genome(3, 5_000, 1)
    planted = [2_500]
    folder = str(tmp_path / "case")
    synth.write_corrected_group(folder, "c", genome, levels,
                                np.random.default_rng(4), 40, 500,
                                planted=planted, batch=16, nthreads=2)
    paths = sorted(os.path.join(dp, f) for dp, _, fs in os.walk(folder)
                   for f in fs)
    reads = read_corrected_batch(paths, nthreads=2)
    assert len(reads) == 40 and all(r is not None for r in reads)
    comp = dict(zip(b"ACGT", b"TGCA"))
    shifted = []
    for r in reads:
        span = genome[r.start: r.start + 500]
        if r.strand == "+":
            assert r.base.tobytes() == span.tobytes()
            means = r.norm_mean
        else:
            assert r.base.tobytes() == bytes(comp[b] for b in span[::-1])
            means = r.norm_mean[::-1]
        level = levels[r.strand == "-"][r.start: r.start + 500]
        resid = means - level
        if r.start <= planted[0] < r.start + 500:
            shifted.append(resid[planted[0] - r.start])
        assert np.allclose(np.round(means, 3), means)
    assert shifted and np.mean(shifted) > 1.0     # the +1.5 planted shift


def test_raw_read_without_errors_is_the_sequence():
    rng = np.random.default_rng(0)
    seq = rng.choice(synth.ACGT, 300)
    dac, ev, bc = synth.simulate_raw_read(seq, rng, synth._kmer_tables(),
                                          error_rate=0.0)
    assert bc == seq.tobytes().decode()
    assert len(ev) == 300 and dac.dtype == np.int16
    assert ev["start"][-1] + ev["length"][-1] == len(dac)
    assert ev["model_state"][2] == seq[:5].tobytes()


def test_raw_group_annotates(tmp_path):
    from nanomod.config import AnnotateConfig
    from nanomod.io.fasta import FastaIndex
    from nanomod.resquiggle import annotate_files
    from nanomod.resquiggle.seed import SeedIndex

    genome, _, _ = synth.scale_genome(5, 6_000, 1)
    fasta_p = str(tmp_path / "ref.fa")
    with open(fasta_p, "w") as f:
        f.write(">c\n" + genome.tobytes().decode() + "\n")
    paths = synth.write_raw_group(str(tmp_path / "raw"), genome,
                                  np.random.default_rng(6), 12, 800,
                                  error_rate=0.03)
    cfg = AnnotateConfig(ref_fasta=fasta_p)
    fasta = FastaIndex(fasta_p)
    n_ok, errors, _ = annotate_files(paths, cfg, fasta,
                                     SeedIndex(fasta.seqs, k=cfg.seed_k))
    assert n_ok == 12, errors


def test_device_time_reads_a_trace(tmp_path):
    """The reduction finds the trace and counts no device time where
    there is no GPU plane; without a trace it says so."""
    import jax
    import jax.numpy as jnp

    from nanomod.utils.observe import device_time

    with pytest.raises(FileNotFoundError):
        device_time(str(tmp_path / "none"))
    f = jax.jit(lambda x: jnp.cumsum(x * 2))
    f(jnp.ones(64)).block_until_ready()
    with jax.profiler.trace(str(tmp_path / "tr")):
        f(jnp.ones(64)).block_until_ready()
    dt = device_time(str(tmp_path / "tr"), ("lambda",))
    assert dt == {"busy_ns": 0.0, "by_module": {"lambda": 0}, "events": 0}
