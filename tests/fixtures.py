"""Synthetic nanopore fixtures.

The reference repo ships no test data; its ground truth is a dataset with a
known modified site (chr 'spel', pos 3073 1-based, '-' strand —
ref bin/scripts/mySimulate.py:26-28).  These generators produce:

  * corrected FAST5s (NanomoCorrected_000 layout) for detect/simulate tests
  * raw+basecalled FAST5s (albacore-2-style Events) for Annotate tests

Signal model: each (position, strand) has a deterministic "clean" normalized
level; reads observe it with Gaussian noise; modified reads shift the level
at the target site (and half as much at its two neighbors, modelling the
bulky-adduct neighbor effect the reference's Stouffer window targets).
"""

from __future__ import annotations

import os
import hashlib

import numpy as np

from nanomod.harness.synth import write_corrected_files
from nanomod.io.fast5 import CORRECTED_EVENTS_DTYPE
from nanomod.io.fasta import revcomp
from nanomod.io.h5write import write_h5

BASES = np.array(list("ACGT"))


def make_genome(length=400, seed=7, name="spel"):
    rng = np.random.default_rng(seed)
    return name, "".join(rng.choice(BASES, size=length))


def clean_level(chrom: str, pos: int, strand: str) -> float:
    """Deterministic pseudo-random normalized level in [-2, 2]."""
    h = hashlib.md5(f"{chrom}:{pos}:{strand}".encode()).digest()
    return (int.from_bytes(h[:4], "little") / 2 ** 32) * 4.0 - 2.0


def simulate_corrected_read(chrom, genome, strand, start, length, rng,
                            mod_pos=None, mod_delta=0.0, noise=0.3):
    """Per-base normalized means for a read covering [start, start+length).

    Returns events in STORED order (genome-descending for '-' strand, as
    save_annotation writes them — ref myRefBaseSignalAnnotation.py:699-702).
    """
    gpos = np.arange(start, start + length)
    means = np.array([clean_level(chrom, p, strand) for p in gpos])
    means = means + rng.normal(0.0, noise, size=length)
    if mod_pos is not None:
        for off, scale in ((-1, 0.5), (0, 1.0), (1, 0.5)):
            tp = mod_pos + off
            if start <= tp < start + length:
                means[tp - start] += mod_delta * scale
    seq = genome[start:start + length]
    if strand == "-":
        # stored order: genome-descending; base column = '-' strand base
        means = means[::-1]
        bases = np.array(list(revcomp(seq)), dtype="S1")
    else:
        bases = np.array(list(seq), dtype="S1")
    ev = np.zeros(length, dtype=CORRECTED_EVENTS_DTYPE)
    ev["norm_mean"] = np.round(means, 3)
    ev["norm_stdev"] = 0.1
    ev["start"] = np.arange(length, dtype=np.uint32) * 8
    ev["length"] = 8
    ev["base"] = bases
    return ev


def write_corrected_fixture(path, chrom, genome, strand, start, length, rng,
                            mod_pos=None, mod_delta=0.0, noise=0.3):
    ev = simulate_corrected_read(chrom, genome, strand, start, length, rng,
                                 mod_pos=mod_pos, mod_delta=mod_delta,
                                 noise=noise)
    write_corrected_files([path], [dict(
        chrom=chrom, start=start, strand=strand, events=ev,
        read_alignment=ev["base"], genome_alignment=ev["base"],
        clipped_start=0, clipped_end=0, num_insertions=0, num_deletions=0,
        num_matches=length, num_mismatches=0)], nthreads=1)
    return path


def make_corrected_dataset(folder, chrom, genome, n_reads, seed,
                           mod_pos=None, mod_delta=0.0, read_len=None,
                           noise=0.3, n_subfolders=1, strands="+-"):
    """A group folder of corrected FAST5s, reads tiling the genome."""
    rng = np.random.default_rng(seed)
    glen = len(genome)
    read_len = read_len or glen
    os.makedirs(folder, exist_ok=True)
    paths = []
    for i in range(n_reads):
        sub = os.path.join(folder, str(i % n_subfolders))
        os.makedirs(sub, exist_ok=True)
        strand = strands[i % len(strands)]
        start = 0 if read_len >= glen else int(rng.integers(0, glen - read_len + 1))
        length = min(read_len, glen - start)
        p = os.path.join(sub, f"read_{i:04d}.fast5")
        write_corrected_fixture(p, chrom, genome, strand, start, length, rng,
                                mod_pos=mod_pos, mod_delta=mod_delta,
                                noise=noise)
        paths.append(p)
    return paths


# ---------------------------------------------------------------------------
# Raw + basecalled fixtures (Annotate inputs)
# ---------------------------------------------------------------------------

ALBACORE2_EVENT_DTYPE = np.dtype([
    ("mean", "<f8"), ("stdv", "<f8"), ("start", "<u8"), ("length", "<u8"),
    ("model_state", "S5"), ("move", "<i4"),
])

# channel calibration used by all raw fixtures
DIGITISATION = 8192.0
RANGE = 1400.0
OFFSET = 10.0
SAMPLING_RATE = 4000.0


def kmer_level_pa(kmer: str) -> float:
    """Deterministic 5-mer pore level in pA (~ N(100, 15))."""
    h = hashlib.md5(kmer.encode()).digest()
    u = int.from_bytes(h[:4], "little") / 2 ** 32
    v = int.from_bytes(h[4:8], "little") / 2 ** 32
    # Box-Muller for a stable pseudo-normal
    z = np.sqrt(-2 * np.log(max(u, 1e-12))) * np.cos(2 * np.pi * v)
    return 100.0 + 15.0 * float(np.clip(z, -3, 3))


def model_state_for(seq: str, i: int) -> str:
    lo = i - 2
    hi = i + 3
    pad_l = max(0, -lo)
    pad_r = max(0, hi - len(seq))
    return "N" * pad_l + seq[max(lo, 0):min(hi, len(seq))] + "N" * pad_r


def simulate_raw_read(seq: str, rng, mod_offsets=None, mod_delta_pa=0.0,
                      dwell_mean=9, noise_pa=1.5, error_rate=0.0):
    """Raw DAC signal + albacore2-style event table for basecall `bc_seq`.

    With error_rate > 0 the basecalled sequence differs from `seq` by random
    substitutions/insertions/deletions — exercising the indel-correction
    path of the resquiggle engine.
    Returns (dac int16 array, events structured array, bc_seq).
    """
    # basecall errors relative to the true sequence
    bc = []
    true_pos = []           # index into seq emitting each called base
    i = 0
    while i < len(seq):
        r = rng.random()
        if r < error_rate / 3:                       # deletion
            i += 1
            continue
        if r < 2 * error_rate / 3:                   # insertion
            bc.append(str(rng.choice(BASES)))
            true_pos.append(i)
        if rng.random() < error_rate / 3:            # substitution
            bc.append(str(rng.choice(BASES)))
        else:
            bc.append(seq[i])
        true_pos.append(i)
        i += 1
    # keep bc/true_pos aligned 1:1 (insertion above appended an extra)
    bc_seq = "".join(bc)
    if len(true_pos) != len(bc_seq):
        true_pos = true_pos[: len(bc_seq)]

    # raw signal: per called base, dwell samples at the 5-mer level
    dwells = np.maximum(rng.poisson(dwell_mean, size=len(bc_seq)), 4)
    sig = []
    starts = np.zeros(len(bc_seq), dtype=np.uint64)
    pos = 0
    for j, b in enumerate(bc_seq):
        kmer = model_state_for(bc_seq, j)
        level = kmer_level_pa(kmer)
        if mod_offsets and true_pos[j] in mod_offsets:
            level += mod_delta_pa * mod_offsets[true_pos[j]]
        starts[j] = pos
        sig.append(rng.normal(level, noise_pa, size=dwells[j]))
        pos += int(dwells[j])
    signal_pa = np.concatenate(sig)

    events = np.zeros(len(bc_seq), dtype=ALBACORE2_EVENT_DTYPE)
    events["start"] = starts
    events["length"] = dwells
    events["move"] = 1
    events["move"][0] = 0          # first row conventionally move 0 or 1
    for j in range(len(bc_seq)):
        s = int(starts[j]); e = s + int(dwells[j])
        events["mean"][j] = signal_pa[s:e].mean()
        events["stdv"][j] = signal_pa[s:e].std()
        events["model_state"][j] = model_state_for(bc_seq, j).encode()

    dac = np.round(signal_pa * DIGITISATION / RANGE - OFFSET).astype(np.int16)
    return dac, events, bc_seq


def write_raw_fixture(path, seq, rng, read_number=0, **kw):
    """One raw FAST5 with channel info, Raw signal, and albacore2 basecalls."""
    dac, events, bc_seq = simulate_raw_read(seq, rng, **kw)
    fq = f"@read-{read_number:06d}\n{bc_seq}\n+\n{'!' * len(bc_seq)}\n"
    write_h5(path, raw_fast5_tree(
        dac, events, fq.encode(), read_number,
        f"read-{read_number:06d}-{os.path.basename(path)}"))
    return path, bc_seq


def raw_fast5_tree(dac, events, fastq: bytes, read_number: int,
                   read_id: str) -> dict:
    """The albacore-2 raw FAST5 layout as an io.h5write tree."""
    return {
        "UniqueGlobalKey": {"channel_id": {"@attrs": {
            "digitisation": DIGITISATION, "offset": OFFSET, "range": RANGE,
            "sampling_rate": SAMPLING_RATE, "channel_number": b"1"}}},
        "Raw": {"Reads": {f"Read_{read_number}": {
            "@attrs": {"start_time": 0, "read_id": read_id},
            "Signal": dac}}},
        "Analyses": {"Basecall_1D_000": {
            "@attrs": {"name": b"ONT Albacore Sequencing Software",
                       "version": b"2.3.1"},
            "BaseCalled_template": {"Events": events, "Fastq": fastq}}},
    }


def make_raw_dataset(folder, chrom, genome, n_reads, seed, mod_pos=None,
                     mod_delta_pa=0.0, read_len=None, error_rate=0.02,
                     strands="+-"):
    """Raw FAST5 group; reads are subsequences of the genome (either strand),
    with optional level shift at mod_pos (genome coordinate)."""
    rng = np.random.default_rng(seed)
    glen = len(genome)
    read_len = read_len or glen
    os.makedirs(folder, exist_ok=True)
    paths = []
    for i in range(n_reads):
        strand = strands[i % len(strands)]
        start = 0 if read_len >= glen else int(rng.integers(0, glen - read_len + 1))
        length = min(read_len, glen - start)
        seq = genome[start:start + length]
        mod_offsets = None
        if mod_pos is not None and start <= mod_pos < start + length:
            center = mod_pos - start
            if strand == "-":
                center = length - 1 - center
            mod_offsets = {center - 1: 0.5, center: 1.0, center + 1: 0.5}
        if strand == "-":
            seq = revcomp(seq)
        p = os.path.join(folder, f"raw_{i:04d}.fast5")
        write_raw_fixture(p, seq, rng, read_number=i,
                          mod_offsets=mod_offsets, mod_delta_pa=mod_delta_pa,
                          error_rate=error_rate)
        paths.append(p)
    return paths
