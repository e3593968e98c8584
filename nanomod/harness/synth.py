"""Seeded synthetic FAST5 datasets at genome scale, written without h5py.

* ``scale_genome`` — a random genome, per-(position, strand) normalized
  k-mer levels and planted modified sites, all from one seed;
* ``write_corrected_group`` — a group of corrected FAST5s (detect input):
  reads at random positions and strands observe the level track with
  Gaussian noise, and reads of a case group carry a bulky-adduct shift at
  each planted site (full at the site, half at +-1 — what the neighbor
  combination exists to capture, ref myDetect.py:373-414);
* ``write_raw_group`` — raw basecalled FAST5s (Annotate input): 5-mer pA
  levels, Poisson dwells, basecall substitutions/insertions/deletions and
  albacore-2 event tables, as tests/fixtures.py models them, vectorized.

Files are created by io.h5write and filled by the native FAST5 writer, so
neither step needs libhdf5.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from nanomod.io.fast5 import CORRECTED_EVENTS_DTYPE
from nanomod.io.h5write import write_h5

ACGT = np.frombuffer(b"ACGT", np.uint8)
_COMP = np.frombuffer(b"TGCA", np.uint8)

# raw-read channel calibration and event dtype (albacore 2)
DIGITISATION, RANGE, OFFSET, SAMPLING_RATE = 8192.0, 1400.0, 10.0, 4000.0
ALBACORE2_EVENT_DTYPE = np.dtype([
    ("mean", "<f8"), ("stdv", "<f8"), ("start", "<u8"), ("length", "<u8"),
    ("model_state", "S5"), ("move", "<i4"),
])


def scale_genome(seed: int, genome_len: int, n_sites: int):
    """(genome uint8 ACGT codes, [level track '+', level track '-'],
    sorted planted positions) from one seed."""
    rng = np.random.default_rng(seed)
    genome = rng.choice(ACGT, genome_len)
    levels = [rng.normal(0.0, 1.0, genome_len),
              rng.normal(0.0, 1.0, genome_len)]
    planted = sorted(int(p) for p in
                     rng.choice(genome_len - 100, n_sites, replace=False) + 50)
    return genome, levels, planted


def write_corrected_files(paths, payloads, nthreads: int = 8):
    """Create each FAST5 and write its corrected annotation (the
    io.fast5.write_corrected_events keyword dict) with the native writer;
    raises if the native writer is unavailable or declines a file."""
    from nanomod.native.fast5_write_bind import write_corrected_batch_native

    for p in paths:
        write_h5(p, {})
    ok = write_corrected_batch_native(paths, payloads, nthreads=nthreads)
    if ok is None:
        raise RuntimeError("native FAST5 writer unavailable")
    if not ok.all():
        raise RuntimeError(f"native FAST5 writer failed on "
                           f"{int((~ok).sum())} of {len(paths)} files")


def write_corrected_group(folder: str, chrom: str, genome: np.ndarray,
                          levels, rng, n_reads: int, read_len: int,
                          planted=None, mod_delta: float = 1.5,
                          batch: int = 2000, nthreads: int = 8):
    """Write one group of corrected FAST5s (``folder/<i//4000>/r<i>.fast5``).

    Strands are random (not i%2: round-robin file sharding would then give
    each of 2 hosts a single strand), and the level track is keyed by
    strand — a physical per-(position, strand) level — so a pool never
    mixes two tracks."""
    glen = len(genome)
    paths, payloads = [], []
    for i in range(n_reads):
        strand = "+-"[int(rng.integers(2))]
        start = int(rng.integers(0, glen - read_len + 1))
        gpos = np.arange(start, start + read_len)
        means = levels[strand == "-"][gpos] + rng.normal(0.0, 0.3, read_len)
        for tp in planted or ():
            for off, scale in ((-1, 0.5), (0, 1.0), (1, 0.5)):
                if start <= tp + off < start + read_len:
                    means[tp + off - start] += mod_delta * scale
        ev = np.zeros(read_len, CORRECTED_EVENTS_DTYPE)
        if strand == "-":       # stored order: genome-descending
            ev["norm_mean"] = np.round(means[::-1], 3)
            ev["base"] = _COMP[np.searchsorted(ACGT, genome[gpos[::-1]])
                               ].view("S1")
        else:
            ev["norm_mean"] = np.round(means, 3)
            ev["base"] = genome[gpos].view("S1")
        ev["norm_stdev"] = 0.1
        ev["start"] = np.arange(read_len, dtype=np.uint32) * 8
        ev["length"] = 8
        sub = os.path.join(folder, str(i // 4000))
        os.makedirs(sub, exist_ok=True)
        paths.append(os.path.join(sub, f"r{i:06d}.fast5"))
        payloads.append(dict(
            chrom=chrom, start=start, strand=strand, events=ev,
            read_alignment=ev["base"], genome_alignment=ev["base"],
            clipped_start=0, clipped_end=0, num_insertions=0,
            num_deletions=0, num_matches=read_len, num_mismatches=0))
        if len(paths) == batch or i == n_reads - 1:
            write_corrected_files(paths, payloads, nthreads)
            paths, payloads = [], []


# ---- raw reads -------------------------------------------------------------

_ALPHA = np.frombuffer(b"ACGTN", np.uint8)
_CODE = np.full(256, 4, np.int64)          # byte -> index into _ALPHA
_CODE[ACGT] = np.arange(4)


def _kmer_tables():
    """pA level and S5 name of every 5-mer over ACGTN (index base 5)."""
    names = np.array([bytes(_ALPHA[[(k // 5 ** (4 - j)) % 5
                                    for j in range(5)]])
                      for k in range(5 ** 5)], dtype="S5")
    lv = np.empty(5 ** 5)
    for k, name in enumerate(names):
        h = hashlib.md5(name).digest()
        u = int.from_bytes(h[:4], "little") / 2 ** 32
        v = int.from_bytes(h[4:8], "little") / 2 ** 32
        z = np.sqrt(-2 * np.log(max(u, 1e-12))) * np.cos(2 * np.pi * v)
        lv[k] = 100.0 + 15.0 * float(np.clip(z, -3, 3))
    return lv, names


def simulate_raw_read(seq: np.ndarray, rng, tables, error_rate: float,
                      mod_level=None, dwell_mean: int = 9,
                      noise_pa: float = 1.5):
    """Raw DAC signal, albacore-2 events and basecall for true sequence
    `seq` (ACGT codes).  `mod_level` [len(seq)] adds pA to the bases it
    marks."""
    lv, names = tables
    n = len(seq)
    r = rng.random(n)
    keep = r >= error_rate / 3                     # deletions drop bases
    ins = keep & (r < 2 * error_rate / 3)          # a random base first
    sub = rng.random(n) < error_rate / 3
    called = np.where(sub, rng.choice(ACGT, n), seq)
    reps = keep.astype(np.int64) + ins
    true_pos = np.repeat(np.arange(n), reps)
    bc = np.repeat(called, reps)
    first = np.cumsum(reps) - reps                 # index of each base's run
    bc[first[ins]] = rng.choice(ACGT, int(ins.sum()))
    m = len(bc)

    code = _CODE[bc]
    padded = np.concatenate([[4, 4], code, [4, 4]])
    kmer = np.zeros(m, np.int64)
    for j in range(5):
        kmer = kmer * 5 + padded[j: j + m]
    level = lv[kmer]
    if mod_level is not None:
        level = level + mod_level[true_pos]
    dwells = np.maximum(rng.poisson(dwell_mean, m), 4)
    starts = np.concatenate([[0], np.cumsum(dwells)[:-1]])
    signal = np.repeat(level, dwells) + rng.normal(0.0, noise_pa,
                                                   int(dwells.sum()))
    ev = np.zeros(m, ALBACORE2_EVENT_DTYPE)
    ev["start"] = starts
    ev["length"] = dwells
    ev["move"] = 1
    ev["move"][0] = 0
    ev["mean"] = np.add.reduceat(signal, starts) / dwells
    ev["stdv"] = np.sqrt(np.maximum(
        np.add.reduceat(signal * signal, starts) / dwells - ev["mean"] ** 2,
        0.0))
    ev["model_state"] = names[kmer]
    dac = np.round(signal * DIGITISATION / RANGE - OFFSET).astype(np.int16)
    return dac, ev, bc.tobytes().decode()


def write_raw_group(folder: str, genome: np.ndarray, rng, n_reads: int,
                    read_len: int, region=None, planted=(),
                    mod_delta_pa: float = 0.0, error_rate: float = 0.03,
                    first_index: int = 0, tables=None):
    """Raw basecalled FAST5s of reads drawn from ``region`` = (lo, hi) of the
    genome (whole genome by default), either strand; reads covering a
    planted site carry +mod_delta_pa there (half at +-1).  Returns paths."""
    tables = tables or _kmer_tables()
    lo, hi = region or (0, len(genome))
    mod = np.zeros(len(genome))
    for tp in planted:
        for off, scale in ((-1, 0.5), (0, 1.0), (1, 0.5)):
            mod[tp + off] += mod_delta_pa * scale
    os.makedirs(folder, exist_ok=True)
    paths = []
    for i in range(first_index, first_index + n_reads):
        start = int(rng.integers(lo, hi - read_len + 1))
        seq = genome[start: start + read_len]
        mod_level = mod[start: start + read_len]
        if rng.integers(2):                        # '-' strand read
            seq = _COMP[np.searchsorted(ACGT, seq)][::-1]
            mod_level = mod_level[::-1]
        dac, ev, bc = simulate_raw_read(seq, rng, tables, error_rate,
                                        mod_level=mod_level)
        fq = f"@read-{i:06d}\n{bc}\n+\n{'!' * len(bc)}\n".encode()
        path = os.path.join(folder, f"raw_{i:06d}.fast5")
        write_h5(path, {
            "UniqueGlobalKey": {"channel_id": {"@attrs": {
                "digitisation": DIGITISATION, "offset": OFFSET,
                "range": RANGE, "sampling_rate": SAMPLING_RATE,
                "channel_number": b"1"}}},
            "Raw": {"Reads": {f"Read_{i}": {
                "@attrs": {"start_time": 0, "read_id": f"read-{i:06d}"},
                "Signal": dac}}},
            "Analyses": {"Basecall_1D_000": {
                "@attrs": {"name": b"ONT Albacore Sequencing Software",
                           "version": b"2.3.1"},
                "BaseCalled_template": {"Events": ev, "Fastq": fq}}},
        })
        paths.append(path)
    return paths
