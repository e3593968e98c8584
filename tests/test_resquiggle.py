"""Resquiggle engine tests: seeding, banded alignment, indel-correction
core, and the full Annotate -> detect round trip on synthetic raw reads."""

import os

import numpy as np
import pytest

from fixtures import make_genome, make_raw_dataset, write_raw_fixture
from nanomod.config import AnnotateConfig, DetectConfig, RankConfig
from nanomod.io.fast5 import read_corrected_events
from nanomod.io.fasta import FastaIndex, revcomp
from nanomod.resquiggle.annotate import (Columns, GenomeEvents,
                                             find_split_points,
                                             group_indels,
                                             mark_repeat_indels)
from nanomod.resquiggle.pipeline import annotate_folder
from nanomod.resquiggle.seed import SeedIndex


def _write_fasta(path, chrom, genome):
    with open(path, "w") as f:
        f.write(f">{chrom}\n{genome}\n")


# ---------------------------------------------------------------------------
# unit: indel-correction core
# ---------------------------------------------------------------------------

def test_mark_repeat_indels_basic():
    # ref: ACGTA / read: AC-TA -> deletion column at index 2
    cols = Columns(np.array(list("ACGTA"), "<U1"), np.array(list("AC-TA"), "<U1"))
    ip = mark_repeat_indels(cols)
    assert ip == {2: (1, -1)}


def test_mark_repeat_indels_insertion():
    # ref: AC-TA / read: ACGTA -> insertion column at index 2, event 2
    cols = Columns(np.array(list("AC-TA"), "<U1"), np.array(list("ACGTA"), "<U1"))
    ip = mark_repeat_indels(cols)
    assert ip == {2: (2, 1)}


def test_repeat_period_marking():
    # periodic 5-mer context turns indel into '~' (ref :1207-1212)
    ref_ = "AAAAAAAA"
    read = "AAAA-AAA"
    cols = Columns(np.array(list(ref_), "<U1"), np.array(list(read), "<U1"))
    mark_repeat_indels(cols)
    assert cols.readbase[4] == "~"


def test_find_split_points_clear_boundaries():
    # two-level signal: one obvious split
    sig = np.array([0.0] * 10 + [5.0] * 10)
    sp = find_split_points(sig, expectna=2, signal_wind=4, min_num_signal=4)
    assert sp is not None and len(sp) == 1
    assert sp[0][0] == 10

    # three segments
    sig = np.array([0.0] * 8 + [5.0] * 8 + [-5.0] * 8)
    sp = find_split_points(sig, expectna=3, signal_wind=4, min_num_signal=4)
    assert sp is not None and [s for s, _ in sp] == [8, 16]


def test_find_split_points_not_enough_room():
    sig = np.zeros(6)
    assert find_split_points(sig, expectna=4, signal_wind=3, min_num_signal=4) is None


def test_group_indels_window_growth():
    # deletion at column 5 of a 11-col match run; events 1:1 with read bases
    ref_ = "ACGTACGTACG"
    read = "ACGTA-GTACG"
    cols = Columns(np.array(list(ref_), "<U1"), np.array(list(read), "<U1"))
    ip = mark_repeat_indels(cols)
    assert list(ip) == [5]
    ev = GenomeEvents(np.arange(10) * 10, np.full(10, 10), "+")
    groups = group_indels(ip, ev, cols, min_num_signal=4)
    assert len(groups) == 1
    (start_ev, end_ev, last_col, (ln, rn)) = groups[5]
    # span must exceed (expectna + extra) * min_num_signal
    lo, hi = ev.raw_span(start_ev, end_ev)
    assert hi - lo > 0
    assert start_ev <= ip[5][0] and end_ev >= ip[5][0] + 1


# ---------------------------------------------------------------------------
# integration: seeding
# ---------------------------------------------------------------------------

def test_seed_index_both_strands():
    chrom, genome = make_genome(1200, seed=11, name="chrA")
    idx = SeedIndex({chrom: genome}, k=12)
    frag = genome[300:700]
    hit = idx.best_band(frag)
    assert hit.strand == "+" and abs(hit.diag - 300) < 16
    hit = idx.best_band(revcomp(frag))
    assert hit.strand == "-" and abs(hit.diag - 300) < 16


# ---------------------------------------------------------------------------
# end to end: Annotate on raw fixtures, then detect the planted mod
# ---------------------------------------------------------------------------

MOD_POS = 201


@pytest.fixture(scope="module")
def annotated(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("raw"))
    chrom, genome = make_genome(length=420, seed=3)
    fasta = os.path.join(root, "ref.fa")
    _write_fasta(fasta, chrom, genome)
    ctrl = os.path.join(root, "ctrl")
    case = os.path.join(root, "case")
    make_raw_dataset(ctrl, chrom, genome, n_reads=16, seed=10, error_rate=0.02)
    make_raw_dataset(case, chrom, genome, n_reads=16, seed=20,
                     mod_pos=MOD_POS, mod_delta_pa=12.0, error_rate=0.02)
    cfg = AnnotateConfig(ref_fasta=fasta)
    for folder in (ctrl, case):
        n_ok, errors = annotate_folder(
            AnnotateConfig(wrk_base1=folder, ref_fasta=fasta))
        assert n_ok >= 14, f"too many failures: {errors}"
    return root, chrom, genome, ctrl, case


def test_annotate_layout_and_mapping(annotated):
    root, chrom, genome, ctrl, case = annotated
    ok = 0
    for name in sorted(os.listdir(ctrl)):
        rd = read_corrected_events(os.path.join(ctrl, name))
        if rd is None:
            continue
        ok += 1
        assert rd.chrom == chrom
        assert rd.strand in "+-"
        n = len(rd.norm_mean)
        assert 0 <= rd.start and rd.start + n <= len(genome) + 5
        # stored bases: '+' = ref bases at start+i; '-' = complement reversed
        seq = "".join(b.decode() for b in rd.base)
        refseq = genome[rd.start: rd.start + n]
        if rd.strand == "-":
            refseq = revcomp(refseq)
        same = sum(a == b for a, b in zip(seq, refseq)) / max(len(seq), 1)
        assert same > 0.95, f"{name}: base column mismatch ({same:.2f})"
        # signal means are normalized (median/MAD scale)
        assert np.abs(np.median(rd.norm_mean)) < 1.5
    assert ok >= 14


def test_annotate_then_detect_round_trip(annotated):
    root, chrom, genome, ctrl, case = annotated
    from nanomod.detect import run_detect
    cfg = DetectConfig(
        wrk_base1=ctrl, wrk_base2=case,
        out_folder=os.path.join(root, "out"),
        min_lr=0, min_coverage=5,
        rank=RankConfig(window=3),
    )
    table, order, sites = run_detect(cfg)
    assert len(sites) > 0
    top = sites[0]
    assert abs(top.pos - MOD_POS) <= 2, (
        f"top site {top.chrom}:{top.pos}{top.strand}, expected ~{MOD_POS}")


def test_pack_unpack_outputs_round_trip():
    """pack_outputs/unpack_outputs must be an exact round trip in all three
    tb payload modes (plain / nibble-packed / device-walk codes) — this
    pins the XLA bitcast byte order against host endianness (ADVICE r3)."""
    from nanomod.resquiggle.banded import (pack_outputs, pack_tb,
                                               unpack_outputs, walk_device)

    B, M, W = 4, 32, 8
    rng = np.random.default_rng(3)
    tb = rng.integers(0, 16, (B, M, W)).astype(np.uint8)
    best = np.array([-7, 0, 123456, 2**31 - 1], np.int32)
    bi = rng.integers(0, M, B).astype(np.int32)
    bk = rng.integers(0, W, B).astype(np.int32)

    for mode_tb, shape in (
        (tb, (M, W)),                                  # plain
        (np.asarray(pack_tb(tb)), (M, W // 2)),        # nibble-packed
        (rng.integers(0, 4, (B, 2 * M + W)).astype(np.uint8),
         (2 * M + W,)),                                # walk codes
    ):
        packed = np.asarray(pack_outputs(mode_tb, best, bi, bk))
        tb2, b2, i2, k2 = unpack_outputs(packed, shape)
        np.testing.assert_array_equal(tb2, mode_tb)
        np.testing.assert_array_equal(b2, best)
        np.testing.assert_array_equal(i2, bi)
        np.testing.assert_array_equal(k2, bk)
    # nibble pack itself inverts
    lo = np.asarray(pack_tb(tb)) & 0x0F
    hi = np.asarray(pack_tb(tb)) >> 4
    np.testing.assert_array_equal(lo, tb[..., 0::2])
    np.testing.assert_array_equal(hi, tb[..., 1::2])


def test_pack_outputs_float_score_rounds():
    """A float-valued score config must round (not truncate toward zero)
    into the packed int32 slot (ADVICE r3)."""
    from nanomod.resquiggle.banded import pack_outputs, unpack_outputs

    tb = np.zeros((2, 4, 4), np.uint8)
    best = np.array([41.6, -3.4], np.float32)
    z = np.zeros(2, np.int32)
    _, b2, _, _ = unpack_outputs(np.asarray(pack_outputs(tb, best, z, z)),
                                 (4, 4))
    np.testing.assert_array_equal(b2, [42, -3])


def test_native_seed_batch_matches_python():
    """best_bands_native (seed_core.cpp) must agree with the per-read
    Python best_band on strand/chrom and land in the same DP band."""
    from nanomod.io.fasta import revcomp
    from nanomod.native.build import native_available
    from nanomod.resquiggle.seed import SeedIndex

    if not native_available("seed_core"):
        pytest.skip("no native toolchain")
    rng = np.random.default_rng(7)
    genome = "".join(rng.choice(list("ACGT"), 3000))
    idx = SeedIndex({"g": genome}, k=12)
    seqs = []
    for i in range(40):
        lo = int(rng.integers(0, 2000))
        frag = list(genome[lo: lo + 800])
        mut = rng.random(len(frag)) < 0.03
        for j in np.flatnonzero(mut):
            frag[j] = str(rng.choice(list("ACGT")))
        s = "".join(frag)
        seqs.append(s if i % 2 == 0 else revcomp(s))
    seqs.append("N" * 100)            # all-ambiguous: must not seed
    seqs.append("ACGT")               # shorter than k: must not seed
    hits_n = idx.best_bands_native(seqs, nthreads=2)
    assert hits_n is not None
    for s, hn in zip(seqs, hits_n):
        hp = idx.best_band(s)
        if hp is None or hp.votes < 3:
            assert hn is None or hn.votes < 3
            continue
        assert hn is not None
        assert (hn.chrom, hn.strand) == (hp.chrom, hp.strand)
        assert abs(hn.diag - hp.diag) <= 24   # same band (slack 48)
    assert hits_n[-1] is None and hits_n[-2] is None


def test_streaming_chunks_with_failures(tmp_path):
    """The cross-chunk DP stream (pipeline._run_chunks) must annotate every
    good read and classify every bad file across multiple chunks, ramp-up
    chunk included (files_per_thread forced small to exercise >=4 chunks)."""
    import os

    from fixtures import make_genome, make_raw_dataset
    from nanomod.config import AnnotateConfig, replace
    from nanomod.io.fast5 import read_corrected_events
    from nanomod.resquiggle import annotate_files

    chrom, genome = make_genome(length=700, seed=31)
    fasta_p = str(tmp_path / "ref.fa")
    with open(fasta_p, "w") as f:
        f.write(f">{chrom}\n{genome}\n")
    rd = str(tmp_path / "reads")
    paths = make_raw_dataset(rd, chrom, genome, n_reads=40, seed=32,
                             error_rate=0.03)
    # corrupt a file in what will be the ramp-up chunk and one later
    for idx in (3, 30):
        with open(paths[idx], "wb") as f:
            f.write(b"not an hdf5 file at all")
    cfg = replace(AnnotateConfig(wrk_base1=rd, ref_fasta=fasta_p),
                  files_per_thread=8)
    # _chunked ramp-up needs >=192 files to trigger; emulate chunking by
    # calling annotate_files (chunks of max(64,...)=64 -> single chunk for
    # 40 files) AND the explicit multi-chunk path via _chunked monkeypatch
    from nanomod.resquiggle import pipeline as pl
    chunks = [paths[:5], paths[5:20], paths[20:28], paths[28:]]
    fasta = pl.FastaIndex(fasta_p)
    sidx = pl.SeedIndex(fasta.seqs, k=cfg.seed_k)
    n_ok, errors, hist = pl._run_chunks(chunks, cfg, fasta, sidx, None)
    n_err = sum(len(v) for v in errors.values())
    assert n_ok == 38, (n_ok, errors)
    assert n_err == 2
    # every good file actually carries the corrected group now
    n_with = sum(
        1 for p in paths
        if read_corrected_events(p) is not None)
    assert n_with == 38
