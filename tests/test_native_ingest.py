"""Parity tests: native C++ FAST5/HDF5 parser vs the h5py read path.

The native parser (native/fast5_ingest.cpp) re-implements HDF5 reading from
scratch for the detect ingest hot path (ref myDetect.py:547-633 walks files
one at a time through h5py); these tests assert bit-identical results over
the HDF5 feature matrix h5py can produce (object-header v1/v2, chunk
indexing v1-btree / single-chunk / fixed-array, deflate + shuffle filters,
contiguous layout, both strands)."""

import os

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from nanomod.io.fast5 import CORRECTED_EVENTS_DTYPE, read_corrected_events
from nanomod.native.fast5_bind import (native_ingest_available,
                                           read_corrected_batch)

pytestmark = pytest.mark.skipif(not native_ingest_available(),
                                reason="no C++ toolchain")


def _write(path, n, rng, libver=None, compression="gzip", shuffle=False,
           chunks=None, strand="+", chrom="spel"):
    ev = np.zeros(n, dtype=CORRECTED_EVENTS_DTYPE)
    ev["norm_mean"] = rng.normal(0, 1, n)
    ev["norm_stdev"] = rng.random(n)
    ev["start"] = np.arange(n, dtype=np.uint32) * 5
    ev["length"] = rng.integers(1, 30, n)
    ev["base"] = rng.choice([b"A", b"C", b"G", b"T"], n)
    kw = {"libver": libver} if libver else {}
    with h5py.File(path, "w", **kw) as f:
        g = f.create_group("Analyses/NanomoCorrected_000/BaseCalled_template")
        al = g.create_group("Alignment")
        al.attrs["mapped_chrom"] = chrom
        al.attrs["mapped_start"] = 123456789
        al.attrs["mapped_strand"] = strand
        dkw = {}
        if compression:
            dkw["compression"] = compression
        if shuffle:
            dkw["shuffle"] = True
        if chunks:
            dkw["chunks"] = chunks
        g.create_dataset("Events", data=ev, **dkw)


CASES = {
    "earliest_gzip": dict(),
    "v2_headers": dict(libver="latest"),
    "v2_fixed_array": dict(libver="latest", chunks=(64,)),
    "shuffle_filter": dict(shuffle=True),
    "contiguous": dict(compression=None),
    "multichunk_btree": dict(chunks=(37,)),
    "neg_strand": dict(strand="-"),
    "long_chrom": dict(chrom="a_very_long_chromosome_name_abcdef_012345"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_matches_h5py(tmp_path, case):
    rng = np.random.default_rng(hash(case) % 2**32)
    p = str(tmp_path / f"{case}.fast5")
    _write(p, 500, rng, **CASES[case])
    ref = read_corrected_events(p)
    got = read_corrected_batch([p])[0]
    assert got is not None
    assert got.chrom == ref.chrom
    assert got.start == ref.start
    assert got.strand == ref.strand
    np.testing.assert_array_equal(got.norm_mean, ref.norm_mean)
    np.testing.assert_array_equal(got.norm_stdev, ref.norm_stdev)
    np.testing.assert_array_equal(got.ev_start, ref.ev_start)
    np.testing.assert_array_equal(got.ev_length, ref.ev_length)
    np.testing.assert_array_equal(got.base, ref.base)


def test_batch_tolerates_bad_files(tmp_path):
    """Missing files / non-HDF5 files / files without the corrected group
    yield None (matching read_corrected_events, ref myDetect.py:41-45)."""
    rng = np.random.default_rng(0)
    good = str(tmp_path / "good.fast5")
    _write(good, 100, rng)
    garbage = str(tmp_path / "garbage.fast5")
    with open(garbage, "wb") as f:
        f.write(b"\x00" * 100)
    empty = str(tmp_path / "empty.fast5")
    with h5py.File(empty, "w"):
        pass
    missing = str(tmp_path / "missing.fast5")

    res = read_corrected_batch([garbage, good, empty, missing])
    assert res[0] is None
    assert res[1] is not None and len(res[1].norm_mean) == 100
    assert res[2] is None
    assert res[3] is None


def test_detect_ingest_uses_native(tmp_path, monkeypatch):
    """ingest_group produces identical pools via native and h5py paths."""
    import dataclasses
    from nanomod.config import DetectConfig
    from nanomod.detect import ingest_group
    rng = np.random.default_rng(5)
    for i in range(6):
        _write(str(tmp_path / f"r{i}.fast5"), 200, rng,
               strand="+-"[i % 2])
    cfg = DetectConfig(wrk_base1=str(tmp_path), wrk_base2=str(tmp_path),
                       out_folder=str(tmp_path), min_lr=0)
    pools_native = ingest_group(str(tmp_path), cfg)
    cfg2 = dataclasses.replace(cfg, native_ingest=False)
    pools_h5py = ingest_group(str(tmp_path), cfg2)
    assert set(pools_native) == set(pools_h5py)
    for k in pools_native:
        np.testing.assert_array_equal(pools_native[k].positions,
                                      pools_h5py[k].positions)
        np.testing.assert_array_equal(pools_native[k].counts,
                                      pools_h5py[k].counts)
        np.testing.assert_array_equal(pools_native[k].values,
                                      pools_h5py[k].values)


def test_native_raw_prepare_matches_python(tmp_path):
    """The C++ raw-read prepare (parse + event extraction + MAD normalize)
    must reproduce the Python specification bit-for-bit."""
    import numpy as np

    from fixtures import make_genome, make_raw_dataset
    from nanomod.io.fast5 import read_raw_basecall
    from nanomod.native.prepare_bind import native_prepare_batch
    from nanomod.signal.events import extract_events
    from nanomod.signal.normalize import mad_normalize

    chrom, genome = make_genome(length=1200, seed=5)
    rd_dir = str(tmp_path / "reads")
    make_raw_dataset(rd_dir, chrom, genome, n_reads=10, seed=6,
                     read_len=900, error_rate=0.03)
    paths = sorted(os.path.join(rd_dir, f) for f in os.listdir(rd_dir))
    res = native_prepare_batch(paths, "Basecall_1D_000",
                               "BaseCalled_template", 2)
    if res is None:
        pytest.skip("no C++ toolchain")
    for p, r in zip(paths, res):
        raw, err = read_raw_basecall(p)
        assert raw is not None, err
        ev = extract_events(raw)
        span = (int(ev.start[0]), int(ev.start[-1] + ev.length[-1]))
        norm = mad_normalize(raw.raw_signal, span, None)
        assert not isinstance(r, (str, type(None))), (p, r)
        assert r.read_id == raw.read_id
        assert r.seq == ev.seq
        np.testing.assert_array_equal(r.ev_start, ev.start.astype(np.int64))
        np.testing.assert_array_equal(r.ev_length, ev.length.astype(np.int64))
        np.testing.assert_array_equal(r.norm_signal, norm)


def test_native_raw_prepare_error_taxonomy(tmp_path):
    """Broken FAST5s map to the reference's error keys or fall back."""
    from nanomod.native.prepare_bind import native_prepare_batch

    import h5py
    # missing fastq
    p1 = str(tmp_path / "nofq.fast5")
    with h5py.File(p1, "w") as f:
        f.create_group("UniqueGlobalKey/channel_id").attrs["sampling_rate"] = 4000.0
        g = f.create_group("Raw/Reads/Read_0")
        g.attrs["start_time"] = 0
        g.create_dataset("Signal", data=np.zeros(10, np.int16))
    # not an HDF5 file
    p2 = str(tmp_path / "junk.fast5")
    with open(p2, "wb") as f:
        f.write(b"not hdf5 at all")
    # missing entirely
    p3 = str(tmp_path / "missing.fast5")
    res = native_prepare_batch([p1, p2, p3], "Basecall_1D_000",
                               "BaseCalled_template", 1)
    if res is None:
        pytest.skip("no C++ toolchain")
    assert res[0] == "No Fastq data"
    assert res[1] is None           # unclassified -> python fallback
    assert res[2] == "Cannot open fast5"


def _prepare_parity(paths):
    """Assert native_prepare_batch ≡ the Python prepare for given files."""
    from nanomod.io.fast5 import read_raw_basecall
    from nanomod.native.prepare_bind import native_prepare_batch
    from nanomod.signal.events import extract_events
    from nanomod.signal.normalize import mad_normalize

    res = native_prepare_batch(paths, "Basecall_1D_000",
                               "BaseCalled_template", 1)
    if res is None:
        pytest.skip("no C++ toolchain")
    for p, r in zip(paths, res):
        raw, err = read_raw_basecall(p)
        assert raw is not None, err
        ev = extract_events(raw)
        span = (int(ev.start[0]), int(ev.start[-1] + ev.length[-1]))
        norm = mad_normalize(raw.raw_signal, span, None)
        assert not isinstance(r, (str, type(None))), (p, r)
        assert r.seq == ev.seq
        np.testing.assert_array_equal(r.ev_start, ev.start.astype(np.int64))
        np.testing.assert_array_equal(r.ev_length,
                                      ev.length.astype(np.int64))
        np.testing.assert_array_equal(r.norm_signal, norm)


def test_native_raw_prepare_guppy(tmp_path):
    """Guppy dialect: Move table at stride 2 + Segmentation first sample."""
    rng = np.random.default_rng(7)
    p = str(tmp_path / "guppy.fast5")
    n_bases = 120
    fq_seq = "".join(rng.choice(list("ACGT"), n_bases))
    move = np.zeros(n_bases * 6, np.uint8)
    # ~1 base per 6 move rows (stride 2 -> 12 samples/base)
    one_rows = np.sort(rng.choice(np.arange(1, len(move)), n_bases - 1,
                                  replace=False))
    move[one_rows] = 1
    first = 10
    nsig = first + 2 * len(move) + 40
    dac = rng.integers(300, 700, nsig).astype(np.int16)
    with h5py.File(p, "w") as f:
        ch = f.create_group("UniqueGlobalKey/channel_id")
        ch.attrs["sampling_rate"] = 4000.0
        g = f.create_group("Raw/Reads/Read_7")
        g.attrs["start_time"] = 0
        g.create_dataset("Signal", data=dac)
        bc = f.create_group("Analyses/Basecall_1D_000")
        bc.attrs["name"] = b"Guppy Basecalling Software"
        bc.attrs["version"] = b"4.0.11"
        bt = bc.create_group("BaseCalled_template")
        bt.create_dataset("Move", data=move)
        fq = f"@gread\n{fq_seq}\n+\n{'!' * n_bases}\n"
        bt.create_dataset("Fastq", data=fq.encode())
        seg = f.create_group("Analyses/Segmentation_000/Summary/segmentation")
        seg.attrs["first_sample_template"] = first
    _prepare_parity([p])


def test_native_raw_prepare_albacore1(tmp_path):
    """Albacore 1.x dialect: time-indexed events with move-0 trimming."""
    rng = np.random.default_rng(8)
    p = str(tmp_path / "a1.fast5")
    rate = 4000.0
    n = 80
    seq = "".join(rng.choice(list("ACGT"), n))
    dt = np.dtype([("mean", "<f8"), ("stdv", "<f8"), ("start", "<f8"),
                   ("length", "<f8"), ("model_state", "S5"), ("move", "<i8")])
    ev = np.zeros(n, dt)
    ev["move"] = 1
    ev["move"][:3] = 0          # trimmed head
    ev["move"][-2:] = 0         # trimmed tail
    ev["move"][3] = 1
    dw = rng.integers(6, 14, n)
    t0 = 0.5
    starts_t = t0 + np.concatenate([[0], np.cumsum(dw[:-1])]) / rate
    ev["start"] = starts_t
    ev["length"] = dw / rate
    for i in range(n):
        ev["model_state"][i] = ("NN" + seq + "NN")[i: i + 5].encode()
    nsig = int(round(starts_t[-1] * rate)) + int(dw[-1]) + 1500
    dac = rng.integers(300, 700, nsig).astype(np.int16)
    with h5py.File(p, "w") as f:
        ch = f.create_group("UniqueGlobalKey/channel_id")
        ch.attrs["sampling_rate"] = rate
        g = f.create_group("Raw/Reads/Read_1")
        g.attrs["start_time"] = int(round(t0 * rate)) - 100
        g.create_dataset("Signal", data=dac)
        bc = f.create_group("Analyses/Basecall_1D_000")
        bc.attrs["name"] = b"ONT Albacore Sequencing Software"
        bc.attrs["version"] = b"1.2.6"
        bt = bc.create_group("BaseCalled_template")
        bt.create_dataset("Events", data=ev)
        fq = f"@a1read\n{seq}\n+\n{'!' * n}\n"
        bt.create_dataset("Fastq", data=fq.encode())
    _prepare_parity([p])


def _full_model(tmp_path):
    import itertools
    mpath = str(tmp_path / "model.txt")
    rng = np.random.default_rng(3)
    with open(mpath, "w") as f:
        f.write("#kmer\tlevel_mean\tlevel_stdv\n")
        for kmer in ("".join(t) for t in itertools.product("ACGT", repeat=5)):
            f.write(f"{kmer}\t{rng.uniform(60, 120):.5f}\t"
                    f"{rng.uniform(1, 3):.5f}\n")
    return mpath


def test_native_prepare_kmer_calibration(tmp_path):
    """Nanopolish-style shift/scale calibration in the native prepare must
    match the Python spec (weighted 2x2 solve + round-6 transform)."""
    from fixtures import ALBACORE2_EVENT_DTYPE
    from nanomod.io.fast5 import read_raw_basecall
    from nanomod.native.prepare_bind import (model_tables,
                                                 native_prepare_batch)
    from nanomod.signal.events import extract_events
    from nanomod.signal.normalize import (kmer_shift_scale,
                                              load_kmer_model, mad_normalize)

    rng = np.random.default_rng(9)
    n = 200
    seq = "".join(rng.choice(list("ACGT"), n + 4))
    ev = np.zeros(n, ALBACORE2_EVENT_DTYPE)
    dw = rng.integers(5, 15, n)
    ev["start"] = np.concatenate([[0], np.cumsum(dw[:-1])])
    ev["length"] = dw
    ev["move"] = 1
    ev["mean"] = rng.uniform(60, 120, n)
    ev["stdv"] = rng.uniform(0.5, 3, n)
    for i in range(n):
        ev["model_state"][i] = seq[i: i + 5].encode()   # clean ACGT 5-mers
    nsig = int(ev["start"][-1] + dw[-1])
    dac = rng.integers(300, 700, nsig).astype(np.int16)
    p = str(tmp_path / "cal.fast5")
    with h5py.File(p, "w") as f:
        ch = f.create_group("UniqueGlobalKey/channel_id")
        ch.attrs["sampling_rate"] = 4000.0
        g = f.create_group("Raw/Reads/Read_0")
        g.attrs["start_time"] = 0
        g.create_dataset("Signal", data=dac)
        bc = f.create_group("Analyses/Basecall_1D_000")
        bc.attrs["name"] = b"ONT Albacore Sequencing Software"
        bc.attrs["version"] = b"2.3.1"
        bt = bc.create_group("BaseCalled_template")
        bt.create_dataset("Events", data=ev)
        fq = f"@calread\n{seq[2: 2 + n]}\n+\n{'!' * n}\n"
        bt.create_dataset("Fastq", data=fq.encode())

    model = load_kmer_model(_full_model(tmp_path))
    tables = model_tables(model)
    assert tables is not None
    res = native_prepare_batch([p], "Basecall_1D_000",
                               "BaseCalled_template", 1, kmer_tables=tables)
    if res is None:
        pytest.skip("no C++ toolchain")
    r = res[0]
    assert not isinstance(r, (str, type(None))), r

    raw, _ = read_raw_basecall(p)
    et = extract_events(raw)
    ss = kmer_shift_scale(raw.events["mean"], raw.events["model_state"],
                          model)
    span = (int(et.start[0]), int(et.start[-1] + et.length[-1]))
    want = mad_normalize(raw.raw_signal, span, ss)
    np.testing.assert_array_equal(r.norm_signal, want)


def test_native_prepare_kmer_calibration_error(tmp_path):
    """Model states containing N -> 'Cannot nanopore correction' in both
    implementations (ref prepare_read KeyError handling)."""
    from fixtures import make_genome, make_raw_dataset
    from nanomod.native.prepare_bind import (model_tables,
                                                 native_prepare_batch)
    from nanomod.signal.normalize import load_kmer_model

    chrom, genome = make_genome(length=700, seed=4)
    rd_dir = str(tmp_path / "reads")
    # fixtures pad edge model_states with N -> calibration must fail
    make_raw_dataset(rd_dir, chrom, genome, n_reads=2, seed=5)
    paths = sorted(os.path.join(rd_dir, f) for f in os.listdir(rd_dir))
    model = load_kmer_model(_full_model(tmp_path))
    res = native_prepare_batch(paths, "Basecall_1D_000",
                               "BaseCalled_template", 1,
                               kmer_tables=model_tables(model))
    if res is None:
        pytest.skip("no C++ toolchain")
    assert all(r == "Cannot nanopore correction" for r in res)
