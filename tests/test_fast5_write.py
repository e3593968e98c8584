"""Native FAST5 writer (native/fast5_write.cpp) parity vs the h5py writer.

The native writer appends the corrected-annotation objects past EOF and
patches the parent symbol table; these tests pin that the result is a valid
HDF5 file that h5py (libhdf5) reads back byte-identically to what the h5py
writer produces, that the original content survives, and that libhdf5 can
still mutate the rebuilt group afterwards.
"""

import os

import h5py
import numpy as np
import pytest

from nanomod.io.fast5 import (CORRECTED_EVENTS_DTYPE,
                                  read_corrected_events,
                                  write_corrected_events)
from nanomod.native.build import native_available
from nanomod.native.fast5_write_bind import write_corrected_batch_native

pytestmark = pytest.mark.skipif(not native_available("fast5_write"),
                                reason="no native toolchain")


def _base_file(path, extra_analyses=()):
    with h5py.File(path, "w") as f:
        f.create_dataset("Raw/Reads/Read_7/Signal",
                         data=np.arange(100, dtype=np.int16))
        f["Raw/Reads/Read_7"].attrs["read_id"] = np.bytes_("r7")
        an = f.create_group("Analyses")
        an.create_group("Basecall_1D_000/BaseCalled_template")
        for name in extra_analyses:
            an.create_group(name)
        ug = f.create_group("UniqueGlobalKey/channel_id")
        ug.attrs["digitisation"] = 8192.0


def _payload(rng, n_events=40, n_cols=44, chrom="chrA", strand="+"):
    ev = np.zeros(n_events, CORRECTED_EVENTS_DTYPE)
    ev["norm_mean"] = np.round(rng.normal(0, 1, n_events), 3)
    ev["norm_stdev"] = np.round(rng.uniform(0, 1, n_events), 3)
    ev["start"] = np.arange(n_events) * 7
    ev["length"] = 7
    ev["base"] = np.frombuffer(
        rng.choice(list(b"ACGT"), n_events).astype(np.uint8).tobytes(),
        dtype="S1")
    cols = rng.choice(list(b"ACGT-"), n_cols).astype(np.uint8)
    return {
        "chrom": chrom, "start": int(rng.integers(0, 10000)),
        "strand": strand, "events": ev,
        "read_alignment": cols.view("S1"),
        "genome_alignment": cols[::-1].copy().view("S1"),
        "clipped_start": 3, "clipped_end": 5, "num_insertions": 2,
        "num_deletions": 1, "num_matches": 37, "num_mismatches": 4,
    }


def _dump(path):
    """Full logical content of an HDF5 file for comparison."""
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            attrs = {k: (v.tolist() if hasattr(v, "tolist") else v)
                     for k, v in obj.attrs.items()}
            if isinstance(obj, h5py.Dataset):
                out[name] = ("ds", str(obj.dtype), obj[...].tobytes(), attrs)
            else:
                out[name] = ("grp", attrs)
        f.visititems(visit)
    return out


def test_native_matches_h5py(tmp_path):
    rng = np.random.default_rng(0)
    pays = [_payload(rng, n_events=10 + 17 * i, n_cols=12 + 19 * i,
                     strand="+-"[i % 2]) for i in range(6)]
    p_nat, p_h5 = [], []
    for i in range(len(pays)):
        a = str(tmp_path / f"nat_{i}.fast5")
        b = str(tmp_path / f"h5_{i}.fast5")
        _base_file(a)
        _base_file(b)
        p_nat.append(a)
        p_h5.append(b)
    ok = write_corrected_batch_native(p_nat, pays, nthreads=2)
    assert ok is not None and ok.all(), ok
    for path, pay in zip(p_h5, pays):
        write_corrected_events(path, **pay)
    for a, b in zip(p_nat, p_h5):
        da, db = _dump(a), _dump(b)
        assert set(da) == set(db)
        for name in db:
            if da[name][0] == "ds":
                assert da[name][1] == db[name][1], name      # dtype
                assert da[name][2] == db[name][2], name      # bytes
            assert da[name][-1] == db[name][-1], name        # attrs


def test_readback_via_engine_reader(tmp_path):
    rng = np.random.default_rng(1)
    pay = _payload(rng, chrom="spel", strand="-")
    path = str(tmp_path / "r.fast5")
    _base_file(path)
    ok = write_corrected_batch_native([path], [pay])
    assert ok is not None and ok[0]
    rd = read_corrected_events(path)
    assert rd is not None
    assert rd.chrom == "spel" and rd.strand == "-"
    np.testing.assert_allclose(rd.norm_mean, pay["events"]["norm_mean"])
    # native batch reader too
    from nanomod.native.fast5_bind import read_corrected_batch
    nat = read_corrected_batch([path], nthreads=1)
    if nat is not None:
        assert nat[0] is not None
        np.testing.assert_allclose(nat[0].norm_mean,
                                   pay["events"]["norm_mean"])


def test_replace_idempotent(tmp_path):
    rng = np.random.default_rng(2)
    path = str(tmp_path / "rr.fast5")
    _base_file(path)
    first = _payload(rng, n_events=30)
    second = _payload(rng, n_events=55, chrom="chrB")
    assert write_corrected_batch_native([path], [first])[0]
    assert write_corrected_batch_native([path], [second])[0]
    rd = read_corrected_events(path)
    assert rd.chrom == "chrB"
    assert len(rd.norm_mean) == 55
    # original content intact
    with h5py.File(path, "r") as f:
        assert f["Raw/Reads/Read_7/Signal"][...].sum() == np.arange(100).sum()


def test_native_then_h5py_replace(tmp_path):
    """h5py (libhdf5) must be able to mutate the rebuilt symbol table."""
    rng = np.random.default_rng(3)
    path = str(tmp_path / "nh.fast5")
    _base_file(path)
    assert write_corrected_batch_native([path], [_payload(rng)])[0]
    pay = _payload(rng, n_events=20, chrom="chrC")
    write_corrected_events(path, **pay)          # h5py delete + recreate
    rd = read_corrected_events(path)
    assert rd.chrom == "chrC" and len(rd.norm_mean) == 20
    with h5py.File(path, "r+") as f:
        f["Analyses"].create_group("Later_000")  # libhdf5 insert
    with h5py.File(path, "r") as f:
        assert "Later_000" in f["Analyses"]


def test_many_analyses_children(tmp_path):
    """>8 children forces the multi-SNOD symbol-table path."""
    rng = np.random.default_rng(4)
    path = str(tmp_path / "many.fast5")
    _base_file(path, extra_analyses=[f"Extra_{i:03d}" for i in range(11)])
    assert write_corrected_batch_native([path], [_payload(rng)])[0]
    with h5py.File(path, "r") as f:
        kids = sorted(f["Analyses"])
        assert "NanomoCorrected_000" in kids
        assert len(kids) == 13
    assert read_corrected_events(path) is not None


def test_missing_analyses_created(tmp_path):
    rng = np.random.default_rng(5)
    path = str(tmp_path / "noan.fast5")
    with h5py.File(path, "w") as f:
        f.create_dataset("Raw/Reads/Read_1/Signal", data=np.zeros(4, np.int16))
    assert write_corrected_batch_native([path], [_payload(rng)])[0]
    rd = read_corrected_events(path)
    assert rd is not None


def test_newstyle_file_falls_back(tmp_path):
    rng = np.random.default_rng(6)
    path = str(tmp_path / "latest.fast5")
    with h5py.File(path, "w", libver="latest") as f:
        f.create_group("Analyses")
    ok = write_corrected_batch_native([path], [_payload(rng)])
    assert ok is not None and not ok[0]          # declined, not corrupted
    with h5py.File(path, "r") as f:              # file untouched and valid
        assert "Analyses" in f
