"""Reference-golden parity: detect output must BYTE-match the checked-in
golden `_sign_test.txt` files produced by the independent scipy-only oracle
(tests/golden/make_golden.py — reference formulas from myDetect.py, no
nanomod statistics code).

Covers all three testMethods, the neighborPvalues=0 KS-copy edge
(myDetect.py:413), the capped repeated-subsample KS, the _meanstd.cvs file,
the `%.3f`/`%.3E` rendering and 1-based positions — on the pool path, the
full FAST5 ingest path, and the position-sharded multi-chip path.
"""

import os

import numpy as np
import pytest

from nanomod.accum.pools import PoolBuilder
from nanomod.config import DetectConfig, RankConfig, StatConfig
from nanomod.detect import detect_from_pools, run_detect, save_sign_test

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

VARIANTS = {
    "stouffer": dict(stats=StatConfig(test_method="stouffer")),
    "fisher": dict(stats=StatConfig(test_method="fisher")),
    "ks": dict(stats=StatConfig(test_method="ks")),
    "nb0": dict(stats=StatConfig(test_method="stouffer", neighbor_pvalues=0)),
    "capped": dict(stats=StatConfig(test_method="stouffer",
                                    coverages=(8, 8), downsampling=20,
                                    downsampling_quantile=0.25,
                                    downsampling_seed=0),
                   mstd=True),
}


def _load_group(group):
    z = np.load(os.path.join(GOLDEN, "reads.npz"))
    for i in range(len(z[f"{group}_chrom"])):
        yield (str(z[f"{group}_chrom"][i]), str(z[f"{group}_strand"][i]),
               int(z[f"{group}_start"][i]), z[f"{group}_vals"][i],
               z[f"{group}_bases"][i])


@pytest.fixture(scope="module")
def pools():
    out = []
    for group in ("group1", "group2"):
        b = PoolBuilder()
        for chrom, strand, start, vals, bases in _load_group(group):
            b.add_read(chrom, strand, start, vals, bases)
        out.append(b.finalize())
    return out


def _golden(name):
    with open(os.path.join(GOLDEN, f"golden_{name}_sign_test.txt"), "rb") as f:
        return f.read()


def _run(pools, tmp_path, name, n_devices=0):
    kw = dict(VARIANTS[name])
    cfg = DetectConfig(out_folder=str(tmp_path), file_id=name,
                       n_devices=n_devices, **kw)
    table, order = detect_from_pools(pools[0], pools[1], cfg)
    path = save_sign_test(table, cfg)
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_golden_sign_test(pools, tmp_path, name):
    got = _run(pools, tmp_path, name)
    want = _golden(name)
    assert len(want) > 10_000
    assert got == want


@pytest.mark.parametrize("name", ["stouffer", "capped"])
def test_golden_sign_test_sharded(pools, tmp_path, name):
    """The 8-device sharded path must hit the same golden bytes."""
    assert _run(pools, tmp_path, name, n_devices=8) == _golden(name)


def test_golden_meanstd(pools, tmp_path):
    _run(pools, tmp_path, "capped")
    with open(os.path.join(str(tmp_path), "capped_meanstd.cvs"), "rb") as f:
        got = f.read()
    with open(os.path.join(GOLDEN, "golden_capped_meanstd.cvs"), "rb") as f:
        want = f.read()
    assert len(want) > 5_000
    assert got == want


def test_golden_end_to_end_fast5(tmp_path):
    """Full run_detect over FAST5 folders written from the golden reads:
    ingest -> pools -> battery -> combine -> save must hit the golden
    bytes (exercises the writer/reader strand + coordinate bookkeeping)."""
    import h5py

    from nanomod.io.fast5 import (CORRECTED_EVENTS_DTYPE,
                                      write_corrected_events)

    for gi, group in enumerate(("group1", "group2")):
        folder = tmp_path / f"g{gi + 1}"
        folder.mkdir()
        for i, (chrom, strand, start, vals, bases) in enumerate(
                _load_group(group)):
            p = str(folder / f"read_{i:04d}.fast5")
            with h5py.File(p, "w"):
                pass
            ev = np.zeros(len(vals), CORRECTED_EVENTS_DTYPE)
            ev["norm_mean"] = vals
            ev["norm_stdev"] = 0.1
            ev["start"] = np.arange(len(vals), dtype=np.uint32) * 8
            ev["length"] = 8
            ev["base"] = bases
            write_corrected_events(
                p, chrom=chrom, start=start, strand=strand, events=ev,
                read_alignment=bases, genome_alignment=bases)

    cfg = DetectConfig(wrk_base1=str(tmp_path / "g1"),
                       wrk_base2=str(tmp_path / "g2"),
                       out_folder=str(tmp_path / "out"), file_id="e2e",
                       min_lr=0, rank=RankConfig(window=4),
                       stats=StatConfig(test_method="stouffer"))
    run_detect(cfg)
    with open(str(tmp_path / "out" / "e2e_sign_test.txt"), "rb") as f:
        got = f.read()
    assert got == _golden("stouffer")
