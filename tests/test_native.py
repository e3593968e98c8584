"""Differential tests: the C++ correction core must reproduce the Python
specification (resquiggle/annotate.py) on randomized reads."""

import numpy as np
import pytest

from nanomod.native.annotate_bind import native_annotate
from nanomod.native.build import native_available
from nanomod.resquiggle.annotate import (Columns, GenomeEvents,
                                             annotate_read, group_indels,
                                             mark_repeat_indels)

pytestmark = pytest.mark.skipif(not native_available("annotate_core"),
                                reason="no C++ toolchain")

BASES = np.array(list("ACGT"))


def _random_read(rng, n_cols=400, indel_rate=0.05, strand="+"):
    """Random aligned columns + consistent genome-ordered events + signal."""
    refb = []
    readb = []
    for _ in range(n_cols):
        r = rng.random()
        b = str(rng.choice(BASES))
        if r < indel_rate / 2:
            refb.append("-")            # insertion
            readb.append(b)
        elif r < indel_rate:
            refb.append(b)              # deletion
            readb.append("-")
        elif r < indel_rate + 0.02:
            refb.append(b)              # mismatch
            readb.append(str(rng.choice(BASES)))
        else:
            refb.append(b)
            readb.append(b)
    refb = np.array(refb, "<U1")
    readb = np.array(readb, "<U1")
    n_events = int((readb != "-").sum())

    # events in genome order; raw spans consistent with strand convention
    dwell = rng.integers(5, 15, n_events)
    if strand == "+":
        starts = np.concatenate([[0], np.cumsum(dwell[:-1])])
    else:
        # genome event g maps to read event (n-1-g): later genome events
        # come earlier in the raw signal
        rev = np.concatenate([[0], np.cumsum(dwell[::-1][:-1])])
        starts = rev[::-1]
    raw_len = int(dwell.sum())
    raw = np.round(rng.normal(0, 1, raw_len), 3)
    return refb, readb, starts.astype(np.int64), dwell.astype(np.int64), raw


@pytest.mark.parametrize("strand", ["+", "-"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_native_matches_python(strand, seed):
    rng = np.random.default_rng(seed)
    refb, readb, ev_start, ev_len, raw = _random_read(rng, strand=strand)

    # python reference path
    cols_py = Columns(refb.copy(), readb.copy())
    indel_pos = mark_repeat_indels(cols_py)
    events = GenomeEvents(ev_start, ev_len, strand)
    groups = group_indels(indel_pos, events, cols_py, min_num_signal=4,
                          more_signal_perc=0.3)
    ann_py, hist_py = annotate_read(cols_py, events, raw, groups,
                                    resegment_signal_wind=4, min_num_signal=4)

    # native path
    res = native_annotate(refb.copy(), readb.copy(), ev_start, ev_len,
                          strand, raw, 4, 4, 0.3)
    assert res is not None
    ann_c, hist_c, readb_c = res

    np.testing.assert_array_equal(readb_c, cols_py.readbase)
    assert hist_c == dict(hist_py), (hist_c, dict(hist_py))

    keys_py = {k for k, v in ann_py.items() if len(v) >= 3}
    assert set(ann_c) == keys_py
    for k in sorted(keys_py):
        _, m_p, s_p, st_p, ln_p = ann_py[k]
        _, m_c, s_c, st_c, ln_c = ann_c[k]
        assert st_c == st_p and ln_c == ln_p, f"col {k} span"
        assert m_c == pytest.approx(m_p, abs=1.1e-3), f"col {k} mean"
        assert s_c == pytest.approx(s_p, abs=1.1e-3), f"col {k} std"


def test_native_speedup():
    import time
    rng = np.random.default_rng(7)
    refb, readb, ev_start, ev_len, raw = _random_read(rng, n_cols=2000)

    t0 = time.time()
    for _ in range(3):
        native_annotate(refb.copy(), readb.copy(), ev_start, ev_len, "+",
                        raw, 4, 4, 0.3)
    t_native = (time.time() - t0) / 3

    cols = Columns(refb.copy(), readb.copy())
    t0 = time.time()
    ip = mark_repeat_indels(cols)
    ev = GenomeEvents(ev_start, ev_len, "+")
    gr = group_indels(ip, ev, cols, 4, 0.3)
    annotate_read(cols, ev, raw, gr, 4, 4)
    t_py = time.time() - t0
    assert t_native < t_py, (t_native, t_py)
    print(f"native {t_native*1e3:.1f}ms vs python {t_py*1e3:.1f}ms "
          f"({t_py/max(t_native,1e-9):.0f}x)")


def test_native_traceback_matches_python():
    import jax
    import numpy as np
    from nanomod.resquiggle.banded import (banded_sw, traceback,
                                               traceback_native)
    from nanomod.resquiggle.seed import encode

    rng = np.random.default_rng(3)
    genome = "".join(rng.choice(BASES, 800))
    frag = list(genome[100:500])
    # plant errors
    for _ in range(12):
        i = rng.integers(1, len(frag) - 1)
        r = rng.random()
        if r < 0.4:
            frag[i] = str(rng.choice(BASES))
        elif r < 0.7:
            frag[i] = frag[i] + str(rng.choice(BASES))
        else:
            frag[i] = ""
    read = "".join(frag)
    W, M = 128, len(read)
    ws = 100 - W // 2
    ref_codes = np.full((1, M + W), 5, np.uint8)
    rc = encode(genome[max(ws, 0): ws + M + W]).astype(np.uint8)
    ref_codes[0, : len(rc)] = rc
    read_codes = encode(read).astype(np.uint8)[None, :]
    tb, best, bi, bk = banded_sw(read_codes, ref_codes,
                                 np.array([M], np.int32))
    tb = np.asarray(tb)
    ops_py = traceback(tb[0], int(bi[0]), int(bk[0]), M)
    ops_c = traceback_native(tb[0], int(bi[0]), int(bk[0]))
    assert ops_c == ops_py


def _planted_batch(rng, n_reads, genome_len=900, frag=(80, 520)):
    """Random genome + error-planted fragments encoded for banded_sw."""
    from nanomod.resquiggle.seed import encode

    genome = "".join(rng.choice(BASES, genome_len))
    reads = []
    for _ in range(n_reads):
        fr = list(genome[frag[0]: frag[1]])
        for _ in range(14):
            i = rng.integers(1, len(fr) - 1)
            r = rng.random()
            if r < 0.4:
                fr[i] = str(rng.choice(BASES))
            elif r < 0.7:
                fr[i] = fr[i] + str(rng.choice(BASES))
            else:
                fr[i] = ""
        reads.append("".join(fr))
    W = 128
    M = max(len(r) for r in reads)
    ws = frag[0] - W // 2
    read_codes = np.full((n_reads, M), 4, np.uint8)
    ref_codes = np.full((n_reads, M + W), 5, np.uint8)
    lens = np.zeros(n_reads, np.int32)
    for i, r in enumerate(reads):
        lens[i] = len(r)
        read_codes[i, : len(r)] = encode(r).astype(np.uint8)
        rc = encode(genome[max(ws, 0): ws + M + W]).astype(np.uint8)
        ref_codes[i, : len(rc)] = rc
    return read_codes, ref_codes, lens


@pytest.mark.skipif(not native_available("traceback"),
                    reason="no C++ toolchain")
def test_batch_traceback_packed_matches_python():
    """traceback_batch (packed and unpacked) must reproduce the Python
    walker op-for-op across a whole batch."""
    from nanomod.resquiggle.banded import (banded_sw, ops_to_arrays,
                                               pack_tb, traceback,
                                               traceback_batch_native)

    rng = np.random.default_rng(7)
    read_codes, ref_codes, lens = _planted_batch(rng, 9)
    tb, best, bi, bk = banded_sw(read_codes, ref_codes, lens)
    tb = np.asarray(tb)
    tbp = np.asarray(pack_tb(tb))
    bi = np.asarray(bi)
    bk = np.asarray(bk)

    got_plain = traceback_batch_native(tb, bi, bk, packed=False, nthreads=3)
    got_packed = traceback_batch_native(tbp, bi, bk, packed=True, nthreads=3)
    for b in range(len(lens)):
        want = ops_to_arrays(traceback(tb[b], int(bi[b]), int(bk[b]),
                                       int(lens[b])))
        for got in (got_plain[b], got_packed[b]):
            for w_arr, g_arr in zip(want, got):
                np.testing.assert_array_equal(w_arr, g_arr)


def test_annotate_one_native_matches_python_path(tmp_path):
    """annotate_one's vectorized native path must produce the same payload
    as the pure-Python specification path on real pipeline reads."""
    import os

    from fixtures import make_genome, make_raw_dataset
    from nanomod.config import AnnotateConfig, replace
    from nanomod.io.fasta import FastaIndex
    from nanomod.resquiggle.pipeline import (align_batch, annotate_one,
                                                 prepare_read)
    from nanomod.resquiggle.seed import SeedIndex

    chrom, genome = make_genome(length=700, seed=11)
    fasta_p = str(tmp_path / "ref.fa")
    with open(fasta_p, "w") as f:
        f.write(f">{chrom}\n{genome}\n")
    rd_dir = str(tmp_path / "reads")
    make_raw_dataset(rd_dir, chrom, genome, n_reads=10, seed=12,
                     error_rate=0.04)
    cfg = AnnotateConfig(ref_fasta=fasta_p)
    cfg_py = replace(cfg, use_native=False)
    fasta = FastaIndex(fasta_p)
    sidx = SeedIndex(fasta.seqs, k=cfg.seed_k)

    prepared = []
    for name in sorted(os.listdir(rd_dir)):
        rd, _ = prepare_read(os.path.join(rd_dir, name), cfg, sidx, None)
        if rd is not None:
            prepared.append(rd)
    assert len(prepared) >= 8
    results = align_batch(prepared, fasta, cfg)
    n_checked = 0
    for r, (ops, ws) in zip(prepared, results):
        if ops is None:
            continue
        pay_c, err_c = annotate_one(r, ops, ws, fasta, cfg)
        pay_p, err_p = annotate_one(r, ops, ws, fasta, cfg_py)
        assert (pay_c is None) == (pay_p is None) and err_c == err_p
        if pay_c is None:
            continue
        n_checked += 1
        for key in pay_p:
            a, b = pay_c[key], pay_p[key]
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=key)
            else:
                assert a == b, (key, a, b)
    assert n_checked >= 6


def test_device_walk_matches_python_walker():
    """walk_device (on-device lockstep traceback) + decode must reproduce
    the Python matrix walker op-for-op, via both decoders."""
    from nanomod.resquiggle.banded import (banded_sw, decode_walk,
                                               decode_walk_native,
                                               ops_to_arrays, traceback,
                                               walk_device)

    rng = np.random.default_rng(11)
    read_codes, ref_codes, lens = _planted_batch(rng, 7)
    tb, best, bi, bk = banded_sw(read_codes, ref_codes, lens)
    codes = np.asarray(walk_device(tb, bi, bk))
    tb = np.asarray(tb)
    bi = np.asarray(bi)
    bk = np.asarray(bk)
    dec_native = decode_walk_native(codes, bi, bk, nthreads=2)
    for i in range(len(lens)):
        want = traceback(tb[i], int(bi[i]), int(bk[i]), int(lens[i]))
        assert decode_walk(codes[i], int(bi[i]), int(bk[i])) == want
        if dec_native is not None:
            for a, b in zip(ops_to_arrays(want), dec_native[i]):
                np.testing.assert_array_equal(a, b)

def test_annotate_codes_batch_matches_per_read(tmp_path):
    """The one-call batched native annotate (annotate_codes_batch) must
    produce byte-identical payloads to the per-read annotate_one path on
    real pipeline reads, both strands, including error statuses."""
    import os

    from fixtures import make_genome, make_raw_dataset
    from nanomod.config import AnnotateConfig
    from nanomod.io.fasta import FastaIndex
    from nanomod.native.annotate_bind import annotate_codes_batch_native
    from nanomod.resquiggle.banded import unpack_outputs
    from nanomod.resquiggle.pipeline import (annotate_one, dispatch_dp,
                                                 finish_alignment,
                                                 prepare_read)
    from nanomod.resquiggle.seed import SeedIndex

    chrom, genome = make_genome(length=900, seed=21)
    fasta_p = str(tmp_path / "ref.fa")
    with open(fasta_p, "w") as f:
        f.write(f">{chrom}\n{genome}\n")
    rd_dir = str(tmp_path / "reads")
    make_raw_dataset(rd_dir, chrom, genome, n_reads=12, seed=22,
                     error_rate=0.05)
    cfg = AnnotateConfig(ref_fasta=fasta_p)
    fasta = FastaIndex(fasta_p)
    sidx = SeedIndex(fasta.seqs, k=cfg.seed_k)

    prepared = []
    for name in sorted(os.listdir(rd_dir)):
        rd, _ = prepare_read(os.path.join(rd_dir, name), cfg, sidx, None)
        if rd is not None:
            prepared.append(rd)
    assert len(prepared) >= 10
    batch = dispatch_dp(prepared, fasta, cfg)
    assert batch.mode in ("codes", "codes2")
    tb, best, bi, bk = unpack_outputs(np.asarray(batch.packed),
                                      batch.tail_shape)
    n = len(prepared)
    from nanomod.resquiggle.pipeline import _min_score
    accept = np.array(
        [best[i] >= _min_score(cfg, int(batch.lens[i])) for i in range(n)],
        np.uint8)
    res = annotate_codes_batch_native(
        tb[:n], bi[:n], bk[:n], accept, batch.win_starts[:n], prepared,
        fasta, cfg.min_num_signal, cfg.resegment_signal_wind,
        cfg.more_signal_perc, nthreads=2, packed=batch.mode == "codes2")
    assert res is not None

    ref_results = finish_alignment(batch, cfg)
    n_checked = 0
    for i, r in enumerate(prepared):
        ops, ws = ref_results[i]
        pay_b, err_b = res[i]
        if ops is None:
            assert pay_b is None and err_b == "skip"
            continue
        pay_a, err_a = annotate_one(r, ops, ws, fasta, cfg)
        assert (pay_a is None) == (pay_b is None)
        if pay_a is None:
            assert err_b == err_a
            continue
        for key in pay_a:
            a, b = pay_a[key], pay_b[key]
            if isinstance(a, np.ndarray):
                assert a.tobytes() == b.tobytes(), key
            else:
                assert a == b, (key, a, b)
        n_checked += 1
    assert n_checked >= 8


def test_pack_unpack_outputs_roundtrip():
    """pack_outputs/unpack_outputs must round-trip scores and indices
    bit-exactly in every tb mode (plain / packed / codes) so an XLA layout
    or endianness change fails loudly (advisor finding, round 3)."""
    import jax.numpy as jnp

    from nanomod.resquiggle.banded import pack_outputs, unpack_outputs

    rng = np.random.default_rng(5)
    for tail in ((16, 8), (24,)):          # [M, W] tb modes and codes mode
        tb = rng.integers(0, 255, (4,) + tail).astype(np.uint8)
        best = rng.normal(0, 1000, 4).astype(np.float32)
        bi = rng.integers(-3, 3000, 4).astype(np.int32)
        bk = rng.integers(0, 127, 4).astype(np.int32)
        packed = pack_outputs(jnp.asarray(tb), jnp.asarray(best),
                              jnp.asarray(bi), jnp.asarray(bk))
        tb2, best2, bi2, bk2 = unpack_outputs(np.asarray(packed), tail)
        np.testing.assert_array_equal(tb2, tb)
        np.testing.assert_array_equal(bi2, bi)
        np.testing.assert_array_equal(bk2, bk)
        # scores survive to the precision the packing promises
        # (round-to-nearest int32, exact for integral score configs)
        np.testing.assert_array_equal(best2,
                                      np.round(best).astype(np.int32))


def test_radix_sort_u64_hi_matches_np_sort():
    """Direct unit test of the grouped radix sort (nm_radix_sort_u64_hi)
    against np.sort over composite pool keys, including all-constant high
    bytes and multi-thread paths (ADVICE r4: the pack-vs-numpy e2e test
    routed BOTH sides through this sort, so a shared ordering bug would
    have passed)."""
    import ctypes

    from nanomod.native.build import load_native

    lib = load_native("sort_core")
    if lib is None or not hasattr(lib, "nm_radix_sort_u64_hi"):
        pytest.skip("native sort_core unavailable")

    def run_native(keys, nthreads, hi_byte):
        k = keys.copy()
        scratch = np.empty_like(k)
        p = ctypes.POINTER(ctypes.c_uint64)
        lib.nm_radix_sort_u64_hi(
            k.ctypes.data_as(p), ctypes.c_int64(len(k)),
            scratch.ctypes.data_as(p), ctypes.c_int(nthreads),
            ctypes.c_int(hi_byte))
        return k

    rng = np.random.default_rng(0)
    n = (1 << 16) + 2345                     # above the std::sort cutoff
    # composite pool keys: position<<35 | monotone-float<<3 | code
    pos = rng.integers(0, 5000, n).astype(np.uint64)
    val = rng.integers(0, 1 << 32, n).astype(np.uint64)
    cod = rng.integers(0, 5, n).astype(np.uint64)
    keys = (pos << np.uint64(35)) | (val << np.uint64(3)) | cod
    cases = {
        "composite": keys,
        # all high bytes constant: radix passes skip, run-local sort does
        # ALL the work on one giant run
        "const_high": (np.uint64(7) << np.uint64(35)) | (val << np.uint64(3)) | cod,
        # fully random u64
        "random": rng.integers(0, 1 << 63, n).astype(np.uint64),
        # many duplicate keys
        "dupes": (pos % np.uint64(7)) << np.uint64(35) | (val % np.uint64(3)),
    }
    for name, ks in cases.items():
        expect = np.sort(ks)
        for nthreads in (1, 4):
            got = run_native(ks, nthreads, hi_byte=4)
            np.testing.assert_array_equal(got, expect, err_msg=f"{name}/nt{nthreads}")
