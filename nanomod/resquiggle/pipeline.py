"""The Annotate pipeline: raw FAST5 -> indel-corrected per-base annotation.

Rebuild of ``correctAndAnnotate``
(ref bin/scripts/myRefBaseSignalAnnotation.py:393-460): instead of shelling
out to bwa/minimap2 and walking SAM CIGARs per base in Python, reads are
k-mer seeded (resquiggle/seed.py) and aligned by a batched banded affine DP
on device (resquiggle/banded.py); the indel-correction core
(resquiggle/annotate.py) then reassigns raw-signal segments to reference
bases and the result is written back into each FAST5
(NanomoCorrected_000, io/fast5.py).
"""

from __future__ import annotations

import os
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from nanomod.config import AnnotateConfig
from nanomod.io.fast5 import (CORRECTED_EVENTS_DTYPE,
                                  compress_corrected_arrays,
                                  iter_fast5_files, read_raw_basecall,
                                  write_corrected_events)
from nanomod.io.fasta import FastaIndex, complement
from nanomod.resquiggle import annotate as ann_mod
from nanomod.resquiggle.annotate import Columns, GenomeEvents
from nanomod.resquiggle.banded import banded_sw, traceback
from nanomod.resquiggle.seed import SeedIndex, encode
from nanomod.signal.events import EventError, extract_events
from nanomod.signal.normalize import (kmer_shift_scale, load_kmer_model,
                                          mad_normalize)


@dataclass
class PreparedRead:
    path: str
    read_id: str
    fwd_seq: str            # genome-forward-oriented basecall
    chrom: str
    strand: str
    diag: int               # approximate genome start of the fwd read
    events_start: np.ndarray   # read-order raw starts (samples)
    events_length: np.ndarray
    norm_signal: np.ndarray    # normalized raw signal


def _host_workers(cfg: AnnotateConfig, cap: int = 16) -> int:
    """Host-side thread count: cfg.threads clamped to the machine.

    Oversubscribing Python threads past the core count *slows* the
    GIL-releasing stages (numpy/ctypes/h5py) through lock churn, so the
    real core count is the ceiling, cfg.threads the request."""
    return max(1, min(cfg.threads, os.cpu_count() or 1, cap))


def _min_score(cfg: AnnotateConfig, read_len: int) -> int:
    """Alignment acceptance threshold — ONE definition for the batched
    native path, the per-read fallback, and the tests."""
    return max(20, int(0.3 * cfg.match_score * read_len))


def _length_bucket(m: int, buckets=(256, 512, 1024, 2048, 4096, 8192, 16384)) -> int:
    for b in buckets:
        if m <= b:
            return b
    return ((m + 16383) // 16384) * 16384


def prepare_read(path: str, cfg: AnnotateConfig, seed_index: SeedIndex,
                 kmer_model) -> Tuple[Optional[PreparedRead], str]:
    """Load + extract events + normalize + seed one read.

    Error keys follow the reference taxonomy
    (ref myRefBaseSignalAnnotation.py:45-48 raiseError call sites).
    """
    raw, err = read_raw_basecall(path, cfg.basecall_1d, cfg.basecall_2strand)
    if raw is None:
        return None, err
    try:
        ev = extract_events(raw)
    except EventError as e:
        return None, e.key

    shift_scale = None
    if kmer_model is not None and raw.events is not None:
        try:
            shift_scale = kmer_shift_scale(
                raw.events["mean"], raw.events["model_state"], kmer_model
            )
        except (KeyError, np.linalg.LinAlgError):
            return None, "Cannot nanopore correction"

    span = (int(ev.start[0]), int(ev.start[-1] + ev.length[-1]))
    if span[1] > len(raw.raw_signal):
        return None, "No Raw_reads/Signal"
    norm = mad_normalize(raw.raw_signal, span, shift_scale)

    return _seed_and_wrap(path, raw.read_id, ev.seq, ev.start, ev.length,
                          norm, seed_index,
                          require_seed=(cfg.align == "dp"))


@dataclass
class DPBatch:
    """An in-flight banded-DP batch (device arrays not yet fetched)."""

    reads: List[PreparedRead]
    packed: object             # [B, 12 + .] uint8: best|best_i|best_k|tb
                               # (banded.pack_outputs); the tb payload is
                               # mode 'plain': [M, W] traceback rows,
                               # 'packed': nibble-packed [M, W//2],
                               # 'codes': device-walk op codes [2M+W]
    tail_shape: tuple          # tb payload shape per read
    lens: np.ndarray
    win_starts: np.ndarray
    mode: str


def dispatch_dp(reads: List[PreparedRead], fasta: FastaIndex,
                cfg: AnnotateConfig, pad_bsz: int = 0,
                device=None) -> Optional[DPBatch]:
    """Build + dispatch the banded DP for a length-bucketed batch.

    Returns immediately (JAX dispatch is async) so the device computes
    while the host annotates a previous batch.  The traceback is walked on
    device and only its 2-bit op codes are fetched.  pad_bsz pads the
    batch dimension to a fixed size so sub-batches share one jit shape.

    ``device`` commits the batch to a specific jax device: every jitted
    stage (DP, device walk, 2-bit pack, output pack) follows its inputs,
    so the whole dispatch chain runs there — the multi-chip fan-out just
    round-robins sub-batches over jax.local_devices()
    (process_prepared, cfg.n_devices).
    """
    if not reads:
        return None
    w = cfg.band_width
    m = _length_bucket(max(len(r.fwd_seq) for r in reads))
    bsz = max(len(reads), pad_bsz)
    read_codes = np.full((bsz, m), 4, np.uint8)
    ref_codes = np.full((bsz, m + w), 5, np.uint8)
    lens = np.zeros(bsz, np.int32)
    win_starts = np.zeros(bsz, np.int64)
    for i, r in enumerate(reads):
        seq = r.fwd_seq
        lens[i] = len(seq)
        read_codes[i, : len(seq)] = encode(seq).astype(np.uint8)
        genome = fasta.get(r.chrom)
        ws = r.diag - w // 2
        win_starts[i] = ws
        lo = max(ws, 0)
        hi = min(ws + m + w, len(genome))
        if hi > lo:
            ref_codes[i, lo - ws: hi - ws] = encode(genome[lo:hi]).astype(np.uint8)

    read_codes_d, ref_codes_d, lens_d = read_codes, ref_codes, lens
    if device is not None:
        import jax
        read_codes_d = jax.device_put(read_codes, device)
        ref_codes_d = jax.device_put(ref_codes, device)
        lens_d = jax.device_put(lens, device)
    tb, best, bi, bk = banded_sw(
        read_codes_d, ref_codes_d, lens_d,
        match=cfg.match_score, mismatch=cfg.mismatch_score,
        go=cfg.gap_open, ge=cfg.gap_extend,
    )
    mode = "plain"
    if cfg.use_device_walk:
        # walk the traceback on device: only op codes are fetched;
        # 2-bit-pack them (4 steps/byte) when the native decoder that
        # reads packed rows is present — quarters the transfer
        from nanomod.resquiggle.banded import pack_codes2, walk_device
        tb = walk_device(tb, bi, bk)
        mode = "codes"
        if cfg.use_native:
            from nanomod.native.build import native_available
            if native_available("traceback") and tb.shape[1] % 4 == 0:
                tb = pack_codes2(tb)
                mode = "codes2"
    elif cfg.use_native and w % 2 == 0:
        from nanomod.native.build import load_native
        if load_native("traceback") is not None:
            from nanomod.resquiggle.banded import pack_tb
            tb = pack_tb(tb)
            mode = "packed"
    # one fetchable array + an async D2H start: the host copy streams
    # while the host works on earlier batches, and finish_alignment's
    # np.asarray waits on one transfer instead of four
    from nanomod.resquiggle.banded import pack_outputs
    tail_shape = tuple(tb.shape[1:])
    packed = pack_outputs(tb, best, bi, bk)
    try:
        packed.copy_to_host_async()
    except AttributeError:      # non-Array backends / tracers
        pass
    return DPBatch(reads, packed, tail_shape, lens, win_starts, mode)


def finish_alignment(batch: DPBatch, cfg: AnnotateConfig):
    """Fetch the DP outputs and walk tracebacks for a dispatched batch.

    Returns [( (ops_type, ops_a, ops_b) int32 triple | None, win_start )]
    per read, 5'->3' op order.
    """
    from nanomod.resquiggle.banded import (decode_walk,
                                               decode_walk_native,
                                               ops_to_arrays,
                                               traceback_batch_native,
                                               unpack_outputs)
    tb, best, bi, bk = unpack_outputs(np.asarray(batch.packed),
                                      batch.tail_shape)
    reads, lens, win_starts = batch.reads, batch.lens, batch.win_starts

    n = len(reads)
    ops_all = None
    nthreads = _host_workers(cfg, cap=8)
    if batch.mode in ("codes", "codes2"):
        if cfg.use_native:
            ops_all = decode_walk_native(tb[:n], bi[:n], bk[:n],
                                         nthreads=nthreads,
                                         packed=batch.mode == "codes2")
        if ops_all is None and batch.mode == "codes2":
            from nanomod.resquiggle.banded import unpack_codes2
            tb = unpack_codes2(tb)
    elif cfg.use_native:
        ops_all = traceback_batch_native(
            tb[:n], bi[:n], bk[:n], packed=batch.mode == "packed",
            nthreads=nthreads)
    out = []
    for i, r in enumerate(reads):
        if best[i] < _min_score(cfg, int(lens[i])):
            out.append((None, int(win_starts[i])))
            continue
        if ops_all is not None:
            ops = ops_all[i]
        elif batch.mode in ("codes", "codes2"):
            ops = ops_to_arrays(decode_walk(tb[i], int(bi[i]), int(bk[i])))
        else:
            ops = ops_to_arrays(
                traceback(tb[i], bi[i], bk[i], int(lens[i])))
        out.append((ops, int(win_starts[i])))
    return out


def align_batch(reads: List[PreparedRead], fasta: FastaIndex,
                cfg: AnnotateConfig):
    """Banded-DP align a length-bucketed batch; returns per-read
    (ops arrays, win_start) pairs (ops None for failed alignments)."""
    batch = dispatch_dp(reads, fasta, cfg)
    if batch is None:
        return []
    return finish_alignment(batch, cfg)


def _payload(read, first_match_pos, ev_out, read_al, genome_al, clip_s,
             clip_e, numins, numdel, nmatch, nummismatch):
    return {
        "chrom": read.chrom,
        "start": int(first_match_pos),
        "strand": read.strand,
        "events": ev_out,
        "read_alignment": read_al,
        "genome_alignment": genome_al,
        "clipped_start": clip_s,
        "clipped_end": clip_e,
        "num_insertions": numins,
        "num_deletions": numdel,
        "num_matches": nmatch,
        "num_mismatches": nummismatch,
    }, ""


def annotate_one(read: PreparedRead, ops, win_start: int, fasta: FastaIndex,
                 cfg: AnnotateConfig) -> Tuple[Optional[dict], str]:
    """Run the indel-correction core for one aligned read; returns the
    payload for write_corrected_events.

    ``ops`` is the (ops_type, ops_a, ops_b) int32 array triple from
    finish_alignment (a tuple-list from banded.traceback also accepted).
    The column build and output assembly are vectorized; the correction
    core runs natively (annotate_core.cpp) with a pure-Python fallback.
    """
    from nanomod.io.fasta import COMP_LUT
    if not isinstance(ops, tuple):
        from nanomod.resquiggle.banded import ops_to_arrays
        ops = ops_to_arrays(ops)
    ot, oa, ob = ops
    if len(ot) == 0:
        return None, "Incorrect Alignment"
    genome_b = fasta.get_bytes(read.chrom)
    m_total = len(read.fwd_seq)
    read_b = np.frombuffer(read.fwd_seq.encode("ascii"), np.uint8)
    is_m = ot == 0
    is_i = ot == 1
    is_d = ot == 2

    # aligned read span in fwd coordinates
    ridx = oa[~is_d]
    if ridx.size == 0:
        return None, "Incorrect Alignment"
    r0 = int(ridx.min())
    r1 = int(ridx.max())
    leftclip = r0
    rightclip = m_total - 1 - r1

    m_idx = np.flatnonzero(is_m)
    if m_idx.size == 0:
        return None, "Incorrect Alignment"
    first_match_pos = win_start + int(ob[m_idx[0]])

    # aligned columns in genome-forward order (vectorized CIGAR expansion;
    # the reference walks this per base in Python, ref :537-588)
    g = np.where(is_m, ob, oa).astype(np.int64) + win_start
    g_real = g[~is_i]
    if g_real.size and (g_real.min() < 0 or g_real.max() >= len(genome_b)):
        return None, "Incorrect Alignment"
    refb = genome_b[np.where(is_i, 0, g)]
    refb = np.where(is_i, np.uint8(ord("-")), refb)
    readb = read_b[np.where(is_d, 0, oa)]
    readb = np.where(is_d, np.uint8(ord("-")), readb)
    readb = np.ascontiguousarray(readb, np.uint8)   # native core mutates
    refb = np.ascontiguousarray(refb, np.uint8)
    nummismatch = int(np.count_nonzero(is_m & (refb != readb)))
    numins = int(np.count_nonzero(is_i))
    numdel = int(np.count_nonzero(is_d))
    n_cols = len(ot)
    nmatch = n_cols - nummismatch - numins - numdel

    # genome-forward event arrays for the aligned region
    n_aligned = r1 - r0 + 1
    if read.strand == "+":
        orig = r0 + np.arange(n_aligned)
    else:
        orig = m_total - 1 - r0 - np.arange(n_aligned)
    ev_start = read.events_start[orig].astype(np.int64)
    ev_length = read.events_length[orig].astype(np.int64)

    res = None
    if cfg.use_native:
        from nanomod.native.annotate_bind import native_annotate_bytes
        res = native_annotate_bytes(
            refb, readb, ev_start, ev_length, read.strand,
            read.norm_signal, cfg.min_num_signal,
            cfg.resegment_signal_wind, cfg.more_signal_perc)
    if res is not None:
        out_mean, out_std, out_start, out_len, out_valid, hist = res
        valid = np.flatnonzero(out_valid)
        if valid.size == 0:
            return None, "Incorrect Alignment"
        signalnum = {i: int(hist[i]) for i in np.flatnonzero(hist)}
        order = valid if read.strand == "+" else valid[::-1]
        ev_out = np.empty(order.size, CORRECTED_EVENTS_DTYPE)
        ev_out["norm_mean"] = out_mean[order]
        ev_out["norm_stdev"] = out_std[order]
        ev_out["start"] = out_start[order]
        ev_out["length"] = out_len[order]
        bb = refb[order]
        if read.strand == "-":
            bb = COMP_LUT[bb]
        ev_out["base"] = bb.view("S1")
        if read.strand == "+":
            read_al = readb.view("S1")
            genome_al = refb.view("S1")
            clip_s, clip_e = leftclip, rightclip
        else:
            read_al = COMP_LUT[readb[::-1]].view("S1")
            genome_al = COMP_LUT[refb[::-1]].view("S1")
            clip_s, clip_e = rightclip, leftclip
        pay, err = _payload(read, first_match_pos, ev_out, read_al,
                            genome_al, clip_s, clip_e, numins, numdel,
                            nmatch, nummismatch)
        pay["signal_hist"] = signalnum
        return pay, err

    # pure-Python specification path (ref annotate1 semantics)
    cols = Columns(refb.view("S1").astype("<U1"), readb.view("S1").astype("<U1"))
    events = GenomeEvents(ev_start, ev_length, read.strand)
    indel_pos = ann_mod.mark_repeat_indels(cols)
    groups = ann_mod.group_indels(indel_pos, events, cols,
                                  cfg.min_num_signal,
                                  cfg.more_signal_perc)
    ann, signalnum = ann_mod.annotate_read(
        cols, events, read.norm_signal, groups,
        cfg.resegment_signal_wind, cfg.min_num_signal,
    )

    # build output events over annotated columns, genome-ascending
    keys = sorted(ann)
    rows = []
    for aim in keys:
        entry = ann[aim]
        if len(entry) < 3:
            continue
        _, mean, std, start, length = entry
        base = cols.refbase[aim] if read.strand == "+" else complement(
            str(cols.refbase[aim]))
        rows.append((mean, std, start, length, base))
    if not rows:
        return None, "Incorrect Alignment"
    if read.strand == "-":
        rows = rows[::-1]
    ev_out = np.array(
        [(m_, s_, st_, ln_, b_.encode() if isinstance(b_, str) else b_)
         for (m_, s_, st_, ln_, b_) in rows],
        dtype=CORRECTED_EVENTS_DTYPE,
    )

    if read.strand == "+":
        read_al = cols.readbase.astype("S1")
        genome_al = cols.refbase.astype("S1")
        clip_s, clip_e = leftclip, rightclip
    else:
        read_al = np.array([complement(str(b)) for b in cols.readbase[::-1]],
                           dtype="S1")
        genome_al = np.array([complement(str(b)) for b in cols.refbase[::-1]],
                             dtype="S1")
        clip_s, clip_e = rightclip, leftclip
    pay, err = _payload(read, first_match_pos, ev_out, read_al, genome_al,
                        clip_s, clip_e, numins, numdel, nmatch, nummismatch)
    pay["signal_hist"] = signalnum
    return pay, err


def _wrap_with_hit(path, read_id, seq, ev_start, ev_length, norm_signal,
                   hit, require_seed: bool = True):
    """Build the PreparedRead for a seeded (or unseeded) read.

    require_seed=False (external-aligner mode): an unseeded read is kept
    with '+' orientation — the SAM record decides chrom/strand later
    (resquiggle/external.py updates the PreparedRead in place)."""
    if hit is None or hit.votes < 3:
        if require_seed:
            return None, "Not in alignment sam"
        return PreparedRead(
            path=path, read_id=read_id, fwd_seq=seq, chrom="", strand="+",
            diag=0, events_start=ev_start, events_length=ev_length,
            norm_signal=norm_signal,
        ), ""
    from nanomod.io.fasta import revcomp
    fwd_seq = seq if hit.strand == "+" else revcomp(seq)
    return PreparedRead(
        path=path, read_id=read_id, fwd_seq=fwd_seq, chrom=hit.chrom,
        strand=hit.strand, diag=hit.diag, events_start=ev_start,
        events_length=ev_length, norm_signal=norm_signal,
    ), ""


def _seed_and_wrap(path: str, read_id: str, seq: str, ev_start, ev_length,
                   norm_signal, seed_index: SeedIndex,
                   require_seed: bool = True):
    """Seed one prepared read and build the PreparedRead (Python path; the
    native prepare seeds whole batches via SeedIndex.best_bands_native)."""
    return _wrap_with_hit(path, read_id, seq, ev_start, ev_length,
                          norm_signal, seed_index.best_band(seq),
                          require_seed=require_seed)


def prepare_batch(paths: List[str], cfg: AnnotateConfig,
                  seed_index: SeedIndex, kmer_model):
    """Load + extract + normalize + seed a batch of FAST5s.

    Fast path: the native raw-FAST5 reader (fast5_ingest.cpp f5_prepare_*)
    parses, extracts events and MAD-normalizes in threaded C++; only
    seeding runs in Python.  Falls back to the h5py/numpy path per read
    (thread pool — h5py releases the GIL, covering the reference's
    multiprocessing use, ref myRefBaseSignalAnnotation.py:1466-1471).

    Returns (prepared reads, errors {key: [paths]}).
    """
    from concurrent.futures import ThreadPoolExecutor

    from nanomod.utils.observe import stage
    errors = defaultdict(list)
    prepared = []
    workers = _host_workers(cfg)
    n_total = len(paths)

    with stage("prepare", unit="reads") as s:
        del n_total  # stage counts successfully prepared reads, not files
        native_res = None
        if cfg.use_native:
            from nanomod.native.prepare_bind import (model_tables,
                                                         native_prepare_batch)
            tables = model_tables(kmer_model)
            if kmer_model is None or tables is not None:
                # pure C++ threads (no GIL), clamped to 2x the core count:
                # past that allocator/cache contention inflates the CPU per
                # read with no wall-clock gain
                nt = max(1, min(cfg.threads, 2 * (os.cpu_count() or 1)))
                native_res = native_prepare_batch(
                    paths, cfg.basecall_1d, cfg.basecall_2strand,
                    nthreads=nt, kmer_tables=tables)
        if native_res is not None:
            fallback = []
            good = []
            for p, r in zip(paths, native_res):
                if r is None:                     # unclassified: retry h5py
                    fallback.append(p)
                elif isinstance(r, str):
                    errors[r].append(p)
                else:
                    good.append((p, r))
            # batch-seed on the C++ thread pool (per-read numpy seeding
            # is dominated by call overhead)
            hits = seed_index.best_bands_native(
                [r.seq for _, r in good], nthreads=workers)
            for i, (p, r) in enumerate(good):
                hit = (hits[i] if hits is not None
                       else seed_index.best_band(r.seq))
                rd, err = _wrap_with_hit(
                    p, r.read_id, r.seq, r.ev_start, r.ev_length,
                    r.norm_signal, hit, require_seed=(cfg.align == "dp"))
                if rd is None:
                    errors[err].append(p)
                else:
                    prepared.append(rd)
            paths = fallback
        if paths:
            with ThreadPoolExecutor(max_workers=workers) as ex:
                for p, (rd, err) in zip(paths, ex.map(
                        lambda q: prepare_read(q, cfg, seed_index, kmer_model),
                        paths)):
                    if rd is None:
                        errors[err].append(p)
                    else:
                        prepared.append(rd)
        s.add(len(prepared))
    return prepared, errors


def process_prepared(prepared, cfg: AnnotateConfig,
                     fasta: FastaIndex, sub_hint: int = 0):
    """Align + correct + write-back prepared reads.

    ``prepared`` is a list OR an iterator of lists (streamed chunks from
    the prepare prefetcher).  Pipelined: each chunk's buckets are split
    into sub-batches of cfg.dp_batch_size and a BOUNDED window of
    sub-batch DPs is kept in flight (JAX dispatch is async) ACROSS chunk
    boundaries — the device computes sub-batch k+1 while the host fetches/
    annotates k, and never stalls between chunks; FAST5 write-back runs on
    a background thread and overlaps the next fetch.
    """
    from concurrent.futures import ThreadPoolExecutor

    from nanomod.utils.observe import stage

    errors = defaultdict(list)
    chunk_list = [prepared] if isinstance(prepared, list) else None
    chunk_iter = iter(chunk_list) if chunk_list is not None else iter(prepared)
    n_seen = 0
    sub = 0

    def dp_parts_gen():
        """(reads, pad) sub-batch specs, streamed across chunks.  The
        sub-batch size is fixed from the first chunk (power of two) so
        every chunk reuses the same jit shapes."""
        nonlocal n_seen, sub
        for chunk in chunk_iter:
            n_seen += len(chunk)
            if not chunk:
                continue
            if sub == 0:
                # >=2 DP parts when possible so the device computes part
                # k+1 while the host annotates part k.  The
                # caller passes sub_hint when a small ramp-up chunk leads
                # the stream, so the steady-state chunks still get
                # full-size DP parts (one jit shape set).
                sub = sub_hint or max(8, min(cfg.dp_batch_size,
                                             -(-len(chunk) // 2)))
                sub = 1 << (sub - 1).bit_length()
            buckets: Dict[int, List[PreparedRead]] = defaultdict(list)
            for r in chunk:
                buckets[_length_bucket(len(r.fwd_seq))].append(r)
            for bucket_reads in buckets.values():
                for lo in range(0, len(bucket_reads), sub):
                    yield (bucket_reads[lo: lo + sub],
                           sub if len(bucket_reads) > sub else 0)

    dp_parts = dp_parts_gen()

    # Multi-device fan-out (the analog of the reference's 12-process
    # pool, ref myRefBaseSignalAnnotation.py:1452-1483): round-robin DP
    # sub-batches over the first cfg.n_devices local devices.  Each device
    # gets its own jit executable cache; results are byte-identical to
    # single-device because the DP is deterministic and batches are
    # finalized in dispatch order.
    devices = None
    if cfg.n_devices and cfg.n_devices > 1:
        import jax
        local = jax.local_devices()
        devices = local[: min(cfg.n_devices, len(local))]
        if len(devices) <= 1:
            devices = None
    rr = [0]

    def dispatch_next():
        """Next in-flight DPBatch, or None at END OF STREAM (empty parts
        are skipped here so a None return is unambiguous)."""
        for part, pad in dp_parts:
            dev = None
            if devices is not None:
                dev = devices[rr[0] % len(devices)]
                rr[0] += 1
            with stage("align_dp", unit="reads") as s:
                dpb = dispatch_dp(part, fasta, cfg, pad_bsz=pad, device=dev)
                s.add(len(part))
            if dpb is not None:
                return dpb
        return None

    n_ok = 0
    write_errors: List[str] = []
    signal_hist: Dict[int, int] = defaultdict(int)
    workers = _host_workers(cfg)

    # native write-back (fast5_write.cpp): appends + patches each FAST5 on a
    # C++ thread pool with the deflate fused in — no libhdf5 global lock.
    # h5py remains the fallback for files the native writer declines
    # (new-style HDF5 layouts).
    use_native_write = False
    if cfg.use_native and cfg.fast5_compression == "gzip":
        from nanomod.native.build import native_available
        use_native_write = native_available("fast5_write")

    def _write_h5py(r, payload):
        pre = payload.pop("_precompressed", None)
        try:
            write_corrected_events(r.path, **payload,
                                   basecall_group=cfg.basecall_1d,
                                   compression=cfg.fast5_compression,
                                   precompressed=pre)
            return True
        except OSError:
            write_errors.append(r.path)
            return False

    def write_many(annotated):
        ok = 0
        good = []
        for r, payload, err in annotated:
            if payload is None:
                errors[err].append(r.path)
                continue
            for wnd, cnt in payload.pop("signal_hist", {}).items():
                signal_hist[wnd] += cnt
            good.append((r, payload))
        if use_native_write and good:
            from nanomod.native.fast5_write_bind import (
                write_corrected_batch_native)
            mask = write_corrected_batch_native(
                [r.path for r, _ in good], [p for _, p in good],
                basecall_group=cfg.basecall_1d, nthreads=workers)
            if mask is not None:
                ok += int(mask.sum())
                good = [gp for gp, m in zip(good, mask) if not m]
        for r, payload in good:
            ok += _write_h5py(r, payload)
        return ok

    # fully-native fast path: decode + column build + correction + payload
    # assembly in ONE threaded C++ call per DP batch
    # (annotate_core.annotate_codes_batch) — removes all per-read Python
    # (numpy/ctypes call overhead) from the annotate stage
    use_batch_annotate = False
    if cfg.use_native and cfg.use_device_walk and cfg.align == "dp":
        from nanomod.native.annotate_bind import _batch_lib
        use_batch_annotate = _batch_lib() is not None

    def annotate_batch_fast(dpb):
        """Batched native annotate for a fetched 'codes'-mode DPBatch:
        returns [(read, payload | None, err)]."""
        from nanomod.native.annotate_bind import (
            annotate_codes_batch_native)
        from nanomod.resquiggle.banded import unpack_outputs
        with stage("traceback", unit="reads") as s:
            tb, best, bi, bk = unpack_outputs(np.asarray(dpb.packed),
                                              dpb.tail_shape)
            s.add(len(dpb.reads))
        n = len(dpb.reads)
        lens = dpb.lens
        accept = np.empty(n, np.uint8)
        for i in range(n):
            accept[i] = best[i] >= _min_score(cfg, int(lens[i]))
        with stage("annotate", unit="reads") as s:
            res = annotate_codes_batch_native(
                tb[:n], bi[:n], bk[:n], accept, dpb.win_starts[:n],
                dpb.reads, fasta, cfg.min_num_signal,
                cfg.resegment_signal_wind, cfg.more_signal_perc,
                nthreads=workers, packed=dpb.mode == "codes2")
            s.add(n)
        out = []
        for r, (payload, err) in zip(dpb.reads, res):
            if payload is None:
                out.append((r, None,
                            "Not in alignment sam" if err == "skip" else err))
            else:
                out.append((r, payload, ""))
        return out

    def aligned_batches():
        """Yield ("ops", reads, per-read (ops, win_start)) or
        ("done", reads, [(read, payload, err)]) batches — from the
        external aligner in one subprocess round, or from the bounded
        banded-DP dispatch window."""
        if cfg.align != "dp":
            nonlocal n_seen
            from nanomod.resquiggle.external import align_external
            all_prepared = [r for chunk in chunk_iter for r in chunk]
            n_seen += len(all_prepared)
            with stage("align_ext", unit="reads") as s:
                results = align_external(all_prepared, cfg)
                s.add(len(all_prepared))
            yield "ops", all_prepared, results
            return
        # dp_inflight = in-flight DP sub-batches: dispatch k+1/k+2 while
        # finishing k (the window bounds device memory; 2 is enough to
        # hide the fetch latency behind the next DP on one chip, and the
        # multi-chip fan-out needs 2 per device to keep every chip busy)
        from collections import deque
        dp_inflight = 2 * (len(devices) if devices is not None else 1)
        window = deque()
        for _ in range(dp_inflight):
            dpb = dispatch_next()
            if dpb is None:
                break
            window.append(dpb)
        while window:
            dpb = window.popleft()
            nxt = dispatch_next()
            if nxt is not None:
                window.append(nxt)
            if use_batch_annotate and dpb.mode in ("codes", "codes2"):
                yield "done", dpb.reads, annotate_batch_fast(dpb)
                continue
            with stage("traceback", unit="reads") as s:
                results = finish_alignment(dpb, cfg)
                s.add(len(dpb.reads))
            yield "ops", dpb.reads, results

    def compress_payload(item):
        r, payload, err = item
        if (payload is not None and not use_native_write
                and cfg.fast5_compression == "gzip"):
            # h5py path: deflate outside the writer thread (zlib releases
            # the GIL); the native writer deflates in C++ itself
            payload["_precompressed"] = compress_corrected_arrays(
                payload["events"], payload["read_alignment"],
                payload["genome_alignment"])
        return r, payload, err

    with ThreadPoolExecutor(max_workers=workers) as ex, \
            ThreadPoolExecutor(max_workers=1) as writer:
        pending = []
        for kind, batch_reads, results in aligned_batches():

            def one(args):
                r, (ops, ws) = args
                if ops is None:
                    return r, None, "Not in alignment sam"
                payload, err = annotate_one(r, ops, ws, fasta, cfg)
                return compress_payload((r, payload, err))
            # the correction core (ctypes) and numpy release the GIL, so a
            # thread pool parallelizes annotate across reads; completed
            # reads stream to the writer in small groups so the h5py
            # write-back overlaps the rest of the batch's correction
            with stage("annotate", unit="reads") as s:
                if kind == "done":
                    it = (results if use_native_write
                          else ex.map(compress_payload, results))
                else:
                    it = ex.map(one, zip(batch_reads, results))
                    s.add(len(batch_reads))
                group: list = []
                for res in it:
                    group.append(res)
                    if len(group) >= 16:
                        pending.append(writer.submit(write_many, group))
                        group = []
                if group:
                    pending.append(writer.submit(write_many, group))
        with stage("write", unit="reads") as s:
            for fut in pending:
                n_ok += fut.result()
            s.add(n_seen)
    for p in write_errors:
        errors["Cannot save data"].append(p)
    return n_ok, dict(errors), dict(signal_hist)


def _chunked(paths: List[str], cfg: AnnotateConfig) -> List[List[str]]:
    """Split the file list for the prepare-prefetch pipeline: chunks of up
    to files_per_thread, aiming for >=3 chunks so the background prepare
    (HDF5-bound) of chunk k+1 overlaps the DP/correction/write-back of
    chunk k.  A floor of 64 files/chunk takes precedence — below that the
    per-dispatch DP latency costs more than the prepare overlap saves — so
    runs under 128 files process as a single chunk (process_prepared still
    splits them into >=2 in-flight DP sub-batches internally).  Runs of
    >=192 files lead with one small ramp-up chunk (32 files) so the DP
    stream starts while the bulk of chunk 0 is still parsing — chunk 0's
    prepare is the only one nothing overlaps."""
    if not paths:
        return []
    ramp: List[List[str]] = []
    if len(paths) >= 192:
        ramp = [paths[:32]]
        paths = paths[32:]
    chunk_sz = max(64, min(cfg.files_per_thread, -(-len(paths) // 3)))
    return ramp + [paths[lo: lo + chunk_sz]
                   for lo in range(0, len(paths), chunk_sz)]


def _run_chunks(chunks: List[List[str]], cfg: AnnotateConfig,
                fasta: FastaIndex, seed_index: SeedIndex, kmer_model,
                progress=None):
    """Drive the chunked Annotate pipeline: chunk k+1's prepare runs on a
    background thread while chunk k streams through the cross-chunk DP
    window of process_prepared.  Returns aggregate
    (n_ok, errors, signal_hist); ``progress(n_prepared)`` fires as each
    chunk enters the DP stream."""
    from concurrent.futures import ThreadPoolExecutor

    all_errors: Dict[str, List[str]] = defaultdict(list)
    if not chunks:
        return 0, {}, {}
    with ThreadPoolExecutor(max_workers=1) as prefetcher:
        fut = prefetcher.submit(prepare_batch, chunks[0], cfg, seed_index,
                                kmer_model)

        def prepared_iter():
            nonlocal fut
            for ci in range(len(chunks)):
                prepared, errors = fut.result()
                fut = (prefetcher.submit(prepare_batch, chunks[ci + 1], cfg,
                                         seed_index, kmer_model)
                       if ci + 1 < len(chunks) else None)
                for k, v in errors.items():
                    all_errors[k].extend(v)
                if progress is not None:
                    # heartbeat in FILE units, fired when the chunk's
                    # prepare lands (annotate/write for it still overlap)
                    progress(len(chunks[ci]))
                yield prepared

        # DP sub-batch size from the LARGEST chunk, not the ramp-up one
        big = max(len(c) for c in chunks)
        hint = max(8, min(cfg.dp_batch_size, -(-big // 2)))
        n_ok, perrors, chist = process_prepared(prepared_iter(), cfg, fasta,
                                                sub_hint=hint)
    for k, v in perrors.items():
        all_errors[k].extend(v)
    return n_ok, dict(all_errors), chist


def annotate_files(paths: List[str], cfg: AnnotateConfig,
                   fasta: Optional[FastaIndex] = None,
                   seed_index: Optional[SeedIndex] = None):
    """Annotate a batch of FAST5s in place.

    Returns (n_ok, errors {key: [paths]}, signalnum histogram) — the
    reference's error taxonomy + resegment-window histogram
    (ref :1485-1494).
    """
    import nanomod
    nanomod.tune_malloc()
    fasta = fasta or FastaIndex(cfg.ref_fasta)
    seed_index = seed_index or SeedIndex(fasta.seqs, k=cfg.seed_k)
    kmer_model = (load_kmer_model(cfg.kmer_model_file)
                  if cfg.kmer_model_file and os.path.isfile(cfg.kmer_model_file)
                  else None)
    n_ok, errors, chist = _run_chunks(_chunked(paths, cfg), cfg, fasta,
                                      seed_index, kmer_model)
    return n_ok, errors, chist


def annotate_folder(cfg: AnnotateConfig):
    """correctAndAnnotate_manager (ref :1429-1497): discover FAST5s and
    annotate them in batches, reporting throughput and the reference's
    error-type histogram.

    Multi-host (jax.distributed): each process annotates its round-robin
    shard of the file list — the analog of the reference's
    12-process node × SGE fan-out (ref myRefBaseSignalAnnotation.py:1452-1483,
    mySimulate.py:356) — and the error/histogram report is merged across
    processes so every host prints the global totals.  Annotation writes
    in place into each host's own shard, so no cross-host file conflicts.
    """
    import time

    import jax

    from nanomod.utils.observe import observer
    observer().reset()     # per-run metrics, not cumulative across runs
    start = time.time()
    paths = list(iter_fast5_files(cfg.wrk_base1, recursive=cfg.recursive))
    n_global = len(paths)
    pcount = jax.process_count()
    if pcount > 1:
        from nanomod.parallel.dist import shard_list
        paths = shard_list(paths)
        print(f"Total f5={n_global} "
              f"(host {jax.process_index()}/{pcount}: {len(paths)})")
    else:
        print(f"Total f5={len(paths)}")
    if cfg.resume:
        # skip files that already carry NanomoCorrected_000 (the reference
        # always rewrites, ref myRefBaseSignalAnnotation.py:706-714; resume
        # makes interrupted runs restartable without redoing finished work)
        from nanomod.io.fast5 import has_corrected_group
        n_before = len(paths)
        paths = [p for p in paths if not has_corrected_group(p)]
        print(f"Resume: {n_before - len(paths)} already annotated, "
              f"{len(paths)} to do")
    fasta = FastaIndex(cfg.ref_fasta)
    seed_index = SeedIndex(fasta.seqs, k=cfg.seed_k)
    kmer_model = (load_kmer_model(cfg.kmer_model_file)
                  if cfg.kmer_model_file and os.path.isfile(cfg.kmer_model_file)
                  else None)
    chunks = _chunked(paths, cfg)
    done = 0

    def progress(n: int):
        nonlocal done
        done += n
        dt = time.time() - start
        if cfg.out_level <= 1 and done < len(paths):
            print(f"{done}/{len(paths)} files prepared, "
                  f"{done / max(dt, 1e-9):.1f} files/s")

    total_ok, all_errors, all_hist = _run_chunks(
        chunks, cfg, fasta, seed_index, kmer_model, progress=progress)
    dt = time.time() - start
    if pcount > 1:
        from nanomod.parallel.dist import merge_annotate_stats
        total_ok, all_errors, all_hist = merge_annotate_stats(
            total_ok, all_errors, all_hist)
    if all_hist:
        # resegment-window success histogram (ref :1491-1494,
        # 'signalneighbor'; window 1 = whole-group mean/std fallback)
        print("Resegmentation information:")
        for wnd in sorted(all_hist):
            print(f"\t{wnd} {all_hist[wnd]}")
    print("Error information for different fast5 files:")
    for k, v in all_errors.items():
        print(f"\t{k} {len(v)}")
    print(f"Total consuming time {dt:.0f} ({total_ok / max(dt, 1e-9):.1f} reads/s)")
    from nanomod.utils.observe import observer, report
    report(cfg.out_level)
    if cfg.metrics_file:
        observer().to_json(cfg.metrics_file)
    return total_ok, dict(all_errors)
