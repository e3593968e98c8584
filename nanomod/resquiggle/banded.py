"""Batched banded affine-gap local alignment (Smith-Waterman) in JAX.

Replaces the reference's ``bwa mem -x ont2d`` / ``minimap2 -ax map-ont``
subprocess (ref bin/scripts/myRefBaseSignalAnnotation.py:406-417): reads are
aligned to a known reference around a seed diagonal (resquiggle/seed.py), so
a fixed-width band suffices.

Formulation (scan over read rows, vector ops over the band):

    band coordinate k ∈ [0, W): cell (i, k) is read base i vs reference
    window position i + k (the window is extracted so the seed diagonal sits
    at k = W/2)

    H[i,k] = max(0, Hprev[k] + sub(i, i+k), E[i,k], F[i,k])   local
    F[i,k] = max(Hprev[k+1] + go, Fprev[k+1] + ge)            read-gap (ins)
    E[i,k] = max_{l<k} Hnoe[i,l] + go + ge*(k-l-1)            ref-gap (del)

The intra-row E recurrence is solved in closed form with a shifted running
max (max-plus linear recurrence):  E[k] = ge*k + go - ge + cummax_{l<k}
(Hnoe[l] - ge*l) — no sequential dependency, one cummax per row.

Traceback bits are written per cell (2b H-source, 1b E-extend, 1b F-extend)
and walked on the host (O(aligned length) per read).

Gap cost convention: a gap of length g costs -(go + (g-1)*ge) with go, ge
passed as negative numbers.
"""

from __future__ import annotations

from functools import partial
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

NEG = jnp.float32(-1e9)

# H-source codes (2 bits)
H_ZERO, H_DIAG, H_E, H_F = 0, 1, 2, 3


@partial(jax.jit, static_argnames=("match", "mismatch", "go", "ge"))
def banded_sw(read_codes, ref_window_codes, read_len, *,
              match=2, mismatch=-3, go=-5, ge=-2):
    """Batched banded local alignment.

    read_codes       [B, M] uint8 (0-3 ACGT, 4=N/pad)
    ref_window_codes [B, M + W] uint8 (per-read reference window; position
                     i + k corresponds to band cell (i, k)); pad code 5
    read_len         [B] int32 valid read lengths

    Returns (tb [B, M, W] uint8 traceback bits, best [B] f32 score,
             best_i [B] i32, best_k [B] i32).
    """
    bsz, m = read_codes.shape
    w = ref_window_codes.shape[1] - m

    matchf = jnp.float32(match)
    mismatchf = jnp.float32(mismatch)
    gof = jnp.float32(go)
    gef = jnp.float32(ge)

    karange = jnp.arange(w, dtype=jnp.float32)

    def row_step(carry, i):
        h_prev, f_prev, best, best_i, best_k = carry
        # substitution scores for row i: read[i] vs ref[i + k]
        rc = jax.lax.dynamic_index_in_dim(read_codes, i, axis=1,
                                          keepdims=False)            # [B]
        refrow = jax.lax.dynamic_slice_in_dim(ref_window_codes, i, w,
                                              axis=1)                # [B, W]
        is_match = (refrow == rc[:, None]) & (rc[:, None] < 4) & (refrow < 4)
        sub = jnp.where(is_match, matchf, mismatchf)

        # F (insertion in read, consumes read row): from (i-1, k+1)
        h_up = jnp.concatenate([h_prev[:, 1:], jnp.full((bsz, 1), NEG)], axis=1)
        f_up = jnp.concatenate([f_prev[:, 1:], jnp.full((bsz, 1), NEG)], axis=1)
        f_cur = jnp.maximum(h_up + gof, f_up + gef)

        # H without E
        h_noe = jnp.maximum(jnp.maximum(h_prev + sub, f_cur), 0.0)

        # E via shifted drift-adjusted cummax
        a = h_noe - gef * karange[None, :]
        cm = jax.lax.cummax(a, axis=1)
        cm_shift = jnp.concatenate([jnp.full((bsz, 1), NEG), cm[:, :-1]], axis=1)
        e_cur = gef * karange[None, :] + gof - gef + cm_shift

        h_cur = jnp.maximum(h_noe, e_cur)

        # row masking beyond read length
        valid = (i < read_len)[:, None]
        h_cur = jnp.where(valid, h_cur, 0.0)
        f_cur = jnp.where(valid, f_cur, NEG)

        # traceback bits
        src = jnp.where(
            h_cur <= 0.0, H_ZERO,
            jnp.where(e_cur >= h_noe, H_E,
                      jnp.where(f_cur >= jnp.maximum(h_prev + sub, 0.0), H_F,
                                H_DIAG)))
        # E extension bit: E[k] came by extending E[k-1] rather than opening
        h_noe_shift = jnp.concatenate([jnp.full((bsz, 1), NEG), h_noe[:, :-1]],
                                      axis=1)
        e_ext = e_cur > h_noe_shift + gof + 1e-4
        # F extension bit
        f_ext = f_cur > h_up + gof + 1e-4
        tb = (src.astype(jnp.uint8)
              | (e_ext.astype(jnp.uint8) << 2)
              | (f_ext.astype(jnp.uint8) << 3))

        # best cell tracking
        row_best_k = jnp.argmax(h_cur, axis=1).astype(jnp.int32)
        row_best = jnp.take_along_axis(h_cur, row_best_k[:, None], axis=1)[:, 0]
        improve = row_best > best
        best = jnp.where(improve, row_best, best)
        best_i = jnp.where(improve, i, best_i)
        best_k = jnp.where(improve, row_best_k, best_k)

        return (h_cur, f_cur, best, best_i, best_k), tb

    init = (
        jnp.zeros((bsz, w), jnp.float32),
        jnp.full((bsz, w), NEG),
        jnp.zeros(bsz, jnp.float32),
        jnp.zeros(bsz, jnp.int32),
        jnp.zeros(bsz, jnp.int32),
    )
    # rolled: an unrolled body inflates compile time, and what unrolling
    # buys on the GPU has not been measured
    with jax.named_scope("banded_sw"):
        (h, f, best, best_i, best_k), tbs = jax.lax.scan(
            row_step, init, jnp.arange(m, dtype=jnp.int32)
        )
    tb = jnp.transpose(tbs, (1, 0, 2))    # [B, M, W]
    return tb, best, best_i, best_k


@jax.jit
def pack_tb(tb):
    """Nibble-pack a [B, M, W] traceback matrix on device (two 4-bit cells
    per byte, low nibble = even k) — halves the device-to-host transfer.
    W must be even."""
    return tb[..., 0::2] | (tb[..., 1::2] << 4)


@jax.jit
def pack_outputs(tb, best, best_i, best_k):
    """Flatten + concatenate ALL DP outputs into one uint8 array
    [B, 12 + prod(tb.shape[1:])] so the device→host transfer is one copy
    instead of four (tb/best/best_i/best_k).  Row layout: best(i32) | best_i(i32) | best_k(i32) | tb
    bytes.  best is rounded to int32 — exact for integral match/mismatch/
    gap configs, and a float score config only shifts the min_score filter
    by <0.5 instead of truncating toward zero."""
    bsz = tb.shape[0]
    extra = jnp.stack(
        [jnp.round(best).astype(jnp.int32), best_i.astype(jnp.int32),
         best_k.astype(jnp.int32)], axis=1)
    return jnp.concatenate(
        [jax.lax.bitcast_convert_type(extra, jnp.uint8).reshape(bsz, 12),
         tb.reshape(bsz, -1)], axis=1)


def unpack_outputs(fetched: np.ndarray, tail_shape):
    """Host-side inverse of pack_outputs: returns (tb, best, best_i,
    best_k) numpy views; tail_shape is tb.shape[1:]."""
    extra = np.ascontiguousarray(fetched[:, :12]).view(np.int32)
    tb = fetched[:, 12:].reshape((fetched.shape[0],) + tuple(tail_shape))
    return tb, extra[:, 0], extra[:, 1], extra[:, 2]


@partial(jax.jit, static_argnames=("match", "mismatch", "go", "ge"))
def banded_sw_packed(read_codes, ref_window_codes, read_len, *,
                     match=2, mismatch=-3, go=-5, ge=-2):
    """banded_sw with the traceback matrix nibble-packed on device.
    Returns (tb_packed [B, M, W//2] uint8, best, best_i, best_k)."""
    tb, best, best_i, best_k = banded_sw(
        read_codes, ref_window_codes, read_len,
        match=match, mismatch=mismatch, go=go, ge=ge)
    return pack_tb(tb), best, best_i, best_k


@jax.jit
def walk_device(tb, best_i, best_k):
    """Walk every read's traceback ON DEVICE in lockstep (lax.scan over
    steps, vectorized over the batch) so only the per-step op codes are
    fetched (~1 byte/step/read) instead of the whole [M, W] traceback
    matrix.

    Returns codes [B, 2M+W] uint8 in walk (3'→5') order:
    0 = stopped, 1 = M, 2 = I, 3 = D.  Decode with decode_walk_native
    (native/traceback.cpp) or decode_walk.
    """
    bsz, m, w = tb.shape
    tbf = tb.reshape(bsz, m * w)
    steps = 2 * m + w

    def step(carry, _):
        i, k, st, done = carry
        idx = jnp.clip(i, 0, m - 1) * w + jnp.clip(k, 0, w - 1)
        bits = jnp.take_along_axis(tbf, idx[:, None], axis=1)[:, 0]
        bits = bits.astype(jnp.int32)
        src = bits & 3
        e_ext = (bits & 4) != 0
        f_ext = (bits & 8) != 0
        is_h = st == 0
        # fused automaton: entering E/F from H emits that op at the same
        # cell in the same step (matches the Python walker, which re-reads
        # the same cell after the state switch)
        act_m = is_h & (src == H_DIAG)
        act_d = (is_h & (src == H_E)) | (st == 1)
        act_i = (is_h & (src == H_F)) | (st == 2)
        stop = is_h & (src == H_ZERO)
        code = jnp.where(
            done | stop, 0,
            jnp.where(act_m, 1, jnp.where(act_i, 2, 3))).astype(jnp.uint8)
        ni = jnp.where(act_m | act_i, i - 1, i)
        nk = jnp.where(act_d, k - 1, jnp.where(act_i, k + 1, k))
        nst = jnp.where(act_m, 0,
                        jnp.where(act_d, jnp.where(e_ext, 1, 0),
                                  jnp.where(act_i, jnp.where(f_ext, 2, 0),
                                            st)))
        ndone = done | stop | (ni < 0) | (nk < 0) | (nk >= w)
        ni = jnp.where(done, i, ni)
        nk = jnp.where(done, k, nk)
        nst = jnp.where(done, st, nst)
        return (ni, nk, nst, ndone), code

    init = (best_i.astype(jnp.int32), best_k.astype(jnp.int32),
            jnp.zeros(bsz, jnp.int32), jnp.zeros(bsz, bool))
    with jax.named_scope("walk_device"):
        _, codes = jax.lax.scan(step, init, None, length=steps, unroll=8)
    return jnp.transpose(codes)        # [B, steps]


@jax.jit
def pack_codes2(codes):
    """Pack the 2-bit walk codes (0..3) four-per-byte ON DEVICE —
    quarters the device->host transfer of walk_device's [B, 2M+W] code
    array.  The step
    count 2M+W is a multiple of 4 for the power-of-two M/W buckets."""
    b, s = codes.shape
    c = codes.reshape(b, s // 4, 4)
    return (c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4)
            | (c[..., 3] << 6))


def unpack_codes2(packed: np.ndarray) -> np.ndarray:
    """Host inverse of pack_codes2 (fallback when the native decoder,
    which reads the packed bytes directly, is unavailable)."""
    b, sb = packed.shape
    out = np.empty((b, sb * 4), np.uint8)
    for j in range(4):
        out[:, j::4] = (packed >> (2 * j)) & 3
    return out


def decode_walk(codes_row: np.ndarray, best_i: int, best_k: int):
    """Host decode of one read's device-walk codes into traceback-style
    ops (5'→3'), the pure-Python reference for decode_walk_native."""
    i, k = int(best_i), int(best_k)
    ops = []
    for c in codes_row:
        if c == 0:
            break
        if c == 1:
            ops.append(("M", i, i + k))
            i -= 1
        elif c == 2:
            ops.append(("I", i))
            i -= 1
            k += 1
        else:
            ops.append(("D", i + k))
            k -= 1
    ops.reverse()
    return ops


def decode_walk_native(codes: np.ndarray, best_i: np.ndarray,
                       best_k: np.ndarray, nthreads: int = 8,
                       packed: bool = False):
    """Whole-batch C++ decode of device-walk codes (traceback.cpp
    decode_walk_batch); returns (ops_type, ops_a, ops_b) triples in 5'→3'
    order per read, or None when the toolchain is unavailable.  packed:
    codes are 2-bit packed 4 steps/byte (pack_codes2)."""
    import ctypes

    from nanomod.native.build import load_native

    lib = load_native("traceback")
    if lib is None:
        return None
    if not getattr(lib, "_decode_sig", False):
        lib.decode_walk_batch.restype = None
        lib.decode_walk_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
        ]
        lib._decode_sig = True
    bsz, sb = codes.shape
    s = sb * 4 if packed else sb
    cap = s
    ot = np.empty((bsz, cap), np.int32)
    oa = np.empty((bsz, cap), np.int32)
    ob = np.empty((bsz, cap), np.int32)
    out_n = np.zeros(bsz, np.int64)
    codes_c = np.ascontiguousarray(codes, dtype=np.uint8)
    bi = np.ascontiguousarray(best_i, dtype=np.int32)
    bk = np.ascontiguousarray(best_k, dtype=np.int32)
    lib.decode_walk_batch(
        codes_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), bsz, s,
        bi.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        bk.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ot.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        oa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ob.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
        out_n.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), nthreads,
        1 if packed else 0)
    return [(ot[b, : out_n[b]].copy(), oa[b, : out_n[b]].copy(),
             ob[b, : out_n[b]].copy()) for b in range(bsz)]


def unpack_tb(tb_packed: np.ndarray) -> np.ndarray:
    """Host-side inverse of the device nibble packing (testing helper)."""
    b, m, wp = tb_packed.shape
    out = np.empty((b, m, wp * 2), np.uint8)
    out[..., 0::2] = tb_packed & 0xF
    out[..., 1::2] = tb_packed >> 4
    return out


def ops_to_arrays(ops) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Convert the tuple-list op format of `traceback` to the
    (type, a, b) int32 array triple of `traceback_batch_native`."""
    n = len(ops)
    ot = np.empty(n, np.int32)
    oa = np.empty(n, np.int32)
    ob = np.full(n, -1, np.int32)
    codes = {"M": 0, "I": 1, "D": 2}
    for idx, op in enumerate(ops):
        ot[idx] = codes[op[0]]
        oa[idx] = op[1]
        if op[0] == "M":
            ob[idx] = op[2]
    return ot, oa, ob


def traceback_batch_native(tb: np.ndarray, best_i: np.ndarray,
                           best_k: np.ndarray, *, packed: bool,
                           nthreads: int = 8):
    """Whole-batch C++ traceback (native/traceback.cpp traceback_batch).

    tb is [B, M, W] uint8 or, when packed, [B, M, W//2] nibble-packed.
    Returns a list of (ops_type, ops_a, ops_b) int32 array triples in
    5'->3' order, or None when the native toolchain is unavailable.
    """
    import ctypes

    from nanomod.native.build import load_native

    lib = load_native("traceback")
    if lib is None:
        return None
    if not getattr(lib, "_batch_sig", False):
        lib.traceback_batch.restype = None
        lib.traceback_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ]
        lib._batch_sig = True
    bsz, m, wbytes = tb.shape
    w = wbytes * 2 if packed else wbytes
    cap = 2 * m + w + 8
    ot = np.empty((bsz, cap), np.int32)
    oa = np.empty((bsz, cap), np.int32)
    ob = np.empty((bsz, cap), np.int32)
    out_n = np.zeros(bsz, np.int64)
    tb_c = np.ascontiguousarray(tb, dtype=np.uint8)
    bi = np.ascontiguousarray(best_i, dtype=np.int32)
    bk = np.ascontiguousarray(best_k, dtype=np.int32)
    lib.traceback_batch(
        tb_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), bsz, m, wbytes,
        1 if packed else 0,
        bi.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        bk.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ot.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        oa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ob.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
        out_n.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), nthreads)
    return [(ot[b, : out_n[b]].copy(), oa[b, : out_n[b]].copy(),
             ob[b, : out_n[b]].copy()) for b in range(bsz)]


def traceback_native(tb_row: np.ndarray, best_i: int, best_k: int):
    """C++ traceback (native/traceback.cpp); returns ops like `traceback`
    or None when the toolchain is unavailable."""
    import ctypes
    from nanomod.native.build import load_native

    lib = load_native("traceback")
    if lib is None:
        return None
    if not getattr(lib, "_sig", False):
        lib.traceback_one.restype = ctypes.c_int64
        lib.traceback_one.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ]
        lib._sig = True
    m, w = tb_row.shape
    cap = 2 * m + w + 8
    ot = np.empty(cap, np.int32)
    oa = np.empty(cap, np.int32)
    ob = np.empty(cap, np.int32)
    tb_c = np.ascontiguousarray(tb_row, dtype=np.uint8)
    n = lib.traceback_one(
        tb_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), m, w,
        int(best_i), int(best_k),
        ot.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        oa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ob.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
    codes = ("M", "I", "D")
    return [((codes[ot[i]], int(oa[i]), int(ob[i])) if ot[i] == 0
             else (codes[ot[i]], int(oa[i])))
            for i in range(n)]


def traceback(tb_row: np.ndarray, best_i: int, best_k: int,
              read_len: int) -> List[Tuple[int, int]]:
    """Walk one read's traceback bits from the best cell.

    Returns the aligned (read_i, ref_window_j) pairs plus gap markers as a
    list of ops, 5'→3': ('M', i, j) | ('I', i) insertion (read base, ref
    gap) | ('D', j) deletion (ref base, read gap).  j = i + k is the
    ref-window coordinate.
    """
    ops = []
    i, k = int(best_i), int(best_k)
    w = tb_row.shape[1]
    state = "H"
    while i >= 0:
        bits = int(tb_row[i, k])
        src = bits & 0b11
        if state == "H":
            if src == H_ZERO:
                break
            if src == H_DIAG:
                ops.append(("M", i, i + k))
                i -= 1                       # diag: same k
                if i < 0:
                    break
            elif src == H_E:
                state = "E"
            else:
                state = "F"
        elif state == "E":
            # consume ref position j = i + k, move left in band
            ops.append(("D", i + k))
            if bits & 0b100 and k - 1 >= 0:
                k -= 1                       # continue extending
                state = "E"
            else:
                k -= 1
                state = "H"
            if k < 0:
                break
        else:  # F: consume read base i, move up-right
            ops.append(("I", i))
            up_ext = bool(bits & 0b1000)
            i -= 1
            k += 1
            if k >= w or i < 0:
                break
            state = "F" if up_ext else "H"
    ops.reverse()
    return ops
