"""Multi-host orchestration.

The reference scales across nodes by shelling qsub jobs at an SGE cluster
and polling qstat (ref bin/scripts/mySimulate.py:344-457).  The equivalent
here is one SPMD process per host (or per device) under `jax.distributed`:

  * FAST5 ingest is host-local — each process reads its shard of the file
    list (round-robin, like the reference's per-job folder assignment) and
    builds partial position pools;
  * pools merge across hosts with collectives (values via allgather along
    the capacity axis, counts via sum) before the position-sharded battery;
  * simulation grids ((dataset x parameter) tuples) shard the same way —
    each host sweeps its slice in-process, results concatenate at the end
    (the .output file format is unchanged, so merging is file-level
    concatenation exactly as the reference's qsub merge loop did).

On a single host every helper degenerates to the identity, so the same
driver code runs everywhere.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import jax


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               processes_per_host: Optional[int] = None):
    """jax.distributed.initialize wrapper; no-op when single-process.

    Each process binds ONE local device, the one at its local rank
    (process_id mod processes_per_host; by default all processes share one
    host).  Without it every process would open — and reserve memory on —
    every GPU of its host."""
    if num_processes is None or num_processes <= 1:
        return
    per_host = processes_per_host or num_processes
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=[process_id % per_host],
    )


def process_info() -> Tuple[int, int]:
    return jax.process_index(), jax.process_count()


def shard_list(items: Sequence, process_id: Optional[int] = None,
               process_count: Optional[int] = None) -> List:
    """Round-robin shard of a work list for this host (files, grid points)."""
    pid = jax.process_index() if process_id is None else process_id
    pcount = jax.process_count() if process_count is None else process_count
    return [x for i, x in enumerate(items) if i % pcount == pid]


def _multihost_gather(x):
    """Concatenate every process's (possibly different-length) array along
    axis 0, over the real jax.distributed backend.

    `process_allgather` requires identical shapes on all processes — with
    ragged per-host inputs the Gloo CPU transport returns silently corrupt
    data on some ranks and then aborts (observed: `op.preamble.length <=
    op.nbytes` enforce failure).  So: allgather the local lengths first
    (scalar, always same shape), pad axis 0 to the global max, allgather
    tiled, then slice each host's true prefix back out."""
    from jax.experimental import multihost_utils

    x = np.asarray(x)
    lens = np.asarray(multihost_utils.process_allgather(
        np.asarray(x.shape[0], dtype=np.int32)))
    m = int(lens.max(initial=0))
    if m == 0:
        return x
    pad = np.zeros((m,) + x.shape[1:], dtype=x.dtype)
    pad[: x.shape[0]] = x
    g = np.asarray(multihost_utils.process_allgather(pad, tiled=True))
    return np.concatenate(
        [g[i * m: i * m + int(lens[i])] for i in range(len(lens))])


def _encode_keys(keys, width: int) -> np.ndarray:
    """(chrom, strand) tuples -> fixed-width uint8 rows (NUL padded).
    Real allgather backends cannot ship object/string arrays (device_put
    rejects them), so the key table crosses DCN as bytes."""
    arr = np.zeros((len(keys), width), dtype=np.uint8)
    for i, (c, s) in enumerate(keys):
        b = f"{c}\t{s}".encode()
        arr[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    return arr


def _decode_keys(rows: np.ndarray):
    out = set()
    for row in np.asarray(rows, dtype=np.uint8):
        b = row.tobytes().rstrip(b"\x00")
        if b:
            # strand is the single char after the LAST tab, so chrom names
            # containing tabs (legal in some FASTA headers) round-trip
            c, _, s = b.decode().rpartition("\t")
            out.add((c, s))
    return sorted(out)


def merge_pools_across_hosts(pools: Dict, gather=None,
                             process_count: Optional[int] = None,
                             max_capacity: int = 0):
    """Merge per-host partial pools (accum.pools.PositionPools dicts) into
    identical full pools on every host.

    Single-process: identity.  Multi-process: the whole local pool set is
    flattened into FOUR packed observation arrays (global-key id, position,
    value, base code) + one byte-encoded key table + one width scalar, so
    the merge costs a constant SIX gather() calls over DCN regardless of
    key/position count (each expands to two backend collectives via the
    ragged length-prefix protocol in _multihost_gather — 12 total), then
    re-packed with the same vectorized grouping as PoolBuilder
    (pack_observations — same majority-vote base, same capacity-cap
    subsampling).  Positions/lengths travel as int32 (process_allgather
    under default JAX config downcasts int64 silently, so the bound is
    explicit: genomic coordinates < 2^31).

    `gather`/`process_count` are injectable for tests (a barrier-based
    thread gather in tests/test_parallel.py runs every rank's merge
    concurrently, covering the real merge code path without a cluster);
    the real 2-process jax.distributed backend is covered by
    tests/test_multihost_real.py.
    """
    pc = jax.process_count() if process_count is None else process_count
    if pc == 1:
        return pools
    gather = gather or _multihost_gather
    from nanomod.accum.pools import _BASE_TO_CODE, pack_observations

    # phase 1: agree on the global (chrom, strand) key table.  Strings
    # cross the wire as fixed-width uint8 rows; the width itself must be
    # agreed first (it differs per host).
    local_keys = sorted(pools)
    local_w = max((len(f"{c}\t{s}".encode()) for c, s in local_keys),
                  default=0)
    width = int(gather(np.array([local_w], dtype=np.int32)).max(initial=1))
    keys = _decode_keys(gather(_encode_keys(local_keys, width)))
    gid = {key: i for i, key in enumerate(keys)}

    # phase 2: flatten local observations with global key ids
    kid, opos, oval, obase = [], [], [], []
    for key in local_keys:
        pp = pools[key]
        cnt = pp.counts
        mask = np.arange(pp.values.shape[1])[None, :] < cnt[:, None]
        opos.append(np.repeat(pp.positions, cnt))
        oval.append(pp.values[mask])
        codes = _BASE_TO_CODE[
            np.frombuffer(pp.base.astype("S1").tobytes(), dtype=np.uint8)]
        obase.append(np.repeat(codes, cnt))
        kid.append(np.full(int(cnt.sum()), gid[key], np.int32))

    def cat(parts, dtype):
        return (np.concatenate(parts).astype(dtype) if parts
                else np.empty(0, dtype))

    g_kid = gather(cat(kid, np.int32))
    # int32 on the wire (see docstring), back to the pools' int64 dtype
    g_pos = gather(cat(opos, np.int32)).astype(np.int64)
    g_val = gather(cat(oval, np.float32))
    g_cod = gather(cat(obase, np.int8))

    # phase 3: re-pack per key with PoolBuilder semantics
    merged = {}
    for key in keys:
        sel = g_kid == gid[key]
        if not sel.any():
            continue
        merged[key] = pack_observations(
            key[0], key[1], g_pos[sel], g_val[sel], g_cod[sel],
            max_capacity=max_capacity)
    return merged


def merge_annotate_stats(n_ok: int, errors: Dict, hist: Dict,
                         gather=None, process_count: Optional[int] = None):
    """Merge per-host Annotate run statistics (ok count, error-taxonomy
    path lists, resegment-window histogram) across processes so every host
    reports the global totals — the analog of the reference parent polling
    its workers' failed_Q/reseg_Q (ref myRefBaseSignalAnnotation.py:1473-1494).

    Stats are tiny relative to the data, so they cross DCN as one
    JSON-encoded byte blob per host via the ragged allgather."""
    import json

    pc = jax.process_count() if process_count is None else process_count
    if pc == 1:
        return n_ok, errors, hist
    gather = gather or _multihost_gather
    blob = json.dumps({
        "n_ok": int(n_ok),
        "errors": {k: list(v) for k, v in errors.items()},
        "hist": {str(k): int(v) for k, v in hist.items()},
    }).encode()
    # ragged rows can't mix: ship (length, payload) as one uint8 row padded
    # by the gather protocol itself (each host sends its own length first)
    lens = gather(np.array([len(blob)], dtype=np.int32))
    buf = np.frombuffer(blob, dtype=np.uint8)
    width = int(lens.max(initial=1))
    row = np.zeros((1, width), dtype=np.uint8)
    row[0, : len(blob)] = buf
    rows = gather(row)
    tot_ok, merged_err, merged_hist = 0, {}, {}
    for i in range(rows.shape[0]):
        d = json.loads(rows[i, : int(lens[i])].tobytes().decode())
        tot_ok += d["n_ok"]
        for k, v in d["errors"].items():
            merged_err.setdefault(k, []).extend(v)
        for k, v in d["hist"].items():
            merged_hist[int(k)] = merged_hist.get(int(k), 0) + v
    return tot_ok, merged_err, merged_hist


def ingest_group_multihost(folder: str, cfg):
    """Multi-host ingest of one group: each process reads its round-robin
    file shard (the reference's per-job folder assignment analog), partial
    pools merge across hosts over DCN.  Every host returns the identical
    full pools."""
    from nanomod.config import replace
    from nanomod.detect import ingest_group
    from nanomod.io.fast5 import iter_fast5_files

    files = shard_list(sorted(iter_fast5_files(folder)))
    # partial pools stay exact; the capacity cap applies once, at the merge
    # (a cap-of-a-cap would not match the single-host subsample)
    partial = ingest_group(folder, replace(cfg, pool_capacity=0),
                           files=files)
    return merge_pools_across_hosts(partial,
                                    max_capacity=cfg.pool_capacity)


def distributed_ingest_detect(cfg):
    """Host-sharded detect: each process ingests its file shard, pools
    merge across hosts, then the standard detection path runs (identically
    on every host).  run_detect routes here automatically when
    jax.process_count() > 1."""
    from nanomod.detect import detect_from_pools

    pools1 = ingest_group_multihost(cfg.wrk_base1, cfg)
    pools2 = ingest_group_multihost(cfg.wrk_base2, cfg)
    return detect_from_pools(pools1, pools2, cfg)
