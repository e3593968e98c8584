#!/usr/bin/env python
"""Per-length-bucket banded-DP benchmark: DP, device walk and fetch.

For each read-length bucket, measures (median of N):

    dp_ms          — banded_sw (lax.scan) dispatch+compute, block on tb
    walk_ms        — walk_device (device traceback walk) on the tb matrix
    pack_fetch_ms  — pack_codes2 + D2H of the packed op codes

Usage: python tools/bench_dp_buckets.py [buckets...]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nanomod import use_compile_cache  # noqa: E402
from nanomod.resquiggle.banded import (banded_sw, pack_codes2,  # noqa: E402
                                       walk_device)

W = 128
B = 64
REPS = 5


def bench_bucket(m):
    rng = np.random.default_rng(0)
    read_codes = rng.integers(0, 4, (B, m)).astype(np.uint8)
    ref_codes = rng.integers(0, 4, (B, m + W)).astype(np.uint8)
    lens = np.full(B, m, np.int32)
    # plant similarity so tracebacks are realistic length
    ref_codes[:, W // 2: W // 2 + m] = np.where(
        rng.random((B, m)) < 0.9, read_codes, ref_codes[:, W // 2: W // 2 + m])
    rd, rf, ln = jnp.asarray(read_codes), jnp.asarray(ref_codes), jnp.asarray(lens)

    dev = jax.devices()[0]
    out = {"bucket": m, "batch": B, "platform": dev.platform,
           "device_kind": dev.device_kind}

    def timed(fn, key):
        fn()                      # warm/compile
        ts = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        out[key] = round(float(np.median(ts)) * 1e3, 2)   # ms

    timed(lambda: jax.block_until_ready(banded_sw(rd, rf, ln)), "dp_ms")
    tb, best, bi, bk = banded_sw(rd, rf, ln)
    jax.block_until_ready(tb)
    timed(lambda: jax.block_until_ready(walk_device(tb, bi, bk)), "walk_ms")
    codes = walk_device(tb, bi, bk)
    jax.block_until_ready(codes)

    def pack_fetch():
        np.asarray(pack_codes2(codes))
    timed(pack_fetch, "pack_fetch_ms")
    return out


def main():
    use_compile_cache()
    buckets = [int(x) for x in sys.argv[1:]] or [2048, 4096, 8192, 16384]
    for m in buckets:
        print(json.dumps(bench_bucket(m)), flush=True)


if __name__ == "__main__":
    main()
