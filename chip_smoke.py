#!/usr/bin/env python
"""Smoke run of nanomod's main paths on NVIDIA GPUs.

    python chip_smoke.py          # one GPU: phases (a)-(e)
    python chip_smoke.py --four   # four GPUs: multi-device detect and
                                  # Annotate against one device, nothing else

(a) environment: the card, JAX, the native libraries (one that fails to
    build fails the run, with the compiler's stderr);
(b) golden parity: the five golden detect variants (tests/test_golden.py),
    battery on the device, byte-match tests/golden;
(c) device against reference, bit-exact: banded_sw + walk_device at
    B=256, M=4096, W=128 on the GPU and on the CPU backend; one
    16,384-position battery tile of phase (d)'s pools on the GPU and in the
    native host battery;
(d) detect through the CLI at bacterial-genome scale: a 4.6 Mb genome,
    2 x 35k corrected 3 kb reads, 20 planted sites; stage seconds,
    positions/s, planted sites in the top 50, peak device memory, and the
    battery stage timed with the host and the device backend;
(e) Annotate through the CLI: 2,048 raw 3 kb + 256 raw 8 kb reads at 3%
    error over a 50 kb region of the same genome, split into a control and
    a case group with 5 planted pA shifts; reads/s, errors, stage seconds,
    then one profiler window per length bucket (device time of banded_sw and
    walk_device, device idle share), then detect on the annotated reads.

All data is generated from seeds into a temporary directory; one process
drives the card(s).  Every number is printed with the card's name and
power limit.  The last line of stdout is the JSON result, printed only when
every phase passed; without a GPU the script exits non-zero first.
"""

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# phase (d): tools/scale_quality.py seed 0 (tools/scale_manifest.json)
GENOME_LEN, N_SITES, CHROM = 4_600_000, 20, "ecoli_syn"
D_READS, D_READ_LEN = 35_000, 3_000
D_MIN_RECALL = 19
# phase (e)
E_REGION = (1_000_000, 1_050_000)
E_SITES = (1_010_000, 1_020_000, 1_025_000, 1_035_000, 1_040_000)
E_READS = ((3_000, 1_024), (8_000, 128))          # (length, reads) per group
E_PROFILE = ((3_000, 256), (8_000, 64))           # reads per profiler window
E_ERROR, E_DELTA_PA = 0.03, 6.0
# phase (c)
C_B, C_M, C_W = 256, 4096, 128
C_TILE = 16_384

CARD = "?"
CLI_LOG = os.devnull


def run_cli(argv):
    """nanomod.cli.main in this process, its own report sent to CLI_LOG."""
    from nanomod import cli

    with open(CLI_LOG, "a") as log, contextlib.redirect_stdout(log):
        return cli.main(argv)


def say(phase, what, value=""):
    print(f"({phase}) {what}{': ' if value != '' else ''}{value}  [{CARD}]",
          flush=True)


def card_label():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    return out.splitlines()


def peak_bytes(devices):
    return [d.memory_stats()["peak_bytes_in_use"] for d in devices]


# ---- (a) -------------------------------------------------------------------

def phase_a():
    import jax

    from nanomod.native.build import NAMES, build_errors, lib_path, load_native

    say("a", "jax", f"{jax.__version__}, devices {jax.devices()}")
    for name in NAMES:
        ok = load_native(name) is not None
        say("a", f"native {name}",
            f"loaded {os.path.basename(lib_path(name))}" if ok else "FAILED")
    for mod in ("h5py", "matplotlib"):
        try:
            __import__(mod)
            say("a", mod, "importable")
        except ImportError:
            say("a", mod, "absent (not needed by the main path)")
    errors = build_errors()
    for name, err in errors.items():
        print(f"--- {name} build/load error ---\n{err}", file=sys.stderr)
    if errors:
        raise RuntimeError(f"native libraries failed: {sorted(errors)}")


# ---- (b) -------------------------------------------------------------------

def phase_b(work):
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_golden import GOLDEN, VARIANTS, _load_group

    from nanomod.accum.pools import PoolBuilder
    from nanomod.config import DetectConfig
    from nanomod.detect import detect_from_pools, save_sign_test
    from nanomod.stats.battery import battery_backend

    if battery_backend() != "device":
        raise RuntimeError(f"battery backend {battery_backend()!r} on GPU")
    pools = []
    for group in ("group1", "group2"):
        b = PoolBuilder()
        for read in _load_group(group):
            b.add_read(*read)
        pools.append(b.finalize())
    out = os.path.join(work, "golden")
    for name in sorted(VARIANTS):
        cfg = DetectConfig(out_folder=out, file_id=name, **VARIANTS[name])
        table, _ = detect_from_pools(pools[0], pools[1], cfg)
        files = [(save_sign_test(table, cfg),
                  f"golden_{name}_sign_test.txt")]
        if cfg.mstd:
            files.append((os.path.join(out, f"{name}_meanstd.cvs"),
                          f"golden_{name}_meanstd.cvs"))
        for got, want in files:
            with open(got, "rb") as f, \
                    open(os.path.join(GOLDEN, want), "rb") as g:
                a, b = f.read(), g.read()
            if a != b:
                raise AssertionError(f"{want}: bytes differ on the GPU")
            say("b", f"golden {want}", f"byte-identical, {len(a)} bytes")


# ---- (c) -------------------------------------------------------------------

def dp_inputs(rng):
    """Reads drawn from their reference windows with 3% substitutions and
    1% insertions/deletions, some shorter than the bucket."""
    ref = rng.integers(0, 4, (C_B, C_M + C_W)).astype(np.uint8)
    read = np.full((C_B, C_M), 4, np.uint8)
    lens = np.full(C_B, C_M, np.int32)
    lens[::7] = C_M * 3 // 4
    for b in range(C_B):
        src = ref[b, C_W // 2:]
        r = rng.random(len(src))
        reps = (r >= 0.01).astype(np.int64) + (r >= 0.99)
        s = np.repeat(src, reps)
        sub = rng.random(len(s)) < 0.03
        s[sub] = rng.integers(0, 4, int(sub.sum()))
        lens[b] = min(lens[b], len(s))
        read[b, : lens[b]] = s[: lens[b]]
    return read, ref, lens


def phase_c_dp():
    import jax

    from nanomod.resquiggle.banded import banded_sw, walk_device

    read, ref, lens = dp_inputs(np.random.default_rng(5))
    outs = []
    for dev in (jax.devices()[0], jax.devices("cpu")[0]):
        args = [jax.device_put(x, dev) for x in (read, ref, lens)]
        t0 = time.perf_counter()
        tb, best, bi, bk = banded_sw(*args)
        codes = walk_device(tb, bi, bk)
        outs.append([np.asarray(x) for x in (tb, best, bi, bk, codes)])
        say("c", f"banded_sw+walk_device on {dev.platform}, first call",
            f"{time.perf_counter() - t0:.3f} s")
    names = ("tb", "best", "best_i", "best_k", "walk codes")
    for name, g, c in zip(names, *outs):
        if g.shape != c.shape or not np.array_equal(g, c):
            raise AssertionError(f"{name}: GPU differs from CPU")
    say("c", f"banded_sw + walk_device B={C_B} M={C_M} W={C_W}",
        f"bit-identical GPU vs CPU ({', '.join(names)}); "
        f"mean best score {outs[0][1].mean():.1f}")


def phase_c_battery(pools1, pools2):
    from nanomod.accum.pools import join_pools
    from nanomod.stats.battery import run_battery

    key, _, i1, i2 = max(join_pools(pools1, pools2), key=lambda j: len(j[1]))
    g1, g2 = pools1[key], pools2[key]
    i1, i2 = i1[:C_TILE], i2[:C_TILE]
    args = (g1.values[i1], g1.counts[i1], g2.values[i2], g2.counts[i2])
    res = {b: run_battery(*args, strand=key[1], tile_positions=C_TILE,
                          want_mstd=True, backend=b)
           for b in ("device", "host")}
    for f in ("stu", "pu", "stt", "pt", "stks", "pks", "mstd"):
        a, b = getattr(res["device"], f), getattr(res["host"], f)
        if not np.array_equal(a, b, equal_nan=True):
            raise AssertionError(f"battery {f}: GPU differs from host")
    say("c", f"battery tile {len(i1)} positions of {key}, "
        f"max coverage {int(args[1].max())}/{int(args[3].max())}",
        "bit-identical GPU vs native host battery (all statistics + mstd)")


# ---- (d) -------------------------------------------------------------------

def recall(sites, planted, close=4, top_n=50):
    """Planted sites with a top-`top_n` site within `close` positions (the
    reference's getTopRank tolerance, tools/scale_quality.py)."""
    top = np.array([s.pos for s in sites[:top_n]], np.int64)
    if not len(top):
        return 0
    return sum(1 for p in planted if np.abs(top - p).min() <= close)


def stage_line(snapshot):
    return ", ".join(f"{k} {v['seconds']:.3f}s" for k, v in snapshot.items())


def detect_cli(ctrl, case, out, extra=()):
    from nanomod.utils.observe import observer

    t0 = time.perf_counter()
    table, _, sites = run_cli(
        ["detect", "--wrkBase1", ctrl, "--wrkBase2", case,
         "--outFolder", out, "--FileID", "smoke", "--min_lr", "0",
         "--window", "21", "--topN", "50", "--outLevel", "3", *extra])
    return table, sites, time.perf_counter() - t0, observer().snapshot()


def make_detect_data(work):
    from nanomod.harness.synth import scale_genome, write_corrected_group

    genome, levels, planted = scale_genome(0, GENOME_LEN, N_SITES)
    ctrl, case = os.path.join(work, "ctrl"), os.path.join(work, "case")
    t0 = time.perf_counter()
    nt = os.cpu_count() or 4
    write_corrected_group(ctrl, CHROM, genome, levels,
                          np.random.default_rng(1), D_READS, D_READ_LEN,
                          nthreads=nt)
    write_corrected_group(case, CHROM, genome, levels,
                          np.random.default_rng(2), D_READS, D_READ_LEN,
                          planted=planted, nthreads=nt)
    say("d", f"generated 2 x {D_READS} corrected {D_READ_LEN} b reads over "
        f"{GENOME_LEN} b", f"{time.perf_counter() - t0:.1f} s")
    return genome, planted, ctrl, case


def phase_d(work):
    import jax

    from nanomod.config import DetectConfig, RankConfig
    from nanomod.detect import detect_from_pools, ingest_group
    from nanomod.utils.observe import observer

    genome, planted, ctrl, case = make_detect_data(work)
    table, sites, wall, stages = detect_cli(ctrl, case,
                                            os.path.join(work, "out"))
    found = recall(sites, planted)
    say("d", "detect wall (CLI, device battery)", f"{wall:.2f} s")
    say("d", "positions tested", len(table))
    say("d", "positions/s", f"{len(table) / wall:.1f}")
    say("d", "stage seconds", stage_line(stages))
    say("d", "planted sites in top 50", f"{found}/{N_SITES}")
    say("d", "peak_bytes_in_use", peak_bytes(jax.devices()[:1])[0])
    if found < D_MIN_RECALL:
        raise AssertionError(f"only {found}/{N_SITES} planted sites")

    # the battery stage on each backend, same pools, warm compile cache
    cfg = DetectConfig(wrk_base1=ctrl, wrk_base2=case, min_lr=0,
                       rank=RankConfig(window=10), out_level=3)
    pools1, pools2 = ingest_group(ctrl, cfg), ingest_group(case, cfg)
    for backend in ("host", "device"):
        os.environ["NANOMOD_BATTERY_BACKEND"] = backend
        try:
            observer().reset()
            detect_from_pools(pools1, pools2, cfg)
        finally:
            del os.environ["NANOMOD_BATTERY_BACKEND"]
        st = observer().snapshot()["test_battery"]
        say("d", f"battery stage, {backend} backend",
            f"{st['seconds']:.3f} s for {st['items']} positions")
    phase_c_battery(pools1, pools2)
    return genome


# ---- (e) -------------------------------------------------------------------

def make_annotate_data(work, genome, tag=""):
    from nanomod.harness.synth import _kmer_tables, write_raw_group

    tables = _kmer_tables()
    groups = {}
    for g, (name, planted) in enumerate((("ctrl", ()), ("case", E_SITES))):
        folder = os.path.join(work, f"raw_{name}{tag}")
        first = 0
        for k, (length, n) in enumerate(E_READS):
            write_raw_group(folder, genome, np.random.default_rng(20 + 2 * g + k),
                            n, length, region=E_REGION, planted=planted,
                            mod_delta_pa=E_DELTA_PA, error_rate=E_ERROR,
                            first_index=first, tables=tables)
            first += n
        groups[name] = folder
    return groups


def write_fasta(path, genome):
    g = genome.tobytes().decode()
    with open(path, "w") as f:
        f.write(f">{CHROM}\n")
        for lo in range(0, len(g), 80):
            f.write(g[lo: lo + 80] + "\n")
    return path


def annotate_cli(folder, fasta, extra=()):
    from nanomod.utils.observe import observer

    t0 = time.perf_counter()
    n_ok, errors = run_cli(["Annotate", "--wrkBase1", folder, "--Ref", fasta,
                             "--outLevel", "3", *extra])
    return n_ok, errors, time.perf_counter() - t0, observer().snapshot()


def phase_e(work, genome):
    import jax

    from nanomod.utils.observe import device_time

    os.makedirs(work)
    fasta = write_fasta(os.path.join(work, "ref.fa"), genome)
    t0 = time.perf_counter()
    groups = make_annotate_data(work, genome)
    n_total = sum(n for _, n in E_READS)
    say("e", f"generated 2 x {n_total} raw reads "
        f"({', '.join(f'{n} x {ln} b' for ln, n in E_READS)}) at "
        f"{E_ERROR:.0%} error", f"{time.perf_counter() - t0:.1f} s")
    for name, folder in groups.items():
        n_ok, errors, wall, stages = annotate_cli(folder, fasta)
        n_err = sum(len(v) for v in errors.values())
        say("e", f"Annotate {name}: annotated/errors",
            f"{n_ok}/{n_err} of {n_total}")
        say("e", f"Annotate {name}: reads/s", f"{n_ok / wall:.1f}")
        say("e", f"Annotate {name}: stage seconds", stage_line(stages))
        if n_ok < 0.98 * n_total:
            raise AssertionError(f"Annotate {name}: {n_ok}/{n_total}, "
                                 f"errors {dict((k, len(v)) for k, v in errors.items())}")

    # one profiler window per length bucket, on copies of annotated reads,
    # after a warm-up run of the same shapes (no compile in the window)
    paths = sorted(os.listdir(groups["ctrl"]))
    first = 0
    for length, n in E_READS:
        n_prof = dict(E_PROFILE)[length]
        folder = os.path.join(work, f"prof_{length}")
        os.makedirs(folder)
        for p in paths[first: first + n_prof]:
            shutil.copy(os.path.join(groups["ctrl"], p), folder)
        first += n
        annotate_cli(folder, fasta)
        trace = os.path.join(work, f"trace_{length}")
        with jax.profiler.trace(trace):
            n_ok, _, wall, _ = annotate_cli(folder, fasta)
        dt = device_time(trace, ("banded_sw", "walk_device"))
        bucket = f"{n_prof} x {length} b reads"
        for m, ns in dt["by_module"].items():
            say("e", f"{bucket}: {m} device time", f"{ns / 1e6:.3f} ms")
        say("e", f"{bucket}: window wall / device busy",
            f"{wall * 1e3:.1f} ms / {dt['busy_ns'] / 1e6:.1f} ms "
            f"({dt['events']} device ops)")
        say("e", f"{bucket}: device idle share",
            f"{1 - dt['busy_ns'] / 1e9 / wall:.4f}")
        if not dt["by_module"]["banded_sw"]:
            raise AssertionError("no banded_sw device time in the trace")

    table, sites, wall, _ = detect_cli(groups["ctrl"], groups["case"],
                                       os.path.join(work, "out_e"))
    say("e", "detect on annotated reads: positions tested", len(table))
    say("e", "detect on annotated reads: planted sites in top 50",
        f"{recall(sites, E_SITES)}/{len(E_SITES)}")


# ---- --four ----------------------------------------------------------------

def corrected_bytes(folder):
    from nanomod.io.fast5 import iter_fast5_files
    from nanomod.native.fast5_bind import read_corrected_batch

    paths = sorted(iter_fast5_files(folder))
    return [(r.chrom, r.strand, r.start, r.norm_mean.tobytes(),
             r.norm_stdev.tobytes(), r.ev_start.tobytes(),
             r.ev_length.tobytes(), r.base.tobytes())
            if r is not None else None
            for r in read_corrected_batch(paths, nthreads=8)]


def phase_four(work):
    import jax

    devices = jax.devices()[:4]
    genome, planted, ctrl, case = make_detect_data(work)
    outs = {}
    for n in (1, 4):
        out = os.path.join(work, f"out_{n}")
        table, sites, wall, stages = detect_cli(
            ctrl, case, out, ("--n_devices", str(n)))
        with open(os.path.join(out, "smoke_sign_test.txt"), "rb") as f:
            outs[n] = f.read()
        say("f", f"detect --n_devices {n}: wall / positions/s / top 50",
            f"{wall:.2f} s / {len(table) / wall:.1f} / "
            f"{recall(sites, planted)}/{N_SITES}")
        say("f", f"detect --n_devices {n}: stage seconds", stage_line(stages))
    if outs[1] != outs[4]:
        raise AssertionError("detect _sign_test.txt differs, 4 vs 1 device")
    say("f", "detect _sign_test.txt, 4 devices vs 1",
        f"byte-identical, {len(outs[1])} bytes")
    shutil.rmtree(ctrl)
    shutil.rmtree(case)

    fasta = write_fasta(os.path.join(work, "ref.fa"), genome)
    ann = {}
    for n in (1, 4):
        folder = make_annotate_data(work, genome, tag=f"_{n}")["ctrl"]
        n_ok, errors, wall, stages = annotate_cli(
            folder, fasta, ("--n_devices", str(n)))
        ann[n] = corrected_bytes(folder)
        say("f", f"Annotate --n_devices {n}: annotated / reads/s",
            f"{n_ok} / {n_ok / wall:.1f}")
    if ann[1] != ann[4]:
        raise AssertionError("corrected events differ, 4 vs 1 device")
    say("f", "Annotate corrected events, 4 devices vs 1",
        f"byte-identical over {len(ann[1])} reads")
    peaks = peak_bytes(devices)
    for d, p in zip(devices, peaks):
        say("f", f"peak_bytes_in_use {d}", p)
    if min(peaks) <= 0:
        raise AssertionError("a device did no work")


# ---- main ------------------------------------------------------------------

def main(argv=None):
    global CARD, CLI_LOG
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU paths against one GPU")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r})",
              file=sys.stderr)
        return 2
    if args.four and len(devices) < 4:
        print(f"chip_smoke: --four needs 4 GPUs, JAX finds {len(devices)}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from nanomod import use_compile_cache

    cards = card_label()
    CARD = cards[0]
    for line in cards:
        print(line, flush=True)
    print(f"compile cache: {use_compile_cache()}", flush=True)

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    CLI_LOG = os.path.join(work, "cli.log")
    t0 = time.perf_counter()
    try:
        if args.four:
            phase_four(work)
        else:
            phase_a()
            phase_b(work)
            phase_c_dp()
            genome = phase_d(os.path.join(work, "d"))
            shutil.rmtree(os.path.join(work, "d"))
            phase_e(os.path.join(work, "e"), genome)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say("-", "total wall", f"{time.perf_counter() - t0:.1f} s")
    dev = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": dev[0].platform, "kind": dev[0].device_kind,
        "count": len(dev)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
