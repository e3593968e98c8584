"""Backend equivalence for the two-sample battery.

The battery has two compute backends producing bit-identical statistics:
the tiled device kernels (stats/kernels.py) and the native host battery
(native/sort_core.cpp nm_battery_milli); stats/battery.battery_backend
picks the device on the GPU and the host on the CPU.  These tests pin the
bit-parity contract on adversarial pools: heavy ties, tiny/degenerate
counts, capped-KS rows, mstd capture, and the non-milli fallback.
Replaces the reference's per-position scipy loop semantics
(ref bin/scripts/myDetect.py:327-363).
"""

import numpy as np
import pytest

from nanomod.config import StatConfig
from nanomod.native.build import load_native
from nanomod.stats.battery import run_battery

FIELDS = ("stu", "pu", "stt", "pt", "stks", "pks")

pytestmark = pytest.mark.skipif(
    load_native("sort_core") is None
    or not hasattr(load_native("sort_core"), "nm_battery_milli"),
    reason="native sort_core unavailable")


def _pools(seed, p=3000, c=48, ties=True):
    rng = np.random.default_rng(seed)
    if ties:
        v1 = np.round(rng.choice(np.arange(-3.0, 3.0, 0.25), (p, c)),
                      3).astype(np.float32)
    else:
        v1 = np.round(rng.normal(0, 1, (p, c)), 3).astype(np.float32)
    v2 = np.round(rng.normal(0, 1, (p, c)), 3).astype(np.float32)
    c1 = rng.integers(1, c, p).astype(np.int32)
    c2 = rng.integers(1, c, p).astype(np.int32)
    # degenerate rows: empty pools, single observation, all-equal values
    c1[0] = 0
    v1[0, :] = 0
    c2[1] = 1
    v1[2, :] = 1.5
    v2[2, :] = 1.5
    return v1, c1, v2, c2


def _assert_equal(rd, rh, mstd=False):
    for f in FIELDS:
        a, b = getattr(rd, f), getattr(rh, f)
        assert np.array_equal(a, b, equal_nan=True), f
    if mstd:
        assert np.array_equal(rd.mstd, rh.mstd, equal_nan=True)


@pytest.mark.parametrize("ties", [True, False])
def test_host_matches_device_uncapped(ties):
    v1, c1, v2, c2 = _pools(11, ties=ties)
    rd = run_battery(v1, c1, v2, c2, backend="device", want_mstd=True)
    rh = run_battery(v1, c1, v2, c2, backend="host", want_mstd=True)
    _assert_equal(rd, rh, mstd=True)


def test_host_matches_device_capped_both_strands():
    v1, c1, v2, c2 = _pools(12)
    cfg = StatConfig(coverages=(16, 24))
    for strand in ("+", "-"):
        rd = run_battery(v1, c1, v2, c2, strand=strand, cfg=cfg,
                         backend="device")
        rh = run_battery(v1, c1, v2, c2, strand=strand, cfg=cfg,
                         backend="host")
        _assert_equal(rd, rh)


def test_host_matches_device_row_offset():
    """Capped-KS RNG keyed per absolute row: a shard holding rows
    [off, off+P) must reproduce the whole-join draws on both backends."""
    v1, c1, v2, c2 = _pools(13, p=1200)
    cfg = StatConfig(coverages=(10, 10))
    full_d = run_battery(v1, c1, v2, c2, cfg=cfg, backend="device")
    off = 400
    part_h = run_battery(v1[off:], c1[off:], v2[off:], c2[off:], cfg=cfg,
                         backend="host", row_offset=off)
    for f in FIELDS:
        assert np.array_equal(getattr(full_d, f)[off:], getattr(part_h, f),
                              equal_nan=True), f


def test_host_int16_milli_input():
    v1, c1, v2, c2 = _pools(14)
    i1 = np.rint(v1 * 1000).astype(np.int16)
    i2 = np.rint(v2 * 1000).astype(np.int16)
    rd = run_battery(v1, c1, v2, c2, backend="device")
    rh = run_battery(i1, c1, i2, c2, backend="host")
    _assert_equal(rd, rh)


def test_non_milli_values_fall_back_to_device():
    """Values violating the 3-decimal invariant cannot use the exact
    integer host path; backend="host" must silently produce the device
    result instead."""
    rng = np.random.default_rng(15)
    p, c = 500, 16
    v1 = rng.normal(0, 1, (p, c)).astype(np.float32)   # full f32 precision
    v2 = rng.normal(0, 1, (p, c)).astype(np.float32)
    c1 = rng.integers(2, c, p).astype(np.int32)
    c2 = rng.integers(2, c, p).astype(np.int32)
    rd = run_battery(v1, c1, v2, c2, backend="device")
    rh = run_battery(v1, c1, v2, c2, backend="host")
    _assert_equal(rd, rh)


def test_backend_env_override(monkeypatch):
    import nanomod.stats.battery as bat
    monkeypatch.setenv("NANOMOD_BATTERY_BACKEND", "host")
    assert bat.battery_backend() == "host"
    monkeypatch.setenv("NANOMOD_BATTERY_BACKEND", "device")
    assert bat.battery_backend() == "device"


@pytest.mark.parametrize("platform,want", [("gpu", "device"),
                                           ("cpu", "host")])
def test_backend_rule_follows_platform(monkeypatch, platform, want):
    """No override: the platform decides, and nothing is run to decide."""
    import jax

    import nanomod.stats.battery as bat
    from nanomod.stats import kernels

    def no_kernel(*a, **k):
        raise AssertionError("backend choice must not run the battery")

    monkeypatch.delenv("NANOMOD_BATTERY_BACKEND", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    monkeypatch.setattr(kernels, "battery_components_packed_milli", no_kernel)
    monkeypatch.setattr(bat, "_run_battery_host", no_kernel)
    assert bat.battery_backend() == want


@pytest.mark.parametrize("value", ["auto", "Host", "native", "gpu"])
def test_backend_unknown_override_is_an_error(monkeypatch, value):
    import nanomod.stats.battery as bat
    monkeypatch.setenv("NANOMOD_BATTERY_BACKEND", value)
    with pytest.raises(ValueError, match="NANOMOD_BATTERY_BACKEND"):
        bat.battery_backend()


def test_host_idx_gather_matches_materialized():
    """idx1/idx2 in-place gathers (the join path) must equal the
    materialized fancy-index copies on both backends, including capped
    rows routed through the composed index."""
    v1, c1, v2, c2 = _pools(16, p=2000)
    rng = np.random.default_rng(17)
    i1 = rng.permutation(2000)[:1200]
    i2 = rng.permutation(2000)[:1200]
    cfg = StatConfig(coverages=(12, 12))
    rd = run_battery(v1[i1], c1[i1], v2[i2], c2[i2], cfg=cfg,
                     backend="device")
    rh = run_battery(v1, c1[i1], v2, c2[i2], cfg=cfg, backend="host",
                     idx1=i1, idx2=i2)
    _assert_equal(rd, rh)
    # device path with idx materializes internally - same result
    rdi = run_battery(v1, c1[i1], v2, c2[i2], cfg=cfg, backend="device",
                      idx1=i1, idx2=i2)
    _assert_equal(rd, rdi)
