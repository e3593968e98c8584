"""Event-extraction dialects and normalization tests."""

import numpy as np
import pytest

from nanomod.signal.events import (EventError, extract_albacore1,
                                       extract_albacore2, extract_guppy)
from nanomod.signal.normalize import (kmer_shift_scale, load_kmer_model,
                                          mad_normalize)

A2_DTYPE = np.dtype([("mean", "<f8"), ("stdv", "<f8"), ("start", "<u8"),
                     ("length", "<u8"), ("model_state", "S5"),
                     ("move", "<i4")])


def _a2_events(seq, dwells):
    ev = np.zeros(len(seq), dtype=A2_DTYPE)
    ev["move"] = 1
    ev["move"][0] = 0
    ev["start"] = np.concatenate([[0], np.cumsum(dwells[:-1])])
    ev["length"] = dwells
    ev["mean"] = np.arange(len(seq), dtype=float)
    for i, b in enumerate(seq):
        ctx = ("NN" + seq + "NN")[i: i + 5]
        ev["model_state"][i] = ctx.encode()
    return ev


def test_albacore2_grouping():
    seq = "ACGTACGT"
    dwells = np.full(8, 10, np.uint64)
    ev = _a2_events(seq, dwells)
    # split base 3 into two rows (move=0 continuation)
    rows = np.concatenate([ev[:4], ev[3:4], ev[4:]])
    rows["move"][4] = 0
    rows["start"][4:] = rows["start"][4:]  # starts already fine for test
    t = extract_albacore2(rows)
    assert t.seq == seq
    assert len(t.mean) == 8
    # base 3 got the extra row's length summed
    assert t.length[3] == 20


def test_albacore1_time_based():
    rate = 4000.0
    seq = "A" * 30 + "CGT" * 10
    n = len(seq)
    ev = np.zeros(n, dtype=A2_DTYPE)
    ev["move"] = 1
    ev["move"][:2] = 0      # leading move-0 rows get trimmed
    ev["move"][-1] = 0
    dwell_s = np.full(n, 10 / rate)
    starts_s = 0.25 + np.concatenate([[0], np.cumsum(dwell_s[:-1])])
    ev_f = np.zeros(n, dtype=[("mean", "<f8"), ("stdv", "<f8"),
                              ("start", "<f8"), ("length", "<f8"),
                              ("model_state", "S5"), ("move", "<i4")])
    for k in ("mean", "stdv", "move", "model_state"):
        ev_f[k] = ev[k]
    ev_f["start"] = starts_s
    ev_f["length"] = dwell_s
    for i, b in enumerate(seq):
        ev_f["model_state"][i] = (("NN" + seq + "NN")[i: i + 5]).encode()
    t = extract_albacore1(ev_f, rate, raw_start_time=1000)
    assert t.seq == seq[2:-1]
    assert t.start[0] == int(round(starts_s[2] * rate)) - 1000
    assert (np.diff(t.start) > 0).all()


def test_albacore1_too_many_move0():
    ev = np.zeros(30, dtype=A2_DTYPE)
    ev["move"] = 0
    ev["move"][14] = 1      # single move leaves <20 usable rows
    with pytest.raises(EventError):
        extract_albacore1(ev.astype(A2_DTYPE), 4000.0, 0)


def test_guppy_move_table():
    fq = "ACGTACGTAC"
    raw = np.arange(100, dtype=np.float64)
    move = np.zeros(40, np.int8)
    move[[0, 4, 8, 12, 16, 20, 24, 28, 32, 36]] = 1
    t = extract_guppy(move, fq, raw, first_sample=4, stride=2)
    assert t.seq == fq[: len(t.mean)]
    assert t.start[0] == 4
    # segment means come from the raw signal
    assert t.mean[0] == pytest.approx(raw[4: int(t.start[1])].mean())


def test_mad_normalize_properties():
    rng = np.random.default_rng(0)
    raw = rng.normal(100, 12, 5000)
    out = mad_normalize(raw, (100, 4900))
    seg = out[100:4900]
    assert abs(np.median(seg)) < 0.01
    assert np.median(np.abs(seg - np.median(seg))) == pytest.approx(1.0, abs=0.05)
    # winsorized at +-5 MAD around the median
    assert seg.max() <= np.median(seg) + 5.05
    # values rounded to 3 decimals
    assert np.allclose(out, np.round(out, 3))


def test_kmer_shift_scale_recovers_transform(tmp_path):
    # synthetic model file; event means = shift + scale*level + noise
    rng = np.random.default_rng(1)
    kmers = ["AAAAA", "ACGTA", "TTTTT", "GGGGG", "CCCCC", "AGCTA"]
    levels = {k: 80 + 10 * i for i, k in enumerate(kmers)}
    model_file = tmp_path / "model.txt"
    with open(model_file, "w") as f:
        f.write("#kmer\tlevel_mean\tlevel_stdv\n")
        for k, v in levels.items():
            f.write(f"{k}\t{v}\t2.0\n")
    model = load_kmer_model(str(model_file))
    assert model["AAAAA"][0] == 80.0

    states = np.array([rng.choice(kmers) for _ in range(500)])
    true_shift, true_scale = 14.0, 1.8
    means = np.array([true_shift + true_scale * levels[s] for s in states])
    means += rng.normal(0, 0.01, len(means))
    shift, scale = kmer_shift_scale(means, states, model)
    assert shift == pytest.approx(true_shift, abs=0.1)
    assert scale == pytest.approx(true_scale, abs=0.01)
