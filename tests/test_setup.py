"""Process and build setup: the compile-cache rule, the native build key,
one device per process under jax.distributed, the minimal HDF5 writer,
and chip_smoke.py's refusal to run without a GPU."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- compile cache -------------------------------------------------------

def _record_config_updates(monkeypatch):
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    return calls


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    from nanomod import use_compile_cache

    calls = _record_config_updates(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert use_compile_cache() == str(tmp_path)
    assert calls == []          # JAX reads the variable itself


def test_compile_cache_default_is_fixed_checkout_path(monkeypatch):
    from nanomod import use_compile_cache

    calls = _record_config_updates(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert use_compile_cache() == want
    assert calls == [("jax_compilation_cache_dir", want)]


# ---- native build key ----------------------------------------------------

def test_native_lib_path_keyed_on_cpu_and_source(monkeypatch, tmp_path):
    from nanomod.native import build

    here = build.lib_path("traceback")
    assert os.path.dirname(here) == build._OUT
    monkeypatch.setattr(build, "_cpu_identity", lambda: "another machine")
    assert build.lib_path("traceback") != here
    monkeypatch.undo()

    # an edited source gets a new key
    src = tmp_path / "traceback.cpp"
    with open(os.path.join(build._DIR, "traceback.cpp"), "rb") as f:
        src.write_bytes(f.read() + b"\n// edited\n")
    monkeypatch.setattr(build, "_DIR", str(tmp_path))
    assert os.path.basename(build.lib_path("traceback")) != \
        os.path.basename(here)


def test_foreign_library_is_never_loaded(monkeypatch, tmp_path):
    """A .so left beside the source or built for another CPU is ignored:
    the loader builds (or finds) the one keyed on this CPU and source."""
    from nanomod.native import build

    monkeypatch.setattr(build, "_OUT", str(tmp_path / "_lib"))
    monkeypatch.setattr(build, "_CACHE", {})
    os.makedirs(build._OUT)
    foreign = tmp_path / "_lib" / "libtraceback-0000000000000000.so"
    foreign.write_bytes(b"not a shared object")
    lib = build.load_native("traceback")
    assert lib is not None
    assert lib._name == build.lib_path("traceback")
    assert not foreign.exists()          # stale sibling removed


def test_native_build_failure_is_reported(monkeypatch, tmp_path, capsys):
    from nanomod.native import build

    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(build, "_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_OUT", str(tmp_path / "_lib"))
    monkeypatch.setattr(build, "_CACHE", {})
    monkeypatch.setattr(build, "_ERRORS", {})
    assert build.load_native("broken") is None
    assert "error" in build.build_errors()["broken"]
    assert "native broken unavailable" in capsys.readouterr().err


# ---- one device per process ----------------------------------------------

@pytest.mark.parametrize("nproc,per_host,pid,want", [
    (4, None, 0, [0]), (4, None, 3, [3]), (8, 4, 5, [1])])
def test_distributed_initialize_binds_one_device(monkeypatch, nproc,
                                                 per_host, pid, want):
    import jax

    from nanomod.parallel import dist

    seen = {}
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    dist.initialize("localhost:1234", nproc, pid,
                    processes_per_host=per_host)
    assert seen["local_device_ids"] == want
    assert seen["process_id"] == pid


def test_distributed_initialize_single_process_is_noop(monkeypatch):
    import jax

    from nanomod.parallel import dist

    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: pytest.fail("must not initialize"))
    dist.initialize(None, 1, 0)


# ---- minimal HDF5 writer ---------------------------------------------------

def test_h5write_tree_reads_back_natively(tmp_path):
    """A raw FAST5 written without libhdf5 goes through the native raw
    prepare (parse, event extraction, normalization)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fixtures import make_genome, make_raw_dataset

    from nanomod.native.prepare_bind import native_prepare_batch

    chrom, genome = make_genome(length=600, seed=4)
    paths = make_raw_dataset(str(tmp_path), chrom, genome, n_reads=4,
                             seed=9, read_len=300, error_rate=0.0)
    res = native_prepare_batch(paths, "Basecall_1D_000",
                               "BaseCalled_template", nthreads=2)
    assert res is not None
    for r in res:
        assert not isinstance(r, str) and r is not None, r
        assert len(r.seq) == 300
        assert np.isfinite(r.norm_signal).all()


def test_h5write_rejects_what_it_cannot_encode(tmp_path):
    from nanomod.io.h5write import write_h5

    with pytest.raises(TypeError):
        write_h5(str(tmp_path / "a.h5"), {"x": np.zeros(3, ">f8")})
    with pytest.raises(ValueError):
        write_h5(str(tmp_path / "b.h5"),
                 {f"g{i}": {} for i in range(9)})


def test_h5write_matches_h5py_view(tmp_path):
    h5py = pytest.importorskip("h5py")
    from nanomod.io.h5write import write_h5

    ev = np.zeros(3, [("a", "<f8"), ("b", "<u8"), ("s", "S5"), ("m", "<i4")])
    ev["a"] = [0.5, 1.5, 2.5]
    ev["s"] = [b"ACGTA", b"CC", b""]
    path = write_h5(str(tmp_path / "t.h5"), {
        "@attrs": {"f": 2.5, "i": -3, "s": b"xyz"},
        "g": {"sig": np.arange(5, dtype=np.int16), "txt": b"hello"},
        "ev": ev})
    with h5py.File(path, "r") as f:
        assert dict(f.attrs) == {"f": 2.5, "i": -3, "s": b"xyz"}
        assert f["g/sig"][()].tolist() == [0, 1, 2, 3, 4]
        assert f["g/txt"][()] == b"hello"
        assert f["ev"][()].tobytes() == ev.tobytes()


# ---- chip_smoke.py ---------------------------------------------------------

def test_chip_smoke_refuses_cpu_only_jax():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=env, cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "no GPU" in p.stderr
