"""Build + load the native (C++) components via ctypes.

The reference leans on external C binaries (bwa, samtools, HDF5 — ref
env.py27nanomod.yml); this framework's native layer is built in-tree with
g++ from the committed sources and loaded through ctypes.

Each library is built into the git-ignored ``_lib/`` directory under a
file name keyed on a hash of its source, its compiler flags and the host
CPU's identity.  ``-march=native`` code is valid only on the CPU it was
built for, so a library built from another source or copied in from
another machine is never reused.  A failed build is reported on stderr
and kept in ``build_errors()``; the callers then take their pure-Python
(or h5py) path.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import platform
import subprocess
import sys
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_OUT = os.path.join(_DIR, "_lib")
_LOCK = threading.Lock()
_CACHE = {}
_ERRORS = {}

NAMES = tuple(sorted(os.path.basename(p)[:-4]
                     for p in glob.glob(os.path.join(_DIR, "*.cpp"))))

_BASE_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_EXTRA_FLAGS = {
    "annotate_core": ["-pthread"],
    "fast5_ingest": ["-lz", "-pthread"],
    "fast5_write": ["-lz", "-pthread"],
    "sort_core": ["-pthread"],
    "traceback": ["-pthread"],
    "format_core": ["-pthread"],
}

# optional faster deflate backend (standard zlib output): first flag set
# that links wins; plain zlib is the guaranteed fallback
_OPTIONAL_FLAGS = {
    "fast5_write": [["-l:libdeflate.so.0"], ["-ldeflate"],
                    ["-DNO_LIBDEFLATE"]],
    "fast5_ingest": [["-l:libdeflate.so.0"], ["-ldeflate"],
                     ["-DNO_LIBDEFLATE"]],
}

# /proc/cpuinfo fields that identify what -march=native compiles for
_CPU_FIELDS = ("vendor_id", "cpu family", "model", "model name", "stepping",
               "flags", "Features", "CPU implementer", "CPU part")


def _cpu_identity() -> str:
    """Architecture + the first CPU's identifying /proc/cpuinfo fields."""
    ident = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break                      # end of the first CPU
                key = line.split(":", 1)[0].strip()
                if key in _CPU_FIELDS:
                    ident.append(line.strip())
    except OSError:
        pass
    return "\n".join(ident)


def _recipe(name: str):
    """(flags after the source, alternative optional flag sets)."""
    return _EXTRA_FLAGS.get(name, []), _OPTIONAL_FLAGS.get(name, [[]])


def lib_path(name: str) -> str:
    """Where the library for this source, recipe and CPU lives."""
    with open(os.path.join(_DIR, f"{name}.cpp"), "rb") as f:
        src = f.read()
    h = hashlib.sha256(src)
    h.update(repr((_BASE_FLAGS, _recipe(name))).encode())
    h.update(_cpu_identity().encode())
    return os.path.join(_OUT, f"lib{name}-{h.hexdigest()[:16]}.so")


def _build(name: str) -> str:
    lib = lib_path(name)
    if os.path.exists(lib):
        return lib
    os.makedirs(_OUT, exist_ok=True)
    src = os.path.join(_DIR, f"{name}.cpp")
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    extra, optional = _recipe(name)
    last = None
    for opt in optional:
        try:
            # libraries (-l) must follow the source that needs them
            subprocess.run(["g++", *_BASE_FLAGS, "-o", tmp, src, *extra,
                            *opt], check=True, capture_output=True)
        except subprocess.CalledProcessError as e:
            last = e
            continue
        os.replace(tmp, lib)          # atomic: concurrent builders agree
        for stale in glob.glob(os.path.join(_OUT, f"lib{name}-*.so")):
            if stale != lib:
                try:                  # another builder may have removed it
                    os.remove(stale)
                except FileNotFoundError:
                    pass
        return lib
    raise last


def load_native(name: str):
    """ctypes.CDLL for nanomod/native/<name>.cpp, building on demand.
    Returns None when it cannot be built or loaded (see build_errors)."""
    with _LOCK:
        if name in _CACHE:
            return _CACHE[name]
        try:
            lib = ctypes.CDLL(_build(name))
        except subprocess.CalledProcessError as e:
            lib = None
            _ERRORS[name] = (e.stderr or b"").decode(errors="replace")
        except OSError as e:           # no compiler, or the .so won't load
            lib = None
            _ERRORS[name] = str(e)
        if lib is None:
            print(f"nanomod: native {name} unavailable, using the Python "
                  f"path: {_ERRORS[name].strip()[-2000:]}", file=sys.stderr)
        _CACHE[name] = lib
        return lib


def native_available(name: str) -> bool:
    return load_native(name) is not None


def build_errors() -> dict:
    """{name: compiler stderr or load error} for libraries that failed."""
    with _LOCK:
        return dict(_ERRORS)
