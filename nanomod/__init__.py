"""nanomod — a nanopore DNA-modification detection engine on JAX.

A from-scratch JAX/XLA rebuild of the capabilities of WGLab/NanoMod
(pure Python 2.7 + external bwa/samtools/R):

  * ``Annotate``  — per-read indel-corrected resquiggle: raw-current events are
    re-assigned to reference bases via a banded affine-gap DP (replacing
    ``bwa mem`` + greedy resegmentation, ref myRefBaseSignalAnnotation.py).
  * ``detect``    — per-genomic-position two-sample statistics (KS,
    Mann-Whitney U, Welch t) across grouped normalized signal means, plus
    neighbor p-value combination (weighted Stouffer / Fisher) and ranking
    (ref myDetect.py).
  * ``simulate`` / ``simulat2`` / ``DownSampling`` — evaluation harness that
    mixes case/control reads and measures the rank of a known modified site
    (ref mySimulate.py, mySimulat2.py, myDownSampling0.py).

Architecture: position-major dense signal pools, pairwise-count statistical
kernels with exact integer components, genome-coordinate sharding over a
device mesh (`shard_map` + ppermute halo exchange for the
neighbor-combination stencil), and a lax.scan banded-DP aligner.
"""

import os

__version__ = "0.2.0"


_MALLOC_TUNED = False

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def use_compile_cache():
    """Give JAX its persistent compilation cache; returns the directory.

    When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
    is set here.  Otherwise the cache is ``<checkout>/.jax_cache``: a fixed
    path, because the path is part of the cache key and a directory that
    moves never hits."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(_CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def tune_malloc():
    """Keep large heap buffers out of per-allocation mmap/munmap.

    glibc services every allocation above M_MMAP_THRESHOLD (128 kB
    default) with a fresh mmap and returns it to the kernel on free, so
    each large numpy temporary faults its pages in from scratch.  On
    virtualized hosts first-touch page faults are far slower than reused
    pages, which makes the host pipeline allocation-bound.  Raising
    the thresholds keeps freed blocks in the arena for reuse.  Trade-off:
    RSS stays at the high-water mark; peak memory is unchanged, which is
    what actually matters.

    Called lazily from the pipeline entry points (Annotate/detect/harness
    drivers) rather than at package import, so a host application that
    merely imports nanomod keeps its own malloc behavior.
    Disable with NANOMOD_NO_MALLOC_TUNE=1."""
    import ctypes
    import os
    import sys

    global _MALLOC_TUNED
    if _MALLOC_TUNED:
        return
    _MALLOC_TUNED = True
    if os.environ.get("NANOMOD_NO_MALLOC_TUNE") == "1":
        return
    if not sys.platform.startswith("linux"):
        return
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 2**31 - 1)
        libc.mallopt(M_TRIM_THRESHOLD, 2**31 - 1)
    except OSError:
        pass

from nanomod.config import DetectConfig, AnnotateConfig, SimulateConfig  # noqa: F401
