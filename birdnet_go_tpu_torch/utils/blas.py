"""The size of numpy's OpenBLAS thread pool, read and set in this process.

The realtime engine resamples every source on the source's own thread:
in JAX's ``StreamingResampler.process`` each 0.1 s chunk is one small
product (about 3,200 x 72 for 48 to 32 kHz; the port's sums its phases
with ``einsum`` instead), and the host planes make other small products.
With OpenBLAS's default pool, one thread a core, every such call wakes
the pool, and 64 source threads calling at once keep every core
spinning. The app caps the pool at one
thread (``Application.setup``), as it caps malloc's arenas. The numbers
do not change: a product's rows are summed alike whatever the pool's
size.

The library is found the way threadpoolctl finds it: the OpenBLAS shared
object this process has loaded (numpy's wheels bundle one whose symbols
carry a ``scipy_`` prefix and a ``64_`` suffix), its
``openblas_{get,set}_num_threads`` called through ctypes. A numpy built on
another BLAS has no such library, and nothing is set.
"""

from __future__ import annotations

import ctypes
import functools
import logging
from pathlib import Path

log = logging.getLogger("birdnet_tpu.blas")

_PREFIXES = ("", "scipy_")
_SUFFIXES = ("", "64_")


@functools.cache
def _openblas() -> tuple[tuple, ...]:
    """(get, set) of each OpenBLAS library loaded in this process."""
    import numpy  # noqa: F401 — loads numpy's BLAS

    with open("/proc/self/maps") as f:
        paths = sorted({p for p in (line.split()[-1] for line in f)
                        if "openblas" in Path(p).name.lower()
                        and ".so" in Path(p).name})
    found = []
    for path in paths:
        lib = ctypes.CDLL(path)
        for pre in _PREFIXES:
            for suf in _SUFFIXES:
                get = getattr(lib, f"{pre}openblas_get_num_threads{suf}",
                              None)
                put = getattr(lib, f"{pre}openblas_set_num_threads{suf}",
                              None)
                if get is not None and put is not None:
                    get.restype = ctypes.c_int
                    put.argtypes = [ctypes.c_int]
                    found.append((get, put))
    return tuple(found)


def blas_threads() -> list[int]:
    """The pool size of each OpenBLAS library loaded ([] for none)."""
    return [get() for get, _ in _openblas()]


def set_blas_threads(n: int) -> int:
    """Set every loaded OpenBLAS library's pool to `n` threads; returns
    how many libraries were set."""
    libs = _openblas()
    for _, put in libs:
        put(int(n))
    if not libs:
        log.info("no OpenBLAS loaded: BLAS threads left as they are")
    return len(libs)
