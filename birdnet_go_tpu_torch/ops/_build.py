"""Build the CUDA kernels in ``birdnet_go_tpu_torch/csrc/`` and load them.

On first use in a process, every ``csrc/*.cu`` is compiled with ``nvcc`` for
``sm_90a``, one ``nvcc`` per source, all started together, and the objects
are linked into one shared library with a plain C interface under
``build/torch_kernels/`` at the root of the checkout, loaded with
``ctypes``. The library's name carries a hash of the sources, so an edited
source is rebuilt and an unchanged one is reused. ``nvcc``'s output, with
ptxas's register and spill counts, is kept beside it (``build_log``). A
missing ``nvcc`` or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from birdnet_go_tpu_torch.utils import tracing

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libbirdnet_torch_kernels_{h.hexdigest()[:16]}.so"


def build_log() -> Path:
    """nvcc's output for the library of `library_path()`."""
    return library_path().with_suffix(".log")


def _declare_melspec(lib: ctypes.CDLL) -> None:
    """The C signatures of ``csrc/melspec.cu``."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.melspec_fused_launch.argtypes = [p, i, i, i, i, p, p, p, p, i, i, i,
                                         f, p, i, p]
    lib.melspec_fused_launch.restype = i
    lib.birdnet_cuda_error_string.argtypes = [i]
    lib.birdnet_cuda_error_string.restype = ctypes.c_char_p


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    _declare_melspec(lib)
    lib.expand_dw_pool_launch.argtypes = [p, i, p, p, p, p, p, p, p, i, p, p,
                                          i, i, i, i, i, i, i, i, p]
    lib.expand_dw_pool_launch.restype = i
    lib.expand_dw_pool_band_rows.argtypes = [i, i, i, i]
    lib.expand_dw_pool_band_rows.restype = i
    lib.scale_project_launch.argtypes = [p, i, p, p, p, p, p, i, p, i, i, i,
                                         i, i, i, p]
    lib.scale_project_launch.restype = i


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.is_file():
            _build(path)
            tracing.count("kernels.built")
        lib = ctypes.CDLL(str(path))
        _declare(lib)
        _lib = lib
        return lib


def _build(path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for obj, src in zip(objs, _sources())]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    try:
        for cmd, proc, out in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{out}")
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}): "
                               f"{' '.join(link)}\n{res.stdout}"
                               f"{res.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_log().write_text("".join(logs))
    os.replace(tmp, path)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a non-zero cudaError_t."""
    if err != 0:
        msg = lib.birdnet_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
