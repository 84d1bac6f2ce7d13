"""ctypes loader + wrappers for libbirdnet_host.so, the native host data
plane, and for the port's codec library: a copy of
``birdnet_go_tpu/native/lib.py``, so that the port imports nothing of the
JAX package.

The host library is built from the repository's ``native/*.cpp``,
unchanged, by ``make -C native BUILD_DIR=build/torch_native`` at the root
of the checkout (``build_native`` says which source it leaves out and which
header it adds). The codec library, ``libbirdnet_codecs.so`` beside it, is
built from the port's own ``csrc/codecs.cpp`` by the compiler alone
(``build_codecs``: g++ with ``-ldl`` and no codec header; Opus, MP3 and AAC
are dlopen'd at run time). The first ``_load`` or ``_load_codecs`` in a
process builds its library, which is rebuilt only when its source is newer,
under a file lock that keeps concurrent processes from writing it at once.
The port has its own build directory and never shares
``build/libbirdnet_host.so`` with the JAX loader. Four things differ from
the original: a failed build or load raises, so nothing quietly drops to
the Python buffers (a codec library missing at run time is another matter:
its ``*_available()`` is false, as in JAX); the codec bindings live on the
codec library; ``StreamFarm.collect`` checks its buffers before it passes
their pointers; and ``NativeAnalysisBuffer.read`` allocates a window only
when one is ready (the app's loop polls every ring every tick).
``fill_provider`` adapts a farm to ``DeviceLoop.add_fill_provider``.
``tests/test_torch_native.py`` holds the ring and the farm to the JAX
package's and to the port's ``AnalysisBuffer``;
``tests/test_torch_codecs.py`` holds the codecs to JAX's.
"""

from __future__ import annotations

import ctypes
import fcntl
import logging
import os
import subprocess
import threading
from collections.abc import Callable, Sequence
from pathlib import Path

import numpy as np

log = logging.getLogger("birdnet_tpu.native")

_REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = _REPO_ROOT / "build" / "torch_native"
_LIB_PATH = BUILD_DIR / "libbirdnet_host.so"
_SRC_DIR = _REPO_ROOT / "native"
# the library's sources: the rings, the stream farm and the RTSP plane
# (see build_native)
_SOURCES = ("birdnet_host.cpp", "stream_farm.cpp", "rtsp_plane.cpp")

_CODECS_SRC = Path(__file__).resolve().parents[1] / "csrc" / "codecs.cpp"
_CODECS_PATH = BUILD_DIR / "libbirdnet_codecs.so"

_lib = None
_lib_lock = threading.Lock()
_codecs = None


def build_native() -> Path:
    """Run make on native/ into BUILD_DIR; returns the library's path.
    Raises RuntimeError when make or the compiler fails.

    Two settings go to make on its command line; the Makefile and the
    sources stay as they are:
    - ``SRCS``: every source but ``codecs.cpp``, which needs FFmpeg's
      headers to compile, which a machine with only a compiler lacks; the
      port's codecs are its own library (``build_codecs``).
    - ``CXX``: the compiler (``$CXX``, else g++) with ``-include
      system_error``. The sources catch ``std::system_error`` without
      including its header, and newer libstdc++ headers (GCC 13 and later)
      no longer bring it in through ``<thread>`` and ``<mutex>``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = f"{os.environ.get('CXX') or 'g++'} -include system_error"
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            res = subprocess.run(["make", "-C", str(_SRC_DIR),
                                  f"BUILD_DIR={BUILD_DIR}", f"CXX={cxx}",
                                  f"SRCS={' '.join(_SOURCES)}"],
                                 capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"native build could not run: {e}") from e
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    if res.returncode != 0 or not _LIB_PATH.is_file():
        raise RuntimeError(f"native build failed ({res.returncode}):\n"
                           f"{res.stdout[-2000:]}{res.stderr[-2000:]}")
    return _LIB_PATH


def build_codecs() -> Path:
    """Compile ``csrc/codecs.cpp`` into BUILD_DIR's codec library with
    ``$CXX`` (else g++) and ``-ldl``, when the library is missing or older
    than its source; returns its path. It includes no codec header, so it
    builds wherever a C++17 compiler does. Raises RuntimeError when the
    compiler fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = (os.environ.get("CXX") or "g++").split()
    with open(BUILD_DIR / "codecs.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if _CODECS_PATH.is_file() and (_CODECS_PATH.stat().st_mtime
                                           >= _CODECS_SRC.stat().st_mtime):
                return _CODECS_PATH
            tmp = _CODECS_PATH.with_name(f"{_CODECS_PATH.name}.{os.getpid()}")
            try:
                res = subprocess.run(
                    cxx + ["-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra",
                           "-fvisibility=hidden", "-pthread", "-shared",
                           str(_CODECS_SRC), "-o", str(tmp), "-ldl",
                           "-pthread"],
                    capture_output=True, text=True, timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise RuntimeError(f"codec build could not run: {e}") from e
            if res.returncode != 0 or not tmp.is_file():
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"codec build failed ({res.returncode}):"
                                   f"\n{res.stdout[-2000:]}"
                                   f"{res.stderr[-2000:]}")
            tmp.replace(_CODECS_PATH)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return _CODECS_PATH


def _load_codecs():
    """The codec library, built on first use (``build_codecs``) and bound;
    raises if it cannot be built or loaded. Whether libopus, libmp3lame
    and libavcodec are there is asked of it (``bn_*_available``)."""
    global _codecs
    with _lib_lock:
        if _codecs is not None:
            return _codecs
        lib = ctypes.CDLL(str(build_codecs()))
        i16p, c_int, i64, i32p = (ctypes.POINTER(ctypes.c_int16),
                                  ctypes.c_int, ctypes.c_int64,
                                  ctypes.POINTER(ctypes.c_int32))
        lib.bn_opus_available.restype = c_int
        lib.bn_opus_encode.restype = i64
        lib.bn_opus_encode.argtypes = [i16p, i64, c_int, c_int, c_int,
                                       ctypes.c_char_p, i64, i32p, i32p]
        lib.bn_opus_decode.restype = i64
        lib.bn_opus_decode.argtypes = [ctypes.c_char_p, i64, c_int, c_int,
                                       i16p, i64]
        lib.bn_opus_stream_create.restype = ctypes.c_void_p
        lib.bn_opus_stream_create.argtypes = [c_int, c_int, c_int, i32p]
        lib.bn_opus_stream_encode.restype = i64
        lib.bn_opus_stream_encode.argtypes = [
            ctypes.c_void_p, i16p, i64, ctypes.c_char_p, i64, i32p]
        lib.bn_opus_stream_destroy.argtypes = [ctypes.c_void_p]
        lib.bn_mp3_available.restype = c_int
        lib.bn_mp3_encode.restype = i64
        lib.bn_mp3_encode.argtypes = [i16p, i64, c_int, c_int, c_int,
                                      ctypes.c_char_p, i64]
        lib.bn_avcodec_version.restype = ctypes.c_uint
        lib.bn_aac_available.restype = c_int
        lib.bn_aac_stream_create.restype = ctypes.c_void_p
        lib.bn_aac_stream_create.argtypes = [
            c_int, c_int, c_int, ctypes.c_char_p, ctypes.c_int32, i32p]
        lib.bn_aac_stream_encode.restype = i64
        lib.bn_aac_stream_encode.argtypes = [
            ctypes.c_void_p, i16p, i64, ctypes.c_char_p, i64, i32p]
        lib.bn_aac_stream_flush.restype = i64
        lib.bn_aac_stream_flush.argtypes = [ctypes.c_void_p,
                                            ctypes.c_char_p, i64, i32p]
        lib.bn_aac_stream_destroy.argtypes = [ctypes.c_void_p]
        lib.bn_aac_stream_delay.restype = ctypes.c_int32
        lib.bn_aac_stream_delay.argtypes = [ctypes.c_void_p]
        lib.bn_aac_decode.restype = i64
        lib.bn_aac_decode.argtypes = [
            ctypes.c_char_p, i64, ctypes.c_char_p, ctypes.c_int32, c_int,
            c_int, i16p, i64]
        lib.bn_aac_decoder_create.restype = ctypes.c_void_p
        lib.bn_aac_decoder_create.argtypes = [ctypes.c_char_p,
                                              ctypes.c_int32, c_int, c_int]
        lib.bn_aac_decoder_decode.restype = i64
        lib.bn_aac_decoder_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, i64, i16p, i64]
        lib.bn_aac_decoder_destroy.argtypes = [ctypes.c_void_p]
        _codecs = lib
        return _codecs


def avcodec_version() -> int:
    """``avcodec_version()`` of the libavcodec the codec library found
    (major << 16 | minor << 8 | micro), or 0 without one."""
    return int(_load_codecs().bn_avcodec_version())


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_native()))
        lib.bn_ring_create.restype = ctypes.c_void_p
        lib.bn_ring_create.argtypes = [ctypes.c_int64] * 3
        lib.bn_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.bn_ring_write.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int16),
                                      ctypes.c_int64]
        lib.bn_ring_read.restype = ctypes.c_int64
        lib.bn_ring_read.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int16)]
        lib.bn_ring_read_batch.restype = ctypes.c_int64
        lib.bn_ring_read_batch.argtypes = [ctypes.c_void_p,
                                           ctypes.POINTER(ctypes.c_int16),
                                           ctypes.c_int64]
        lib.bn_ring_available.restype = ctypes.c_int64
        lib.bn_ring_available.argtypes = [ctypes.c_void_p]
        lib.bn_ring_lost.restype = ctypes.c_int64
        lib.bn_ring_lost.argtypes = [ctypes.c_void_p]
        lib.bn_set_malloc_arena_max.restype = ctypes.c_int
        lib.bn_set_malloc_arena_max.argtypes = [ctypes.c_int]
        lib.bn_alsa_available.restype = ctypes.c_int
        lib.bn_alsa_open.restype = ctypes.c_void_p
        lib.bn_alsa_open.argtypes = [ctypes.c_char_p, ctypes.c_uint,
                                     ctypes.c_uint, ctypes.c_uint]
        lib.bn_alsa_read.restype = ctypes.c_long
        lib.bn_alsa_read.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int16),
                                     ctypes.c_ulong]
        lib.bn_alsa_close.argtypes = [ctypes.c_void_p]
        if hasattr(lib, "bn_alsa_list_devices"):
            lib.bn_alsa_list_devices.restype = ctypes.c_long
            lib.bn_alsa_list_devices.argtypes = [ctypes.c_char_p,
                                                 ctypes.c_long]
        # stream farm (stream_farm.cpp: native high-stream-count ingest)
        if hasattr(lib, "bn_farm_create"):
            lib.bn_farm_create.restype = ctypes.c_void_p
            lib.bn_farm_create.argtypes = [
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_double, ctypes.c_int64,
                ctypes.c_uint64, ctypes.c_double, ctypes.c_int64]
            lib.bn_farm_set_waveform.restype = ctypes.c_int
            lib.bn_farm_set_waveform.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int16), ctypes.c_int64]
            lib.bn_farm_start.restype = ctypes.c_int
            lib.bn_farm_start.argtypes = [ctypes.c_void_p]
            lib.bn_farm_stop.argtypes = [ctypes.c_void_p]
            lib.bn_farm_destroy.argtypes = [ctypes.c_void_p]
            lib.bn_farm_collect.restype = ctypes.c_int64
            lib.bn_farm_collect.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
            lib.bn_farm_stats.argtypes = [ctypes.c_void_p,
                                          ctypes.POINTER(ctypes.c_int64)]
            if hasattr(lib, "bn_farm_grow"):
                lib.bn_farm_grow.restype = ctypes.c_int64
                lib.bn_farm_grow.argtypes = [ctypes.c_void_p,
                                             ctypes.c_double]
        if hasattr(lib, "bn_rtspd_create"):
            lib.bn_rtspd_create.restype = ctypes.c_void_p
            lib.bn_rtspd_create.argtypes = [
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_double]
            lib.bn_rtspd_add.restype = ctypes.c_int
            lib.bn_rtspd_add.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
                ctypes.c_int64, ctypes.c_char_p]
            lib.bn_rtspd_start.restype = ctypes.c_int
            lib.bn_rtspd_start.argtypes = [ctypes.c_void_p]
            lib.bn_rtspd_stop.argtypes = [ctypes.c_void_p]
            lib.bn_rtspd_destroy.argtypes = [ctypes.c_void_p]
            lib.bn_rtspd_collect.restype = ctypes.c_int64
            lib.bn_rtspd_collect.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
            lib.bn_rtspd_stats.argtypes = [ctypes.c_void_p,
                                           ctypes.POINTER(ctypes.c_int64)]
            lib.bn_rtsps_create.restype = ctypes.c_void_p
            lib.bn_rtsps_create.argtypes = [
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_uint64, ctypes.c_int64]
            lib.bn_rtsps_port.restype = ctypes.c_int64
            lib.bn_rtsps_port.argtypes = [ctypes.c_void_p]
            lib.bn_rtsps_start.restype = ctypes.c_int
            lib.bn_rtsps_start.argtypes = [ctypes.c_void_p]
            lib.bn_rtsps_stop.argtypes = [ctypes.c_void_p]
            lib.bn_rtsps_destroy.argtypes = [ctypes.c_void_p]
            lib.bn_rtsps_stats.argtypes = [ctypes.c_void_p,
                                           ctypes.POINTER(ctypes.c_int64)]
        lib.bn_version.restype = ctypes.c_char_p
        _lib = lib
        log.info("native host library loaded: %s",
                 lib.bn_version().decode())
        return _lib


def available() -> bool:
    """True once the library is built and loaded; raises if it cannot
    be."""
    return _load() is not None


def alsa_available() -> bool:
    return bool(_load().bn_alsa_available())


def alsa_list_devices() -> list[dict]:
    """Capture-capable PCM devices via snd_device_name_hint
    (DeviceManager enumeration role, device.go:95). [] without ALSA."""
    lib = _load()
    if not hasattr(lib, "bn_alsa_list_devices") \
            or not lib.bn_alsa_available():
        return []
    buf = ctypes.create_string_buffer(65536)
    n = lib.bn_alsa_list_devices(buf, len(buf))
    if n <= 0:
        return []
    out = []
    for line in buf.raw[:n].decode(errors="replace").splitlines():
        name, _, desc = line.partition("\t")
        if name:
            out.append({"name": name,
                        "description": desc.replace("\n", " — ")})
    return out


def set_malloc_arena_max(arenas: int = 2) -> bool:
    """Low-memory policy (reference: mempolicy glibc arena cap)."""
    return _load().bn_set_malloc_arena_max(arenas) == 1


def _i16_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


class NativeAnalysisBuffer:
    """Drop-in for audio.buffers.AnalysisBuffer backed by C++."""

    def __init__(self, overlap_samples: int, read_samples: int,
                 capacity_samples: int | None = None):
        lib = _load()
        self._lib = lib
        self.overlap = overlap_samples
        self.read_size = read_samples
        self.window_size = overlap_samples + read_samples
        self._h = lib.bn_ring_create(overlap_samples, read_samples,
                                     capacity_samples or 0)
        if not self._h:
            raise RuntimeError("bn_ring_create failed")

    def write(self, samples: np.ndarray, now: float | None = None) -> None:
        samples = np.ascontiguousarray(samples, np.int16)
        self._lib.bn_ring_write(self._h, _i16_ptr(samples), len(samples))

    def read(self) -> np.ndarray | None:
        # a window needs read_size unread samples (bn_ring_read): ask first,
        # so that a poll with none ready allocates no window
        if self.available() < self.read_size:
            return None
        out = np.empty(self.window_size, np.int16)
        n = self._lib.bn_ring_read(self._h, _i16_ptr(out))
        return out if n else None

    def read_batch(self, max_windows: int) -> np.ndarray:
        """Drain up to max_windows windows → [n, window_size] int16."""
        out = np.empty((max_windows, self.window_size), np.int16)
        n = self._lib.bn_ring_read_batch(self._h, _i16_ptr(out), max_windows)
        return out[:n]

    def available(self) -> int:
        return int(self._lib.bn_ring_available(self._h))

    @property
    def total_overwritten(self) -> int:
        return int(self._lib.bn_ring_lost(self._h))

    def overwrite_rate(self, window_seconds: float = 300.0,
                       now: float | None = None) -> float:
        # coarse: lifetime ratio (the Python impl keeps a sliding window)
        avail = self.available()
        lost = self.total_overwritten
        total = max(avail + lost, 1)
        return lost / total

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.bn_ring_destroy(self._h)
        except Exception:
            pass


class StreamFarm:
    """Native high-stream-count ingest plane (stream_farm.cpp): per-stream
    synthesis + rings + window packing run in C++ with no GIL; Python does
    ONE collect() FFI call per scheduler tick and hands the packed block
    straight to ModelBatcher.offer_block. This is the ≥2,000-stream soak's
    ingest (VERDICT r2 #1: ring writes + packing off the Python plane)."""

    def __init__(self, n_streams: int, sample_rate: int = 48000,
                 window_samples: int = 144000, hop_samples: int = 72000,
                 ring_seconds: float = 12.0, n_waveforms: int = 16,
                 seed: int = 1, timescale: float = 1.0,
                 stagger_hops: int = 1):
        lib = _load()
        if not hasattr(lib, "bn_farm_create"):
            raise RuntimeError("native stream farm unavailable")
        self._lib = lib
        self.n_streams = n_streams
        self.sample_rate = sample_rate
        self.window_samples = window_samples
        self.hop_samples = hop_samples
        self.timescale = timescale
        self._h = lib.bn_farm_create(n_streams, sample_rate, window_samples,
                                     hop_samples, ring_seconds, n_waveforms,
                                     seed, timescale, stagger_hops)
        if not self._h:
            raise RuntimeError("bn_farm_create failed")

    def set_waveform(self, idx: int, pcm: np.ndarray) -> bool:
        pcm = np.ascontiguousarray(pcm, np.int16)
        return bool(self._lib.bn_farm_set_waveform(
            self._h, idx, _i16_ptr(pcm), len(pcm)))

    def start(self) -> None:
        if not self._lib.bn_farm_start(self._h):
            raise RuntimeError("bn_farm_start failed")

    def stop(self) -> None:
        if self._h:
            self._lib.bn_farm_stop(self._h)

    def collect(self, out: np.ndarray, meta: np.ndarray) -> int:
        """Drain ready windows into caller-owned out[n, window] int16 and
        meta[n, 3] int64 (stream_id, window_index, ready_ns-since-start);
        returns count. Raises ValueError for buffers the C side cannot
        write (wrong dtype, width or layout, or meta shorter than out)."""
        if (out.dtype != np.int16 or out.ndim != 2
                or out.shape[1] != self.window_samples
                or not out.flags.c_contiguous):
            raise ValueError(f"collect: out must be C-contiguous int16 "
                             f"[n, {self.window_samples}], got {out.dtype} "
                             f"{out.shape}")
        if (meta.dtype != np.int64 or meta.shape[1:] != (3,)
                or len(meta) < len(out) or not meta.flags.c_contiguous):
            raise ValueError(f"collect: meta must be C-contiguous int64 "
                             f"[>= {len(out)}, 3], got {meta.dtype} "
                             f"{meta.shape}")
        return int(self._lib.bn_farm_collect(
            self._h, _i16_ptr(out),
            meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(out)))

    def stats(self) -> dict:
        buf = (ctypes.c_int64 * 8)()
        self._lib.bn_farm_stats(self._h, buf)
        return {"samples_generated": buf[0], "windows_emitted": buf[1],
                "samples_lost": buf[2], "ready_windows": buf[3],
                "n_streams": buf[4], "ring_capacity": buf[5],
                # max unread samples ever observed on any stream — the
                # slack a host stall actually consumed; adaptive ring
                # sizing keys on this (VERDICT r3 #7)
                "backlog_high_water": buf[6],
                # current generator lag behind realtime (max over
                # streams): the capture-side stall signal — lets slack
                # grow MID-stall, before the catch-up flood arrives
                "generator_deficit": buf[7]}

    def grow(self, new_ring_seconds: float) -> int:
        """Grow every stream's ring to new_ring_seconds of slack in
        place, preserving unread audio (stop-the-world; one memcpy
        pass). Returns the new capacity in samples (0 on failure;
        unchanged capacity when not larger)."""
        if not hasattr(self._lib, "bn_farm_grow"):
            return 0
        return int(self._lib.bn_farm_grow(
            self._h, ctypes.c_double(new_ring_seconds)))

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.bn_farm_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def fill_provider(farm: StreamFarm, names: Sequence[str] | None = None,
                  epoch: float = 0.0) -> Callable:
    """A window source for ``DeviceLoop.add_fill_provider`` over `farm`,
    the shape of the JAX soak's ``fill``: fill(view) packs up to len(view)
    ready windows straight into the batcher's staging rows and returns (n,
    source_ids, start_times). Stream s is named ``names[s]`` (default
    ``farm:<s>``); a window starts at `epoch` plus its stream time,
    (ready time × timescale) − window length, in seconds."""
    names = list(names) if names is not None else [
        f"farm:{s}" for s in range(farm.n_streams)]
    if len(names) != farm.n_streams:
        raise ValueError(f"{len(names)} names for {farm.n_streams} streams")
    window_s = farm.window_samples / farm.sample_rate
    meta = np.empty((0, 3), np.int64)

    def fill(view: np.ndarray):
        nonlocal meta
        if len(meta) < len(view):
            meta = np.empty((len(view), 3), np.int64)
        n = farm.collect(view, meta)
        if n == 0:
            return 0, (), ()
        sids = [names[s] for s in meta[:n, 0].tolist()]
        sts = epoch + meta[:n, 2] * (farm.timescale / 1e9) - window_s
        return n, sids, sts

    return fill


class RtspDemux:
    """Consolidated native RTSP ingest (rtsp_plane.cpp): ONE epoll thread
    owns every session's handshake, RTP demux, payload decode, and
    analysis-ring write — the 2,000-stream answer to the reference's
    FFmpeg-subprocess-per-stream model (stream.go:471-1534, SURVEY §7
    "consolidated demux strategy"). collect() is a StreamFarm.collect
    drop-in, so the DeviceLoop fill path is shared with the soak farm."""

    def __init__(self, n_streams: int, sample_rate: int = 48000,
                 window_samples: int = 144000, hop_samples: int = 72000,
                 ring_seconds: float = 12.0):
        lib = _load()
        if not hasattr(lib, "bn_rtspd_create"):
            raise RuntimeError("native rtsp demux unavailable")
        self._lib = lib
        self.n_streams = n_streams
        self.sample_rate = sample_rate
        self.window_samples = window_samples
        self.hop_samples = hop_samples
        self._h = lib.bn_rtspd_create(n_streams, sample_rate,
                                      window_samples, hop_samples,
                                      ring_seconds)
        if not self._h:
            raise RuntimeError("bn_rtspd_create failed")

    def add(self, idx: int, host: str, port: int, path: str = "/") -> None:
        if not self._lib.bn_rtspd_add(self._h, idx, host.encode(), port,
                                      path.encode()):
            raise ValueError(f"bn_rtspd_add({idx}) failed")

    def start(self) -> None:
        if not self._lib.bn_rtspd_start(self._h):
            raise RuntimeError("bn_rtspd_start failed")

    def stop(self) -> None:
        if self._h:
            self._lib.bn_rtspd_stop(self._h)

    def collect(self, out: np.ndarray, meta: np.ndarray) -> int:
        """Drain ready windows into out[n, window] int16 + meta[n, 3]
        int64 (stream_id, window_index, ready_ns-since-demux-start)."""
        return int(self._lib.bn_rtspd_collect(
            self._h, _i16_ptr(out),
            meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(out)))

    def stats(self) -> dict:
        buf = (ctypes.c_int64 * 12)()
        self._lib.bn_rtspd_stats(self._h, buf)
        return {"samples_received": buf[0], "windows_emitted": buf[1],
                "samples_lost": buf[2], "ready_windows": buf[3],
                "connected": buf[4], "restarts": buf[5],
                "bytes_received": buf[6], "packets": buf[7],
                "backlog_high_water": buf[8],
                # the demux thread's own CLOCK_THREAD_CPUTIME_ID — divide
                # by streams x wall time for measured ingest CPU/stream
                "demux_cpu_ns": buf[9],
                "n_streams": buf[10], "ring_capacity": buf[11]}

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.bn_rtspd_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class RtspLoadServer:
    """Single-threaded epoll RTSP/L16 load server (test rig) — paces N
    realtime sessions from a pre-byteswapped waveform bank so the demux
    can be proven at 500+ streams over real TCP on one core. Drops whole
    packets with accounting when a client stalls (bounded-queue
    contract)."""

    def __init__(self, port: int = 0, rate: int = 48000,
                 n_waveforms: int = 8, seed: int = 1, pkt_ms: int = 50):
        lib = _load()
        if not hasattr(lib, "bn_rtsps_create"):
            raise RuntimeError("native rtsp load server unavailable")
        self._lib = lib
        self._h = lib.bn_rtsps_create(port, rate, n_waveforms, seed,
                                      pkt_ms)
        if not self._h:
            raise RuntimeError("bn_rtsps_create failed (port in use?)")
        self.port = int(lib.bn_rtsps_port(self._h))

    def start(self) -> None:
        if not self._lib.bn_rtsps_start(self._h):
            raise RuntimeError("bn_rtsps_start failed")

    def stop(self) -> None:
        if self._h:
            self._lib.bn_rtsps_stop(self._h)

    def stats(self) -> dict:
        buf = (ctypes.c_int64 * 6)()
        self._lib.bn_rtsps_stats(self._h, buf)
        return {"accepted": buf[0], "playing": buf[1],
                "samples_sent": buf[2], "samples_dropped": buf[3],
                "server_cpu_ns": buf[4], "port": buf[5]}

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.bn_rtsps_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class AlsaCapture:
    """Soundcard capture via the native ALSA shim (device enumeration and
    format conversion happen ALSA-side through snd_pcm_set_params)."""

    def __init__(self, device: str = "default", rate: int = 48000,
                 channels: int = 1, latency_us: int = 100000):
        lib = _load()
        if not lib.bn_alsa_available():
            raise RuntimeError("ALSA unavailable")
        self._lib = lib
        self.rate = rate
        self.channels = channels
        self._pcm = lib.bn_alsa_open(device.encode(), rate, channels,
                                     latency_us)
        if not self._pcm:
            raise RuntimeError(f"cannot open ALSA device {device!r}")

    def read(self, frames: int) -> np.ndarray | None:
        buf = np.empty(frames * self.channels, np.int16)
        n = self._lib.bn_alsa_read(self._pcm, _i16_ptr(buf), frames)
        if n < 0:
            raise RuntimeError("ALSA read failed")
        if n == 0:
            return None
        out = buf[:int(n) * self.channels]
        if self.channels > 1:
            out = out.reshape(-1, self.channels).mean(axis=1).astype(np.int16)
        return out

    def close(self) -> None:
        if self._pcm:
            self._lib.bn_alsa_close(self._pcm)
            self._pcm = None
