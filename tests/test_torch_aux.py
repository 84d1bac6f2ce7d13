"""The port's clip and aux planes against the JAX package's, on the CPU.

Each case runs once through the JAX package's modules and once through the
port's copies (``audio/buffers.py`` ``CaptureBuffer``, ``resampler.py``,
``audionorm.py``, ``flac.py``, ``encode.py``, ``hlsmux.py``,
``analysis/actions.py`` ``SaveAudioAction``, ``datastore/migration.py`` with
``utils/imports.py``, ``analysis/spectrogram.py``,
``analysis/soundlevel_worker.py``) from the same inputs, and records what it
observes; ``_both`` asserts the two records equal. Tolerances:

- bit for bit: the capture buffer, loudness normalisation, the FLAC
  codec, encoded WAV and FLAC bytes, exported clips, HLS init and media
  segments, playlists, and the migration's tables (timestamps of the wall
  clock stripped), all host numpy or SQL;
- the streaming resampler: each chunk within 1e-6 of the largest sample
  of JAX's (the port sums its polyphase taps only), and no further from
  the resampler's float64 definition than JAX's chunk plus one float32
  epsilon of the largest input;
- the spectrogram's colour index (the port's torch on the CPU against
  JAX's): at most 1 level apart, at no more than 1e-3 of the pixels (the
  two FFTs and resamplers round differently before a uint8 truncation).
  The port's colour map and BILINEAR resize applied to JAX's index equal
  JAX's PIL image bit for bit, and the port's PNG decoded by Pillow equals
  the port's array; the two PNGs differ only where the index does, by at
  most 3 levels a channel (one step of the colour map, spread by the
  resize), at no more than 1e-3 of the pixels;
- sound levels: the raw band levels within 0.05 dB; the published levels
  are rounded to 0.1 dB, so within one rounding step.

Opus, MP3 and AAC run through each package's codec library (the port's
``csrc/codecs.cpp``); the cases of the paths without them run with every
codec reported missing in both (``no_native_codecs``), ``.m4a`` decoding
and AAC HLS through both where both libraries have AAC, and refused alike
where neither has. The port's own divergence has a test of its own:
``device="cuda"`` refused without a card.
"""

import dataclasses
import datetime
import importlib
import io
import sqlite3
import struct
import time
import zlib
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_catalog_imports_train import _make_legacy_db

PACKAGES = ("birdnet_go_tpu", "birdnet_go_tpu_torch")


def _pkg(name: str) -> SimpleNamespace:
    mod = {k: importlib.import_module(f"{name}.{path}") for k, path in (
        ("buffers", "audio.buffers"),
        ("resampler", "audio.resampler"),
        ("resample_op", "ops.resample"),
        ("audionorm", "audio.audionorm"),
        ("flac", "audio.flac"),
        ("encode", "audio.encode"),
        ("hlsmux", "audio.hlsmux"),
        ("aacenc", "audio.aacenc"),
        ("wav", "audio.wav"),
        ("actions", "analysis.actions"),
        ("results", "analysis.results"),
        ("spectrogram", "analysis.spectrogram"),
        ("soundlevel_worker", "analysis.soundlevel_worker"),
        ("soundlevel", "ops.soundlevel"),
        ("labels", "taxonomy.labels"),
        ("sqlite", "datastore.sqlite"),
        ("migration", "datastore.migration"),
        ("imports", "utils.imports"))}
    return SimpleNamespace(name=name, **mod)


J, T = _pkg(PACKAGES[0]), _pkg(PACKAGES[1])


def _plain(x):
    """A comparable value: dataclasses by class name and fields, dicts
    with sorted items, arrays as lists, paths by name."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: _plain(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return sorted((repr(_plain(k)), _plain(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return [str(x.dtype), x.tolist()]
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, Path):
        return ("path", x.name)
    return x


def _dir(base: Path, P) -> Path:
    """A directory of `base` for package `P`'s files."""
    d = base / P.name
    d.mkdir(parents=True, exist_ok=True)
    return d


def _both(case, *args):
    """`case` through both packages: the two records, asserted equal."""
    want, got = case(J, *args), case(T, *args)
    assert _plain(got) == _plain(want)
    return got


@pytest.fixture
def no_native_codecs(monkeypatch):
    """Both packages on a host without libopus, libmp3lame and libavcodec
    (``_without_codecs``)."""
    _without_codecs(monkeypatch)


def _without_codecs(monkeypatch) -> None:
    """Each package's codec library reports every codec missing
    (``_WithoutCodecs``)."""
    from birdnet_go_tpu.native import lib as jn
    from birdnet_go_tpu_torch.native import lib as tn

    jlib, tlib = jn._load(), tn._load_codecs()
    if jlib is not None:
        monkeypatch.setattr(jn, "_load", lambda: _WithoutCodecs(jlib))
    monkeypatch.setattr(tn, "_load_codecs", lambda: _WithoutCodecs(tlib))


class _WithoutCodecs:
    """A native library whose codec libraries are missing: every
    ``bn_*_available`` answers 0, the rest is the library's."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        if name in ("bn_opus_available", "bn_mp3_available",
                    "bn_aac_available"):
            return lambda: 0
        return getattr(self._lib, name)


def _pcm(n: int, seed: int, amp: float = 4000.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    return np.clip(amp * np.sin(t / 7.3) + amp / 4 * rng.standard_normal(n),
                   -32768, 32767).astype(np.int16)


# -- CaptureBuffer ------------------------------------------------------------

def _capture_jax_cases(P):
    """The cases of ``tests/test_audio_host.py``'s CaptureBuffer tests."""
    out = []
    cb = P.buffers.CaptureBuffer(sample_rate=100, capacity_seconds=2.0)
    assert cb.window() is None
    cb.write(np.arange(100, dtype=np.int16), timestamp=1000.0)
    cb.write(np.arange(100, 200, dtype=np.int16), timestamp=1001.0)
    out += [cb.read_segment(1000.5, 1001.5), cb.window(),
            cb.duration_available]
    cb = P.buffers.CaptureBuffer(sample_rate=100, capacity_seconds=1.0)
    cb.write(np.ones(100, np.int16) * 7, timestamp=2000.0)
    out.append(cb.read_segment(1999.5, 2000.5))
    cb = P.buffers.CaptureBuffer(sample_rate=100, capacity_seconds=1.0)
    cb.write(np.ones(100, np.int16), timestamp=3000.0)
    cb.write(np.full(100, 2, np.int16), timestamp=3001.0)
    out += [cb.read_segment(3000.0, 3001.0), cb.read_segment(3001.0, 3000.0),
            cb.window()]
    return out


def _capture_seeded(P, seed):
    """Seeded writes that wrap the ring several times, then windows that
    straddle the wrap, the overwritten past and the unwritten future."""
    rng = np.random.default_rng(seed)
    rate = int(rng.choice([8000, 48000, 256000]))
    cb = P.buffers.CaptureBuffer(rate, capacity_seconds=0.37)
    t, out = 5000.0 + seed, []
    for _ in range(12):
        n = int(rng.integers(1, int(0.2 * rate)))
        cb.write(_pcm(n, int(rng.integers(1 << 30))), timestamp=t)
        t += n / rate
        lo, hi = cb.window()
        for a, b in ((lo, hi), (lo - 0.05, lo + 0.05), (hi - 0.03, hi + 0.1),
                     (t - 0.5, t - 0.45), (hi - 0.1, hi - 0.1)):
            out.append(cb.read_segment(a, b))
        out += [(lo, hi), cb.duration_available]
    cb.write(np.zeros(0, np.int16), timestamp=t)
    return out


def test_capture_buffer_jax_cases_equal_jax():
    got = _both(_capture_jax_cases)
    np.testing.assert_array_equal(got[0], np.arange(50, 150))
    assert (got[3][:50] == 0).all() and (got[3][50:] == 7).all()
    assert (got[4] == 0).all() and len(got[5]) == 0


@pytest.mark.parametrize("seed", range(4))
def test_capture_buffer_wrap_and_zero_fill_equal_jax(seed):
    _both(_capture_seeded, seed)


# -- streaming resampler ------------------------------------------------------

def _resample_input(in_rate, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(int(0.8 * in_rate)).astype(np.float32) * 1000
    return x, rng


def _resample_chunks(P, in_rate, out_rate, seed):
    x, rng = _resample_input(in_rate, seed)
    rs = P.resampler.StreamingResampler(in_rate, out_rate)
    out, pos = [], 0
    while pos < len(x):
        n = int(rng.integers(1, in_rate // 10))
        out.append(rs.process(x[pos:pos + n]))
        pos += n
    out.append(rs.flush())
    whole = P.resampler.StreamingResampler(in_rate, out_rate)
    return out, np.concatenate([whole.process(x), whole.flush()])


def _resample_float64(x, in_rate, out_rate, n_out):
    """The streaming resampler's definition in float64, independent of
    both packages' sums: output j is sum_t h[t] · xup[j·M − pad_lo + t]
    over JAX's filter h, xup the input zero-stuffed by L (scipy's
    ``upfirdn`` at the full upsampled rate, read every M samples)."""
    from scipy.signal import upfirdn

    cfg = J.resample_op.ResampleConfig(in_rate, out_rate)
    up, down = cfg.ratio
    if up == down == 1:
        return x.astype(np.float64)[:n_out]
    h = J.resample_op._design_filter(up, down, cfg.taps_per_phase, cfg.beta,
                                     cfg.cutoff_scale).astype(np.float64)
    n_taps = len(h)
    y = upfirdn(h[::-1], x.astype(np.float64), up=up, down=1)
    at = np.arange(n_out) * down - (n_taps - 1) // 2 + n_taps - 1
    return np.concatenate([y, np.zeros(max(0, at[-1] + 1 - len(y)))])[at]


@pytest.mark.parametrize("rates", [(44100, 48000), (256000, 48000),
                                   (48000, 24000), (48000, 48000)])
@pytest.mark.parametrize("seed", [0, 1])
def test_streaming_resampler_equal_jax(rates, seed):
    """The contract of the resampler's accepted divergence
    (``audio/resampler.py``). Chunked ``process`` then ``flush``: every
    chunk as long as JAX's and equal to it to float32 rounding, as their
    concatenation is to the whole-stream resample's (1e-6 of the largest
    sample, the bound JAX's own chunks keep against its whole stream).
    The port sums only the taps that meet input samples (the filter's
    polyphase form), where JAX's product runs over the zero-stuffed
    signal, so the float32 sums round differently. So each chunk is also
    held to the resampler's definition in float64
    (``_resample_float64``): no further from it than JAX's chunk is, plus
    one float32 epsilon of the largest input sample, where a wrong tap,
    phase or offset would miss it by the signal's size. JAX's chunks are
    within two such epsilons of it, which holds the reference itself."""
    (want, want_whole), (got, whole) = (_resample_chunks(P, *rates, seed)
                                        for P in (J, T))
    atol = 1e-6 * np.abs(whole).max()
    assert [len(c) for c in got] == [len(c) for c in want]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)
    np.testing.assert_allclose(whole, want_whole, rtol=0, atol=atol)
    np.testing.assert_allclose(np.concatenate(got), whole, rtol=0,
                               atol=atol)
    assert len(whole) == int(0.8 * rates[0]) * rates[1] // rates[0]

    x, _ = _resample_input(rates[0], seed)
    exact = _resample_float64(x, *rates, len(whole))
    eps = float(np.finfo(np.float32).eps) * float(np.abs(x).max())
    pos = 0
    for g, w in zip(got, want):
        ref = exact[pos:pos + len(w)]
        pos += len(w)
        if not len(w):
            continue
        jax_err = float(np.abs(w - ref).max())
        assert jax_err <= 2 * eps, (jax_err, eps)
        assert float(np.abs(g - ref).max()) <= jax_err + eps, (jax_err, eps)
    assert pos == len(exact)
    assert float(np.abs(whole - exact).max()) <= 2 * eps


# -- loudness -----------------------------------------------------------------

def _loudness(P, rate, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(1.7 * rate)) / rate
    x = (0.2 * np.sin(2 * np.pi * 997 * t) * (1 + 0.5 * np.sin(t))
         + 0.05 * rng.standard_normal(len(t))).astype(np.float32)
    quiet = (x * 1e-4).astype(np.float32)
    opts = P.audionorm.NormalizeOptions(target_lufs=-18.0,
                                        max_true_peak_db=-2.0)
    pcm = np.round(x * 20000).astype(np.int16)
    return [P.audionorm.measure_lufs(x, rate),
            P.audionorm.measure_lufs(quiet, rate),
            P.audionorm.measure_lufs(x[:rate // 10], rate),
            P.audionorm.true_peak_db(x, rate),
            P.audionorm.plan_gain(x, rate), P.audionorm.plan_gain(x, rate,
                                                                   opts),
            P.audionorm.normalize(x, rate, opts),
            P.audionorm.normalize_int16(pcm, rate)]


@pytest.mark.parametrize("rate,seed", [(48000, 0), (44100, 1), (16000, 2),
                                       (256000, 3)])
def test_audionorm_equal_jax(rate, seed):
    _both(_loudness, rate, seed)


# -- FLAC ---------------------------------------------------------------------

def _flac(P, tmp_path, rate, n, seed):
    pcm = _pcm(n, seed)
    pcm[: n // 5] = 3                         # a CONSTANT subframe
    data = P.flac.encode_flac(pcm, rate)
    frames = P.flac.encode_flac_frames(pcm, rate, first_frame_number=7)
    path = P.flac.write_flac(tmp_path / f"{P.name}.flac", pcm, rate)
    decoded, got_rate = P.flac.decode_flac(data)
    np.testing.assert_array_equal(decoded, pcm)
    return [data, frames, path.read_bytes(), decoded, got_rate,
            P.flac.streaminfo_block(rate, n)]


@pytest.mark.parametrize("rate,n,seed", [(48000, 9000, 0), (16000, 4096, 1),
                                         (256000, 20001, 2), (44100, 17, 3)])
def test_flac_codec_equal_jax(tmp_path, rate, n, seed):
    _both(lambda P: _flac(P, tmp_path, rate, n, seed))


# -- clip encoding ------------------------------------------------------------

def _encode_native(P, d):
    """``tests/test_hls_encode.py``'s native cases, as bytes."""
    pcm = (np.arange(8000) % 512 - 256).astype(np.int16)
    wav = P.encode.encode_clip(pcm, 16000, d / "a.wav")
    x, info = P.wav.read_wav(wav)
    flac = P.encode.encode_clip(pcm, 16000, d / "a.flac")
    loaded = [P.encode.load_clip_audio(p) for p in (wav, flac)]
    return [wav, wav.read_bytes(), flac, flac.read_bytes(), x,
            info.sample_rate, loaded]


def _encode_lossy(P, d, monkeypatch, ffmpeg):
    """Lossy formats without native codecs: FLAC fallbacks without ffmpeg,
    the ffmpeg command with it (its runner faked)."""
    calls = []

    def fake_run(cmd, input=None, capture_output=True, timeout=0):
        calls.append((cmd[:-1], len(input)))
        Path(cmd[-1]).write_bytes(b"fake-" + cmd[-1][-4:].encode())
        return SimpleNamespace(returncode=0, stderr=b"")

    monkeypatch.setattr(P.encode, "_which",
                        lambda name: "/usr/bin/ffmpeg" if ffmpeg else None)
    monkeypatch.setattr(P.encode, "_run", fake_run)
    pcm = np.ones(4800, np.int16)
    out = []
    for name, rate, fmt in (("c.m4a", 48000, "aac"), ("c.opus", 48000, None),
                            ("d.opus", 256000, None), ("c.mp3", 44100, None),
                            ("e.ogg", 16000, None), ("bat.m4a", 256000,
                                                     "aac")):
        p = P.encode.encode_clip(pcm, rate, d / name, fmt=fmt)
        out.append((p, p.read_bytes()))
    out.append(P.encode.supported_formats())
    out.append([P.encode.resolve_format(f, r)
                for f in ("", "wav", "WAV", "flac", "aac", "opus", "mp3")
                for r in (16000, 44100, 48000, 256000)])
    with pytest.raises(ValueError, match="unsupported clip format"):
        P.encode.resolve_format("ape")
    with pytest.raises(ValueError, match="unsupported clip format"):
        P.encode.encode_clip(pcm, 48000, d / "x.ape")
    return out, calls


def test_encode_clip_native_formats_equal_jax(tmp_path):
    _both(lambda P: _encode_native(P, _dir(tmp_path, P)))


@pytest.mark.parametrize("ffmpeg", [False, True])
def test_encode_clip_lossy_paths_equal_jax(tmp_path, monkeypatch,
                                           no_native_codecs, ffmpeg):
    out, calls = _both(lambda P: _encode_lossy(P, _dir(tmp_path, P),
                                               monkeypatch, ffmpeg))
    suffixes = [p.suffix for p, _ in out[:6]]
    if ffmpeg:
        assert suffixes == [".m4a", ".opus", ".opus", ".mp3", ".ogg",
                            ".flac"]
        assert calls[0][1] == 9600 and "s16le" in calls[0][0]
    else:
        assert suffixes == [".flac"] * 6 and not calls
    assert out[6][:2] == ["wav", "flac"]


def _m4a(P, d):
    """A 1 s tone over noise encoded to .m4a by ``encode_clip`` and
    loaded by ``load_clip_audio``: the file's bytes and the samples."""
    pcm = _pcm(48000, 9)
    out = P.encode.encode_clip(pcm, 48000, d / "c.m4a", fmt="aac")
    return out.name, out.read_bytes(), P.encode.load_clip_audio(out)


def test_load_clip_audio_refuses_m4a_in_the_port(tmp_path, monkeypatch):
    """``load_clip_audio`` decodes an .m4a as JAX's does, where both codec
    libraries have AAC: the same file, the same samples, the clip's
    length once the priming is trimmed. On a host without libavcodec both
    refuse it alike (JAX's behaviour there)."""
    from birdnet_go_tpu.audio import aacenc as jaac
    from birdnet_go_tpu_torch.audio import aacenc as taac

    if jaac.available() and taac.available():
        name, _, (samples, rate) = _both(
            lambda P: _m4a(P, _dir(tmp_path, P)))
        assert name == "c.m4a" and rate == 48000
        assert 48000 <= len(samples) < 48000 + 1024
    src = T.aacenc.write_m4a(tmp_path / "x.m4a", [b"\x21\x00" * 9] * 3,
                             b"\x11\x88", 48000, priming=1024)
    _without_codecs(monkeypatch)
    errors = []
    for P in (J, T):
        with pytest.raises(RuntimeError) as e:
            P.encode.load_clip_audio(src)
        errors.append(str(e.value))
    assert errors[0] == errors[1] == "native AAC decoder unavailable"


# -- SaveAudioAction ----------------------------------------------------------

def _tone(rate, seconds, freq, amp):
    t = np.arange(int(rate * seconds)) / rate
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.int16)


def _save_audio(P, d, t0):
    """``tests/test_aux_chain.py``'s bird clip downsampled from a shared
    256 kHz source and the bat clip at its own rate, then loudness
    normalisation, a static gain, a FLAC clip, a span not yet captured
    (the action raises for the job queue's retry) and the fallback PCM
    where the ring holds nothing of the span."""
    cb = P.buffers.CaptureBuffer(sample_rate=256000, capacity_seconds=4.0)
    cb.write(_tone(256000, 3.0, 2000.0, 10000), timestamp=t0)
    out = []
    for name, kw in (
            ("bird.wav", dict(downsample_to=48000)),
            ("bat.wav", {}),
            ("norm.wav", dict(downsample_to=48000,
                              normalization={"enabled": True,
                                             "target_lufs": -20.0})),
            ("gain.wav", dict(gain_db=-6.0)),
            ("bird.flac", dict(downsample_to=48000))):
        P.actions.SaveAudioAction(
            capture_buffer=cb, start_time=t0 + 0.5, end_time=t0 + 2.5,
            out_path=d / "clips" / name, sample_rate=256000,
            **kw).execute()
        out.append((d / "clips" / name).read_bytes())
    early = P.actions.SaveAudioAction(
        capture_buffer=cb, start_time=t0, end_time=time.time() + 60,
        out_path=d / "early.wav")
    with pytest.raises(RuntimeError, match="not fully captured"):
        early.execute()
    out.append((d / "early.wav").exists())
    empty = P.buffers.CaptureBuffer(sample_rate=48000, capacity_seconds=1.0)
    P.actions.SaveAudioAction(
        capture_buffer=empty, start_time=t0, end_time=t0 + 1.0,
        out_path=d / "fallback.wav", fallback_pcm=_tone(32000, 1.0, 700.0,
                                                        5000),
        fallback_rate=32000, downsample_to=24000).execute()
    out.append((d / "fallback.wav").read_bytes())
    return out


def test_save_audio_action_equal_jax(tmp_path):
    t0 = time.time() - 3.0
    out = _both(lambda P: _save_audio(P, _dir(tmp_path, P), t0))
    samples, info = T.wav.read_wav(io.BytesIO(out[0]))
    assert info.sample_rate == 48000
    assert abs(len(samples) - 2 * 48000) < 4800       # ~2 s at 48 kHz
    assert T.wav.read_wav(io.BytesIO(out[1]))[1].sample_rate == 256000
    assert out[5] is False
    assert T.wav.read_wav(io.BytesIO(out[6]))[1].sample_rate == 24000


# -- HLS ----------------------------------------------------------------------

def _hls_segments(P):
    rng = np.random.default_rng(0)
    pcm = (1000 * np.sin(np.arange(9000) / 9.0)
           + 30 * rng.standard_normal(9000)).astype(np.int16)
    frames = P.flac.encode_flac_frames(pcm, 48000)
    seg = P.hlsmux.media_segment(1, 0, frames, [4096, 4096, 9000 - 8192])
    return [P.hlsmux.init_segment(48000), P.hlsmux.init_segment(256000),
            seg, P.hlsmux.media_segment(5, 123456, frames[:1], [4096])]


def _hls_session(P, t0):
    """The rolling-playlist case of ``tests/test_hls_encode.py``."""
    cb = P.buffers.CaptureBuffer(48000, capacity_seconds=30)
    cb.write((np.arange(48000 * 25) % 997).astype(np.int16), timestamp=t0)
    s = P.hlsmux.HlsSession("s1", cb, segment_seconds=2.0, codec="flac")
    auto = P.hlsmux.HlsSession("s2", cb, segment_seconds=2.0)
    ticks = [s.tick(t0 + 4 + i * 2) for i in range(9)]
    ticks.append(s.tick(t0 + 20.5))
    return [s.init, auto.codec, auto.init, ticks, s.playlist(),
            [s.segment(i) for i in range(11)]]


def test_hls_segments_equal_jax():
    init, init_bat, seg, _ = _both(_hls_segments)
    assert init[4:8] == b"ftyp" and b"fLaC" in init and b"dfLa" in init
    assert b"moof" in seg[:64] and b"mdat" in seg


def test_hls_session_rolling_playlist_equal_jax(no_native_codecs):
    rec = _both(_hls_session, time.time() - 25)
    pl = rec[4]
    assert "seg9.m4s" in pl and "seg1.m4s" not in pl
    assert pl.index("#EXT-X-MEDIA-SEQUENCE:4") > 0
    seg9 = rec[5][9]
    tfdt = seg9.find(b"tfdt")
    assert struct.unpack(">Q", seg9[tfdt + 8:tfdt + 16])[0] == 8 * 2 * 48000


class _FakeEngine:
    def __init__(self, cb):
        self.cb = cb

    def capture_buffer(self, sid):
        return self.cb if sid == "s1" else None


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


def _hls_manager(P):
    """The manager case of ``tests/test_hls_encode.py``, then expiry of a
    session whose last heartbeat is older than the TTL."""
    cb = P.buffers.CaptureBuffer(48000, capacity_seconds=10)
    cb.write(np.ones(48000, np.int16))
    mgr = P.hlsmux.HlsManager(_FakeEngine(cb), segment_seconds=0.2)
    try:
        rec = [mgr.start_session("nope")]
        s = mgr.start_session("s1")
        rec += [s.codec, mgr.get("s1") is s, mgr.heartbeat("s1"),
                _wait(lambda: s.segment(1) is not None),
                mgr.stop_session("s1"), mgr.heartbeat("s1"),
                mgr.get("s1")]
        s = mgr.start_session("s1")
        s.last_heartbeat = time.time() - P.hlsmux.SESSION_TTL_SECONDS - 1
        rec += [_wait(lambda: mgr.get("s1") is None), mgr.heartbeat("s1")]
    finally:
        mgr.stop()
    return rec


def test_hls_manager_sessions_and_expiry_equal_jax(no_native_codecs):
    assert _both(_hls_manager) == [None, "flac", True, True, True, True,
                                   False, None, True, False]


def _hls_aac(P, t0):
    """An AAC session over 12 s of a tone over noise: its init segment and
    its first four segments."""
    cb = P.buffers.CaptureBuffer(48000, capacity_seconds=30)
    cb.write(_pcm(48000 * 12, 10), timestamp=t0)
    s = P.hlsmux.HlsSession("s1", cb, segment_seconds=2.0, codec="aac")
    ticks = [s.tick(t0 + 4 + i * 2) for i in range(4)]
    return [s.codec, s.init, ticks, [s.segment(i) for i in range(1, 5)],
            s.playlist(), P.hlsmux.init_segment(48000, "aac", s._aac.asc)]


def test_hls_refuses_aac_in_the_port(monkeypatch):
    """AAC HLS as JAX's, where both codec libraries have AAC: the same
    init segment (mp4a + esds) and segments, byte for byte. On a host
    without libavcodec both refuse an AAC session alike (JAX's behaviour
    there), and the auto-selected codec is FLAC."""
    from birdnet_go_tpu.audio import aacenc as jaac
    from birdnet_go_tpu_torch.audio import aacenc as taac

    if jaac.available() and taac.available():
        rec = _both(_hls_aac, time.time() - 12)
        assert rec[0] == "aac" and b"mp4a" in rec[1] and all(rec[2])
    _without_codecs(monkeypatch)
    errors = []
    for P in (J, T):
        cb = P.buffers.CaptureBuffer(48000, capacity_seconds=1)
        with pytest.raises(RuntimeError) as e:
            P.hlsmux.HlsSession("s", cb, codec="aac")
        errors.append(str(e.value))
        assert P.hlsmux.HlsSession("s", cb).codec == "flac"
    assert errors[0] == errors[1] == "native AAC encoder unavailable"
    _both(lambda P: P.hlsmux.init_segment(48000, "aac", b"\x11\x88"))


# -- migration ----------------------------------------------------------------

# columns of the wall clock, and the legacy database's path (each
# package's run has a directory of its own)
_PER_RUN = {"created_at", "updated_at", "cached_at", "started_at",
            "completed_at", "legacy_path"}


# where a live row lands between timed migration batches, or a run is
# cancelled after a timed number of rows, the row ids (and the
# sqlite_sequence) are the timing's
TIMED_IDS = frozenset({"id", "detection_id", "det_id", "sqlite_sequence"})
# JAX's delete_detection leaves the day's daily_events stale and the
# port's recomputes it (the divergence tests/test_torch_detection.py
# states), so a rollback's daily_events differ
ROLLED_BACK = TIMED_IDS | {"daily_events"}


def _tables(conn, ignore: frozenset = frozenset()) -> dict:
    """Every table of a SQLite connection, rows ordered by all their
    columns, the ``_PER_RUN`` columns and the tables and columns named in
    `ignore` left out."""
    out = {}
    for (t,) in conn.execute("SELECT name FROM sqlite_master WHERE"
                             " type = 'table' ORDER BY name"):
        if t in ignore:
            continue
        cols = [r[1] for r in conn.execute(f"PRAGMA table_info({t})")
                if r[1] not in _PER_RUN | ignore]
        out[t] = [tuple(r) for r in conn.execute(
            f"SELECT {', '.join(cols)} FROM {t}"
            f" ORDER BY {', '.join(cols)}")]
    return out


def _status(w) -> dict:
    st = w.status()
    return {k: v for k, v in st.items()
            if k not in _PER_RUN | {"records_per_second", "eta_seconds"}}


def _legacy_with_n(path, n):
    """``tests/test_migration.py``'s legacy DB: n generated notes rows
    plus the 2 fixture rows."""
    _make_legacy_db(path)
    conn = sqlite3.connect(path)
    for i in range(n):
        conn.execute(
            "INSERT INTO notes (date, time, scientific_name, common_name,"
            " species_code, confidence, clip_name) VALUES (?,?,?,?,?,?,?)",
            ("2024-05-02", f"{6 + (i // 60) % 12:02d}:{i % 60:02d}:"
             f"{i % 60:02d}", f"Species s{i}", f"Common c{i}", f"sp{i}",
             0.5 + (i % 40) / 100, ""))
    conn.commit()
    conn.close()


def _wait_state(worker, state, timeout=15.0):
    assert _wait(lambda: worker.store.get()["state"] == state, timeout), \
        (state, worker.store.get())


def _wait_migrated(worker, n, timeout=15.0):
    assert _wait(lambda: worker.store.get()["migrated_records"] >= n,
                 timeout)


def _detection(P, sci, common, conf, when, source, code):
    return P.results.Detection(
        species=P.labels.Species(sci, common), confidence=conf,
        begin_seconds=0.0, end_seconds=3.0, model_id="BirdNET_V2.4",
        source_id=source, timestamp=when, species_code=code)


def _finish(P, ds, legacy, rec, *workers, ignore=frozenset()):
    for w in workers:
        w.stop()
    rec.update(native=_tables(ds._conn, ignore),
               status=_status(workers[-1]))
    conn = sqlite3.connect(legacy)
    rec["legacy"] = _tables(conn)
    conn.close()
    return rec


def _mig_full(P, d):
    legacy = d / "legacy.db"
    _legacy_with_n(legacy, 250)
    ds = P.sqlite.Datastore(":memory:")
    w = P.migration.MigrationWorker(ds, legacy, batch_size=64,
                                    sleep_between=0.0)
    w.start()
    _wait_state(w, "completed")
    rows = ds.search_detections(species="Turdus merula")
    rec = {"rows": rows, "reviews": [r["verdict"] for r in
                                     ds.get_reviews(rows[0]["id"])],
           "comments": [c["text"] for c in ds.list_comments(rows[0]["id"])],
           "results": ds.get_results(rows[0]["id"]),
           "hook": w._uninstall_hook is None}
    return _finish(P, ds, legacy, rec, w)


def _mig_restart(P, d):
    legacy = d / "legacy.db"
    _legacy_with_n(legacy, 300)
    db = d / "native.db"
    ds = P.sqlite.Datastore(db)
    w = P.migration.MigrationWorker(ds, legacy, batch_size=32,
                                    sleep_between=0.0)
    w.start()
    _wait_migrated(w, 40)
    w.stop()
    done = w.store.get()["migrated_records"]
    ds2 = P.sqlite.Datastore(db)
    st = P.migration.MigrationStateStore(ds2).get()
    rec = {"persisted": st["migrated_records"] == done and 0 < done < 302,
           "state": st["state"]}
    w2 = P.migration.MigrationWorker(ds2, legacy, batch_size=64,
                                     sleep_between=0.0)
    w2.start()
    _wait_state(w2, "completed")
    return _finish(P, ds2, legacy, rec, w2)


def _mig_pause_resume(P, d):
    legacy = d / "legacy.db"
    _legacy_with_n(legacy, 400)
    ds = P.sqlite.Datastore(":memory:")
    w = P.migration.MigrationWorker(ds, legacy, batch_size=16,
                                    sleep_between=0.01)
    w.start()
    w.pause()
    _wait_state(w, "paused")
    time.sleep(0.2)
    frozen = w.store.get()["migrated_records"]
    time.sleep(0.2)
    rec = {"frozen": w.store.get()["migrated_records"] == frozen}
    with pytest.raises(RuntimeError, match="resume"):
        w.start()
    rec["still_paused"] = w.store.get()["state"]
    w.resume()
    _wait_state(w, "completed")
    return _finish(P, ds, legacy, rec, w)


def _mig_cancel_rollback(P, d):
    legacy = d / "legacy.db"
    _legacy_with_n(legacy, 200)
    ds = P.sqlite.Datastore(":memory:")
    w = P.migration.MigrationWorker(ds, legacy, batch_size=16,
                                    sleep_between=0.01)
    w.start()
    _wait_migrated(w, 30)
    w.cancel()
    w.stop()
    rec = {"state": w.store.get()["state"],
           "kept": ds.count_detections() >= 30}
    w.rollback()
    rec.update(after=ds.count_detections(), idle=w.store.get()["state"],
               map=w.store.map_count())
    w2 = P.migration.MigrationWorker(ds, legacy, batch_size=128,
                                     sleep_between=0.0)
    w2.start()
    _wait_state(w2, "completed")
    return _finish(P, ds, legacy, rec, w, w2, ignore=ROLLED_BACK)


def _mig_completed_refusals(P, d):
    legacy = d / "legacy.db"
    _make_legacy_db(legacy)
    ds = P.sqlite.Datastore(":memory:")
    w = P.migration.MigrationWorker(ds, legacy, batch_size=8,
                                    sleep_between=0.0)
    w.start()
    _wait_state(w, "completed")
    with pytest.raises(RuntimeError, match="rollback unavailable"):
        w.rollback()
    with pytest.raises(RuntimeError, match="already completed"):
        w.start()
    return _finish(P, ds, legacy, {}, w)


def _mig_dual_write(P, d):
    legacy = d / "legacy.db"
    _legacy_with_n(legacy, 150)
    ds = P.sqlite.Datastore(":memory:")
    w = P.migration.MigrationWorker(ds, legacy, batch_size=16,
                                    sleep_between=0.01)
    w.start()
    assert _wait(lambda: w._uninstall_hook is not None)
    ds.insert_detection(_detection(
        P, "Parus major", "Great Tit", 0.88,
        datetime.datetime(2024, 6, 1, 7, 30, 0, 456789), "rtsp:cam1",
        "gretit1"))
    _wait_state(w, "completed")
    rec = {"written": w.status()["dual_write"]["written"],
           "great_tits": len(ds.search_detections(species="Parus major"))}
    return _finish(P, ds, legacy, rec, w, ignore=TIMED_IDS)


def _mig_catchup(P, d):
    legacy = d / "legacy.db"
    _legacy_with_n(legacy, 60)
    ds = P.sqlite.Datastore(":memory:")
    w = P.migration.MigrationWorker(ds, legacy, batch_size=16,
                                    sleep_between=0.01, dual_write=False)
    w.start()
    _wait_migrated(w, 20)
    conn = sqlite3.connect(legacy)
    conn.execute(
        "INSERT INTO notes (date, time, scientific_name, common_name,"
        " species_code, confidence, clip_name) VALUES"
        " ('2024-05-03','09:00:00','Late bird','Late','lb1',0.7,'')")
    conn.commit()
    conn.close()
    _wait_state(w, "completed")
    return _finish(P, ds, legacy, {"count": ds.count_detections()}, w)


def _mig_refusals(P, d):
    bogus = d / "bogus.db"
    sqlite3.connect(bogus).executescript(
        "CREATE TABLE x (id INTEGER);").connection.close()
    ds = P.sqlite.Datastore(":memory:")
    w = P.migration.MigrationWorker(ds, bogus)
    with pytest.raises(ValueError, match="no notes table"):
        w.start()
    idle = P.migration.MigrationWorker(ds, "/nonexistent")
    return {"status": _status(idle), "state": w.store.get()["state"],
            "states": P.migration.STATES}


def _mig_force(P, d):
    a, b = d / "a.db", d / "b.db"
    _legacy_with_n(a, 30)
    _make_legacy_db(b)
    conn = sqlite3.connect(b)
    conn.execute(
        "INSERT INTO notes (date, time, scientific_name, common_name,"
        " species_code, confidence, clip_name) VALUES"
        " ('2024-07-01','06:00:00','Only in B','B only','ob1',0.8,'')")
    conn.commit()
    conn.close()
    ds = P.sqlite.Datastore(":memory:")
    w = P.migration.MigrationWorker(ds, a, batch_size=64, sleep_between=0.0)
    w.start()
    _wait_state(w, "completed")
    w.stop()
    rec = {"first": ds.count_detections()}
    w2 = P.migration.MigrationWorker(ds, b, batch_size=64, sleep_between=0.0)
    with pytest.raises(RuntimeError, match="force"):
        w2.start()
    w2.start(force=True)
    _wait_state(w2, "completed")
    return _finish(P, ds, b, rec, w2)


def _mig_auto_pause(P, d):
    legacy = d / "legacy.db"
    _legacy_with_n(legacy, 40)
    ds = P.sqlite.Datastore(":memory:")
    w = P.migration.MigrationWorker(
        ds, legacy, batch_size=8, sleep_between=0.0, error_backoff=0.01,
        max_consecutive_errors=3, dual_write=False)
    orig = ds.insert_detection

    def boom(*a, **k):
        raise OSError("disk full")

    ds.insert_detection = boom
    w.start()
    _wait_state(w, "paused")
    st = w.store.get()
    rec = {k: st[k] for k in ("paused_from", "consecutive_errors", "error")}
    ds.insert_detection = orig
    w.resume()
    _wait_state(w, "completed")
    return _finish(P, ds, legacy, rec, w)


def _mig_rollback_spares(P, d):
    legacy = d / "legacy.db"
    _legacy_with_n(legacy, 50)
    ds = P.sqlite.Datastore(":memory:")
    pre_id = ds.insert_detection(_detection(
        P, "Turdus merula", "Eurasian Blackbird", 0.91,
        datetime.datetime(2024, 5, 1, 4, 55, 0, 250000), "soundcard",
        "eurbla"))
    w = P.migration.MigrationWorker(ds, legacy, batch_size=16,
                                    sleep_between=0.01, dual_write=False)
    w.start()
    _wait_migrated(w, 30)
    w.cancel()
    w.stop()
    w.rollback()
    rec = {"pre": ds.get_detection(pre_id) is not None}
    return _finish(P, ds, legacy, rec, w, ignore=ROLLED_BACK)


def _mig_commit_failure(P, d, monkeypatch):
    legacy = d / "legacy.db"
    _make_legacy_db(legacy)
    ds = P.sqlite.Datastore(":memory:")
    w = P.migration.MigrationWorker(ds, legacy)
    w._dw_queue.append((_detection(
        P, "Parus major", "Great Tit", 0.88,
        datetime.datetime(2024, 6, 1, 7, 30, 0, 456789), "rtsp:cam1",
        "gretit1"), None))
    real_connect = sqlite3.connect

    class _CommitFails:
        def __init__(self, conn):
            self._conn = conn

        def __getattr__(self, name):
            return getattr(self._conn, name)

        def commit(self):
            raise sqlite3.OperationalError("database is locked")

    monkeypatch.setattr(sqlite3, "connect",
                        lambda *a, **kw: _CommitFails(real_connect(*a, **kw)))
    w._drain_dual_write()
    monkeypatch.setattr(sqlite3, "connect", real_connect)
    rec = {"after_failure": (w._dw_written, w._dw_dropped,
                             len(w._dw_queue))}
    w._drain_dual_write()
    rec["after_recovery"] = (w._dw_written, len(w._dw_queue))
    return _finish(P, ds, legacy, rec, w)


def _mig_same_second(P, d):
    legacy = d / "legacy.db"
    _make_legacy_db(legacy)
    conn = sqlite3.connect(legacy)
    for conf in (0.61, 0.87):
        conn.execute(
            "INSERT INTO notes (date, time, scientific_name, common_name,"
            " species_code, confidence, clip_name) VALUES"
            " ('2024-05-02','07:15:30','Cyanistes caeruleus',"
            "'Eurasian Blue Tit','blutit1',?,'')", (conf,))
    conn.commit()
    conn.close()
    ds = P.sqlite.Datastore(":memory:")
    w = P.migration.MigrationWorker(ds, legacy, batch_size=16,
                                    sleep_between=0.0)
    w.start()
    _wait_state(w, "completed")
    return _finish(P, ds, legacy, {}, w)


def _mig_cancel_wins(P, d):
    legacy = d / "legacy.db"
    _legacy_with_n(legacy, 50)
    ds = P.sqlite.Datastore(":memory:")
    w = P.migration.MigrationWorker(ds, legacy, sleep_between=0.0,
                                    error_backoff=0.01,
                                    max_consecutive_errors=1,
                                    dual_write=False)

    def cancelled_midway(conn, tables, st):
        w.cancel()
        raise RuntimeError("batch blew up")

    w._migrate_batch = cancelled_midway
    w.start()
    w._thread.join(10)
    rec = {"alive": w._thread.is_alive()}
    return _finish(P, ds, legacy, rec, w)


def _mig_validation(P, d):
    legacy = d / "legacy.db"
    _legacy_with_n(legacy, 50)
    ds = P.sqlite.Datastore(":memory:")
    w = P.migration.MigrationWorker(ds, legacy, batch_size=64,
                                    sleep_between=0.0, dual_write=False)
    w.start()
    _wait_state(w, "completed")
    w.stop()
    conn = sqlite3.connect(legacy)
    for _ in range(10):
        conn.execute(
            "INSERT INTO notes (date, time, scientific_name, common_name,"
            " species_code, confidence, clip_name) VALUES"
            " ('2024-05-04','10:00:00','Tail bird','Tail','tb1',0.7,'')")
    conn.commit()
    conn.close()
    w.store.update(state="validating",
                   validation_attempts=P.migration.VALIDATION_MAX_RETRIES)
    lconn, _ = P.imports.open_birdnet_go_db(legacy)
    w._validate(lconn, w.store.get())
    rec = {"first": w.store.get()["state"]}
    with ds._lock:
        ds._conn.execute("DELETE FROM migration_map WHERE legacy_id IN"
                         " (SELECT legacy_id FROM migration_map LIMIT 3)")
        ds._conn.commit()
    w.store.update(state="validating",
                   validation_attempts=P.migration.VALIDATION_MAX_RETRIES,
                   validation_mapped=10)
    w._validate(lconn, w.store.get())
    lconn.close()
    return _finish(P, ds, legacy, rec, w)


MIGRATION_CASES = {f.__name__.removeprefix("_mig_"): f for f in (
    _mig_full, _mig_restart, _mig_pause_resume, _mig_cancel_rollback,
    _mig_completed_refusals, _mig_dual_write, _mig_catchup, _mig_refusals,
    _mig_force, _mig_auto_pause, _mig_rollback_spares, _mig_same_second,
    _mig_cancel_wins, _mig_validation)}

# the outcomes ``tests/test_migration.py`` asserts, read off the record
MIGRATION_EXPECT = {
    "full": lambda r: (r["status"]["migrated_records"] == 252
                       and r["status"]["progress_pct"] == 100.0
                       and len(r["native"]["detections"]) == 252
                       and r["rows"][0]["locked"] == 1
                       and r["reviews"] == ["correct"] and r["hook"]),
    "restart": lambda r: (r["persisted"] and r["state"] == "migrating"
                          and len(r["native"]["detections"]) == 302),
    "pause_resume": lambda r: (r["frozen"] and r["still_paused"] == "paused"
                               and len(r["native"]["detections"]) == 402),
    "cancel_rollback": lambda r: (r["state"] == "cancelled" and r["kept"]
                                  and r["after"] == 0 and r["map"] == 0
                                  and r["idle"] == "idle"
                                  and len(r["native"]["detections"]) == 202),
    "completed_refusals": lambda r: r["status"]["state"] == "completed",
    "dual_write": lambda r: (r["written"] == 1 and r["great_tits"] == 1
                             and len(r["native"]["detections"]) == 153
                             and ("2024-06-01", "07:30:00") in
                             {row[2:4] for row in r["legacy"]["notes"]}),
    "catchup": lambda r: r["count"] == 63,
    "refusals": lambda r: (r["status"]["state"] == "idle"
                           and r["status"]["progress_pct"] == 0.0
                           and r["status"]["dual_write"]["queued"] == 0),
    "force": lambda r: (r["first"] == 32
                        and len(r["native"]["detections"]) == 33),
    "auto_pause": lambda r: (r["paused_from"] == "migrating"
                             and r["consecutive_errors"] == 3
                             and "disk full" in r["error"]
                             and r["status"]["error"] is None
                             and len(r["native"]["detections"]) == 42),
    "rollback_spares": lambda r: (r["pre"]
                                  and len(r["native"]["detections"]) == 1),
    "same_second": lambda r: (sorted(round(row[9], 2) for row in
                                     r["native"]["detections"]
                                     if row[6] == "Cyanistes caeruleus")
                              == [0.61, 0.87]
                              and len(r["native"]["detections"]) == 4),
    "cancel_wins": lambda r: (not r["alive"]
                              and r["status"]["state"] == "cancelled"),
    "validation": lambda r: (r["first"] == "cutover"
                             and r["status"]["state"] == "migrating"
                             and r["status"]["validation_attempts"] == 1),
}


@pytest.mark.parametrize("name", sorted(MIGRATION_CASES))
def test_migration_case_equal_jax(name, tmp_path):
    """A case of ``tests/test_migration.py`` (those that need no API)
    through both packages: the native and legacy tables (wall-clock
    columns left out), the worker's status and the case's observations
    equal, and the JAX test's outcome holds."""
    case = MIGRATION_CASES[name]
    rec = _both(lambda P: case(P, _dir(tmp_path, P)))
    assert MIGRATION_EXPECT[name](rec), rec


def test_migration_dual_write_commit_failure_equal_jax(tmp_path,
                                                       monkeypatch):
    rec = _both(lambda P: _mig_commit_failure(P, _dir(tmp_path, P),
                                              monkeypatch))
    assert rec["after_failure"] == (0, 0, 1)
    assert rec["after_recovery"] == (1, 0)


def test_legacy_note_entry_equal_jax(tmp_path):
    def case(P):
        legacy = _dir(tmp_path, P) / "legacy.db"
        _legacy_with_n(legacy, 5)
        with sqlite3.connect(legacy) as conn:
            conn.execute("INSERT INTO notes (date, time) VALUES ('x', 'y')")
        conn.close()
        conn, tables = P.imports.open_birdnet_go_db(legacy)
        rows = conn.execute("SELECT * FROM notes ORDER BY id").fetchall()
        out = [sorted(tables)] + [P.imports.legacy_note_entry(conn, tables, n)
                                  for n in rows]
        conn.close()
        return out

    rec = _both(case)
    assert rec[-1] is None and rec[1]["locked"] and rec[1]["comments"]


# -- spectrogram --------------------------------------------------------------

INDEX_MAX_SHARE = 1e-3
RGB_MAX_STEP = 3


def _signal(rate: int, seconds: float, seed: int) -> np.ndarray:
    """A tone at 2.5 kHz over noise (and a 40 kHz call on the bat
    rate)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(rate * seconds)) / rate
    x = 0.3 * np.sin(2 * np.pi * 2500 * t) + 0.02 * rng.standard_normal(
        len(t))
    if rate > 96000:
        x += 0.2 * np.sin(2 * np.pi * 40000 * t) * (np.sin(40 * t) > 0.9)
    return x.astype(np.float32)


PROFILES = {"bird": (48000, 3.0), "bat": (256000, 1.0)}


def _jax_index(x, rate, width, profile, monkeypatch):
    """JAX's colour index: its render with an identity colour map and no
    resize."""
    js = J.spectrogram
    with monkeypatch.context() as m:
        m.setattr(js, "_CMAP", np.repeat(
            np.arange(256, dtype=np.uint8)[:, None], 3, axis=1))
        m.setattr(Image.Image, "resize", lambda self, *a, **k: self)
        img = js.render_spectrogram(x, rate, width=width,
                                    profile=getattr(js.FrequencyProfile,
                                                    profile)())
    return np.asarray(img)[..., 0]


@pytest.mark.parametrize("width", [400, 800, 1200])
@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_spectrogram_index_and_image_equal_jax(profile, width, tmp_path,
                                              monkeypatch):
    """The colour index on the CPU against JAX's (1 level at 1e-3 of the
    pixels); the port's colour map and resize on JAX's index equal to
    JAX's PIL image; the port's PNG, decoded by Pillow, its own array."""
    rate, seconds = PROFILES[profile]
    x = _signal(rate, seconds, 0)
    want = _jax_index(x, rate, width, profile, monkeypatch)
    prof = getattr(T.spectrogram.FrequencyProfile, profile)()
    got = T.spectrogram.spectrogram_index(x, rate, width=width, profile=prof,
                                          device="cpu")
    assert got.dtype == np.uint8 and got.shape == want.shape
    gap = np.abs(got.astype(int) - want)
    assert gap.max() <= 1 and (gap > 0).mean() <= INDEX_MAX_SHARE
    assert want.shape[0] == 257 and want.shape[1] >= width

    jax_img = J.spectrogram.render_spectrogram(
        x, rate, width=width, profile=getattr(J.spectrogram.FrequencyProfile,
                                              profile)())
    rgb = T.spectrogram._CMAP[want]
    if rgb.shape[1] != width:
        rgb = T.spectrogram._resize_width(rgb, width)
    np.testing.assert_array_equal(rgb, np.asarray(jax_img))

    out = T.spectrogram.generate_png(x, rate, tmp_path / "spec.png",
                                     width=width, profile=prof, device="cpu")
    png = np.asarray(Image.open(out).convert("RGB"))
    mine = T.spectrogram.render_spectrogram(x, rate, width=width,
                                            profile=prof, device="cpu")
    np.testing.assert_array_equal(png, mine)
    step = np.abs(mine.astype(int) - np.asarray(jax_img)).max(axis=-1)
    assert step.max() <= RGB_MAX_STEP
    assert (step > 0).mean() <= INDEX_MAX_SHARE
    assert not list(tmp_path.glob("*.tmp"))


@pytest.mark.parametrize("in_w,out_w", [(804, 800), (1212, 1200),
                                        (3000, 400), (300, 400), (7, 3),
                                        (5, 5 * 17)])
def test_resize_width_equals_pil_bilinear(in_w, out_w):
    """``_resize_width`` against Pillow's BILINEAR resize of random RGB
    rows, reducing and enlarging: bit for bit."""
    rgb = np.random.default_rng(in_w).integers(0, 256, (13, in_w, 3),
                                               np.uint8)
    want = np.asarray(Image.fromarray(rgb, "RGB").resize(
        (out_w, 13), Image.BILINEAR))
    np.testing.assert_array_equal(T.spectrogram._resize_width(rgb, out_w),
                                  want)


def test_png_writer_layout(tmp_path):
    """The PNG's chunks: IHDR (8-bit RGB), one IDAT whose inflated rows
    are filter 0 and the pixels, IEND; each CRC correct."""
    rgb = np.random.default_rng(1).integers(0, 256, (5, 7, 3), np.uint8)
    T.spectrogram.write_png(tmp_path / "x.png", rgb)
    data = (tmp_path / "x.png").read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, []
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        assert crc == zlib.crc32(kind + body)
        chunks.append((kind, body))
        pos += 12 + n
    assert [k for k, _ in chunks] == [b"IHDR", b"IDAT", b"IEND"]
    assert struct.unpack(">IIBBBBB", chunks[0][1]) == (7, 5, 8, 2, 0, 0, 0)
    rows = np.frombuffer(zlib.decompress(chunks[1][1]), np.uint8).reshape(
        5, 1 + 21)
    assert (rows[:, 0] == 0).all()
    np.testing.assert_array_equal(rows[:, 1:].reshape(5, 7, 3), rgb)


def _prerender(P, d):
    """``tests/test_dsp_aux.py``'s singleflight case, then a second output
    and a full queue."""
    kw = {} if P is J else {"device": "cpu"}
    pr = P.spectrogram.PreRenderer(workers=1, **kw)
    x = _signal(48000, 1.0, 3)
    out = d / "a.png"
    rec = [pr.submit(x, 48000, out, width=100),
           pr.submit(x, 48000, out, width=100), pr.queue_depth()]
    pr.start()
    assert _wait(lambda: pr.rendered == 1, 30)
    rec += [pr.submit(x, 48000, d / "b.png", width=120)]
    assert _wait(lambda: pr.rendered == 2, 30)
    pr.stop()
    rec += [pr.rendered, pr.dropped, out.exists(),
            Image.open(out).size, Image.open(d / "b.png").size]
    full = P.spectrogram.PreRenderer(workers=1, **kw)
    rec.append([full.submit(x, 48000, d / f"q{i}.png") for i in range(258)])
    rec.append(full.dropped)
    return rec


def test_prerenderer_singleflight_equal_jax(tmp_path):
    rec = _both(lambda P: _prerender(P, _dir(tmp_path, P)))
    assert rec[:3] == [True, True, 1] and rec[4:7] == [2, 0, True]
    assert rec[-2] == [True] * 256 + [False] * 2 and rec[-1] == 2


def test_aux_device_work_refuses_cuda_without_a_card(monkeypatch):
    """No fallback: asked for the card where there is none, the render,
    the pre-renderer and the sound-level worker raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _signal(48000, 1.0, 0)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        T.spectrogram.render_spectrogram(x, 48000)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        T.spectrogram.PreRenderer()
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        T.soundlevel_worker.SoundLevelWorker(SimpleNamespace())
    assert T.spectrogram.spectrogram_index(x, 48000, device="cpu").size


# -- sound levels -------------------------------------------------------------

LEVEL_GAP_DB = 0.05
ROUNDING_STEP_DB = 0.1


class _Engine:
    """Stand-in engine: sources with capture buffers (one without)."""

    def __init__(self, P, now, n, rates):
        self._src = [SimpleNamespace(source_id=f"src{i}") for i in range(n)]
        self._cb = {}
        for i, s in enumerate(self._src[:-1]):
            rate = rates[i % len(rates)]
            cb = P.buffers.CaptureBuffer(rate, capacity_seconds=12.0)
            seconds = 10.0 if i % 3 else 4.0       # part zero-filled
            t = np.arange(int(rate * seconds)) / rate
            rng = np.random.default_rng(i)
            x = (3000 * np.sin(2 * np.pi * (300 + 400 * i) * t)
                 + 500 * rng.standard_normal(len(t)))
            cb.write(x.astype(np.int16), timestamp=now - seconds)
            self._cb[s.source_id] = cb

    def sources(self):
        return self._src

    def capture_buffer(self, sid):
        return self._cb.get(sid)


class _Sink:
    def __init__(self):
        self.calls = []

    def publish(self, *args):
        self.calls.append(args)


def _levels(P, monkeypatch, now):
    """``sample_once`` and ``publish_once`` on a fixed clock, and the raw
    levels of each source's interval."""
    monkeypatch.setattr(time, "time", lambda: now)
    eng = _Engine(P, now, 5, (48000, 32000, 44100))
    kw = {} if P is J else {"device": "cpu"}
    sse, mqtt = _Sink(), _Sink()
    w = P.soundlevel_worker.SoundLevelWorker(eng, sse=sse, mqtt=mqtt,
                                             mqtt_topic="t", **kw)
    rec = w.sample_once()
    w.publish_once()
    raw = {}
    for s in eng.sources()[:-1]:
        cb = eng.capture_buffer(s.source_id)
        pcm = cb.read_segment(now - 10.0, now)
        x = pcm.astype(np.float32) / 32768.0
        cfg = P.soundlevel.SoundLevelConfig(sample_rate=cb.sample_rate)
        if P is J:
            raw[s.source_id] = np.asarray(J.soundlevel.band_levels_db(
                jnp.asarray(x), cfg)[0])
        else:
            raw[s.source_id] = w._levels(pcm, cb.sample_rate)
    return rec, sse.calls, mqtt.calls, w.published, raw


def test_soundlevel_worker_equal_jax_within_005_db(monkeypatch):
    now = 1_760_000_000.0
    want = _levels(J, monkeypatch, now)
    got = _levels(T, monkeypatch, now)
    assert got[3] == want[3] == 1
    for sid in want[4]:
        assert np.abs(got[4][sid] - want[4][sid]).max() <= LEVEL_GAP_DB
    recs = [(got[0], want[0]), (got[1][0][2], want[1][0][2]),
            (got[2][0][1], want[2][0][1])]
    assert got[1][0][:2] == want[1][0][:2] == ("soundlevels", "soundlevel")
    assert got[2][0][0] == want[2][0][0] == "t/soundlevels"
    for g, w in recs:
        assert sorted(g) == sorted(w) == [f"src{i}" for i in range(4)]
        for sid in w:
            assert g[sid]["bands_hz"] == w[sid]["bands_hz"]
            assert g[sid]["time"] == w[sid]["time"] == now
            gap = np.abs(np.subtract(g[sid]["levels_db"],
                                     w[sid]["levels_db"]))
            assert gap.max() <= ROUNDING_STEP_DB + 1e-9


def test_band_matrix_and_window_stay_on_the_device():
    """``band_levels_db`` uploads its band matrix and window once per
    device and configuration; a pass then moves only PCM."""
    melspec = importlib.import_module("birdnet_go_tpu_torch.ops.melspec")
    soundlevel = T.soundlevel

    soundlevel._band_matrix_on.cache_clear()
    melspec._window_on.cache_clear()
    cfg = soundlevel.SoundLevelConfig()
    x = torch.from_numpy(_signal(48000, 1.0, 0))
    with torch.inference_mode():
        a = soundlevel.band_levels_db(x, cfg)[0]
    b = soundlevel.band_levels_db(x, cfg)[0]
    assert torch.equal(a, b)
    assert soundlevel._band_matrix_on.cache_info().misses == 1
    assert soundlevel._band_matrix_on.cache_info().hits == 1
    assert melspec._window_on.cache_info().misses == 1
    m = soundlevel._band_matrix_on(cfg.sample_rate, cfg.n_fft, cfg.fmin,
                                   cfg.fmax, torch.device("cpu"))
    assert not m.is_inference()
