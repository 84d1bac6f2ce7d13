"""Clip encoding front end: native WAV and FLAC, ffmpeg for the lossy formats.

Reference: internal/conf/native_encoders.go + audiocore/aac/opus — the
reference ships native Go encoders (go-opus→libopus, pure-Go AAC-LC)
behind a feature gate with FFmpeg as default. WAV and FLAC (real
fixed-predictor compression) are pure-native, and ffmpeg encodes Opus,
MP3 and AAC when its binary exists. Every lossy path ultimately falls
back to native FLAC so a clip is never lost to a missing encoder.

A copy of ``birdnet_go_tpu/audio/encode.py`` for the port, without the
native codecs. The JAX package encodes Opus, MP3 and AAC through
``native/codecs.cpp`` (``audio/opusogg.py``, ``audio/aacenc.py``); the
port's native build leaves that file out, because the card's machine has
no FFmpeg headers, so ``_native_codec_available`` reports every native
codec missing and a lossy format takes the JAX function's path for a host
without them: ffmpeg where its binary exists, else FLAC.
``load_clip_audio`` refuses ``.m4a``, which needs the native AAC decoder.
``tests/test_torch_aux.py`` holds the module to the original.
"""

from __future__ import annotations

import logging
import shutil
import subprocess
from pathlib import Path

import numpy as np

log = logging.getLogger("birdnet_tpu.encode")

_FFMPEG_FORMATS = {
    "aac": ([".m4a"], ["-c:a", "aac", "-b:a", "96k", "-movflags",
                       "+faststart"]),
    "opus": ([".opus", ".ogg"], ["-c:a", "libopus", "-b:a", "64k"]),
    "mp3": ([".mp3"], ["-c:a", "libmp3lame", "-b:a", "128k"]),
}

# Opus only accepts these input rates; other rates (e.g. the 256 kHz bat
# clips) keep FLAC/ffmpeg so no ultrasonic content is resampled away (the
# JAX package keeps the constant beside its codec, audio/opusogg.py)
OPUS_RATES = (8000, 12000, 16000, 24000, 48000)

# rates with an AAC sampling-frequency index (ISO 14496-3 §1.6.3.4; the
# keys of audio/aacenc.py's _FREQ_INDEX in the JAX package)
AAC_RATES = frozenset((96000, 88200, 64000, 48000, 44100, 32000, 24000,
                       22050, 16000, 12000, 11025, 8000, 7350))

# injectable for tests; None → shutil.which resolved at call time so
# patches of shutil.which (and PATH changes) take effect
_which = None
_run = subprocess.run


def ffmpeg_available() -> bool:
    return (_which or shutil.which)("ffmpeg") is not None


def _native_codec_available(fmt: str) -> bool:
    """Whether the native codec for `fmt` is loaded: never in the port,
    whose native build has no ``codecs.cpp`` (ROADMAP.md queue 1)."""
    return False


def supported_formats() -> list[str]:
    out = ["wav", "flac"]
    for fmt in _FFMPEG_FORMATS:
        if _native_codec_available(fmt) or ffmpeg_available():
            out.append(fmt)
    return out


def resolve_format(fmt: str, sample_rate: int = 48000) -> tuple[str, str]:
    """(actual format, file suffix) the encoder will REALLY produce for a
    configured export format — callers must name clips with this suffix
    BEFORE recording them in the database, or rows point at files that
    don't exist (aac writes .m4a; lossy without any encoder falls back to
    flac)."""
    fmt = (fmt or "wav").lower()
    if fmt in ("", "wav"):
        return "wav", ".wav"
    if fmt == "flac":
        return "flac", ".flac"
    if fmt in _FFMPEG_FORMATS:
        if fmt == "opus":
            rate_ok = sample_rate in OPUS_RATES
        elif fmt == "aac":
            # 256 kHz bat clips exceed every AAC sampling index — keep
            # them lossless rather than resampling ultrasonics away.
            # This gates the FFMPEG path too: ffmpeg's AAC encoder
            # rejects 256 kHz at encode time, which would leave a DB row
            # pointing at a clip that was never written.
            if sample_rate not in AAC_RATES:
                return "flac", ".flac"
            rate_ok = True
        else:
            rate_ok = True
        if rate_ok and _native_codec_available(fmt):
            return fmt, _FFMPEG_FORMATS[fmt][0][0]
        if ffmpeg_available():
            return fmt, _FFMPEG_FORMATS[fmt][0][0]
        return "flac", ".flac"
    raise ValueError(f"unsupported clip format {fmt!r}")


def load_clip_audio(path: str | Path) -> tuple[np.ndarray, int]:
    """Decode a stored clip → (float32 samples [-1,1], sample_rate).
    Understands the formats this codebase writes natively (WAV, FLAC);
    used by spectrogram (re)generation."""
    path = Path(path)
    if path.suffix.lower() == ".flac":
        from birdnet_go_tpu_torch.audio.flac import decode_flac

        pcm, rate = decode_flac(path.read_bytes())
        return pcm.astype(np.float32) / 32768.0, rate
    if path.suffix.lower() == ".m4a":
        raise NotImplementedError(
            f"{path.name}: decoding .m4a needs the native AAC codec "
            "(native/codecs.cpp), which the port does not build "
            "(ROADMAP.md queue 1, the native codecs)")
    from birdnet_go_tpu_torch.audio.wav import read_wav

    samples, info = read_wav(path)
    return samples, info.sample_rate


# suffix → format (a .m4a file is AAC, .ogg is opus, …)
_SUFFIX_FMT = {"m4a": "aac", "aac": "aac", "opus": "opus", "ogg": "opus",
               "mp3": "mp3", "wav": "wav", "flac": "flac"}


def encode_clip(pcm_i16: np.ndarray, sample_rate: int, out_path: str | Path,
                fmt: str | None = None) -> Path:
    """Write PCM to out_path in `fmt` (default: by file suffix). Returns the
    actual path written — it may differ when a lossy format falls back to
    FLAC because FFmpeg is absent."""
    out = Path(out_path)
    fmt = (fmt or out.suffix.lstrip(".")).lower()
    fmt = _SUFFIX_FMT.get(fmt, fmt)
    if fmt in ("", "wav"):
        from birdnet_go_tpu_torch.audio.wav import write_wav

        tmp = out.with_suffix(out.suffix + ".tmp")
        with open(tmp, "wb") as f:
            write_wav(f, pcm_i16, sample_rate)
        tmp.rename(out)
        return out
    if fmt == "flac":
        from birdnet_go_tpu_torch.audio.flac import write_flac

        return write_flac(out, pcm_i16, sample_rate)
    if fmt in _FFMPEG_FORMATS:
        if fmt == "aac" and sample_rate not in AAC_RATES:
            # no AAC sampling index (256 kHz bat) — ffmpeg would
            # reject it at encode time, so go lossless directly
            fallback = out.with_suffix(".flac")
            from birdnet_go_tpu_torch.audio.flac import write_flac

            return write_flac(fallback, pcm_i16, sample_rate)
        if ffmpeg_available():
            return _ffmpeg_encode(pcm_i16, sample_rate, out, fmt)
        fallback = out.with_suffix(".flac")
        log.warning("no %s encoder available: export falls back to FLAC (%s)",
                    fmt, fallback.name)
        from birdnet_go_tpu_torch.audio.flac import write_flac

        return write_flac(fallback, pcm_i16, sample_rate)
    raise ValueError(f"unsupported clip format {fmt!r}")


def _ffmpeg_encode(pcm_i16: np.ndarray, sample_rate: int, out: Path,
                   fmt: str) -> Path:
    """Raw s16le on stdin → encoded file via atomic temp+rename (the
    reference's FFmpeg export contract: export.go)."""
    suffixes, codec_args = _FFMPEG_FORMATS[fmt]
    if out.suffix.lower() not in suffixes:
        out = out.with_suffix(suffixes[0])
    tmp = out.with_name(out.name + ".tmp" + out.suffix)
    cmd = ["ffmpeg", "-hide_banner", "-loglevel", "error", "-y",
           "-f", "s16le", "-ar", str(sample_rate), "-ac", "1", "-i", "-",
           *codec_args, str(tmp)]
    proc = _run(cmd, input=np.asarray(pcm_i16, "<i2").tobytes(),
                capture_output=True, timeout=120)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"ffmpeg {fmt} encode failed: {proc.stderr.decode()[:300]}")
    tmp.rename(out)
    return out
