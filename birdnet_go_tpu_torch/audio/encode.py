"""Clip encoding front end: native WAV/FLAC/Opus/MP3/AAC.

Reference: internal/conf/native_encoders.go + audiocore/aac/opus — the
reference ships native Go encoders (go-opus→libopus, pure-Go AAC-LC)
behind a feature gate with FFmpeg as default. Here Opus (.opus, RFC 7845
Ogg), MP3, and AAC-LC (.m4a via audio.aacenc's own MP4 muxer) run through
dlopen'd system codecs in csrc/codecs.cpp — preferred over FFmpeg
because they need no subprocess — WAV and FLAC (real fixed-predictor
compression) are pure-native, and ffmpeg remains only as a last-resort
fallback when a codec library is missing but the binary exists. Every
lossy path ultimately falls back to native FLAC so a clip is never lost
to a missing encoder.

A copy of ``birdnet_go_tpu/audio/encode.py`` for the port, which imports
nothing of the JAX package; its Opus, MP3 and AAC run through the port's
codec library (``audio/opusogg.py``, ``audio/aacenc.py``,
``csrc/codecs.cpp``), and a codec library missing at run time takes the
JAX function's path for a host without it: ffmpeg where its binary
exists, else FLAC. ``tests/test_torch_aux.py`` and
``tests/test_torch_codecs.py`` hold the module to the original.
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

# injectable for tests; None → shutil.which resolved at call time so
# patches of shutil.which (and PATH changes) take effect
_which = None
_run = subprocess.run


def ffmpeg_available() -> bool:
    return (_which or shutil.which)("ffmpeg") is not None


def _native_codec_available(fmt: str) -> bool:
    from birdnet_go_tpu_torch.audio import opusogg

    if fmt == "opus":
        return opusogg.opus_available()
    if fmt == "mp3":
        return opusogg.mp3_available()
    if fmt == "aac":
        from birdnet_go_tpu_torch.audio import aacenc

        return aacenc.available()
    return False


# Opus only accepts these input rates; other rates (e.g. the 256 kHz bat
# clips) keep FLAC/ffmpeg so no ultrasonic content is resampled away.
# Single source of truth lives beside the codec (audio.opusogg).
from birdnet_go_tpu_torch.audio.opusogg import OPUS_RATES as _OPUS_RATES  # noqa: E402


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
            rate_ok = sample_rate in _OPUS_RATES
        elif fmt == "aac":
            from birdnet_go_tpu_torch.audio.aacenc import supported_rate

            # 256 kHz bat clips exceed every AAC sampling index — keep
            # them lossless rather than resampling ultrasonics away.
            # This gates the FFMPEG path too: ffmpeg's AAC encoder
            # rejects 256 kHz at encode time, which would leave a DB row
            # pointing at a clip that was never written.
            if not supported_rate(sample_rate):
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
        from birdnet_go_tpu_torch.audio import aacenc

        packets, asc, rate, priming = aacenc.read_m4a(path)
        pcm = aacenc.decode_aac(packets, asc, rate)
        # trim the encoder priming the edit list declares so the decoded
        # timeline aligns with the detection window (FLAC/WAV parity)
        return pcm[priming:].astype(np.float32) / 32768.0, rate
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
        from birdnet_go_tpu_torch.audio import opusogg

        if fmt == "opus" and sample_rate in _OPUS_RATES \
                and opusogg.opus_available():
            if out.suffix.lower() not in (".opus", ".ogg"):
                out = out.with_suffix(".opus")
            return opusogg.encode_ogg_opus(pcm_i16, sample_rate, out)
        if fmt == "mp3" and opusogg.mp3_available():
            if out.suffix.lower() != ".mp3":
                out = out.with_suffix(".mp3")
            return opusogg.encode_mp3(pcm_i16, sample_rate, out)
        if fmt == "aac":
            from birdnet_go_tpu_torch.audio import aacenc

            if not aacenc.supported_rate(sample_rate):
                # no AAC sampling index (256 kHz bat) — ffmpeg would
                # reject it at encode time, so go lossless directly
                fallback = out.with_suffix(".flac")
                from birdnet_go_tpu_torch.audio.flac import write_flac

                return write_flac(fallback, pcm_i16, sample_rate)
            if aacenc.available():
                if out.suffix.lower() != ".m4a":
                    out = out.with_suffix(".m4a")
                packets, asc, priming = aacenc.encode_aac_with_priming(
                    pcm_i16, sample_rate)
                return aacenc.write_m4a(out, packets, asc, sample_rate,
                                        priming=priming)
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
