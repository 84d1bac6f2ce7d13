"""WAV (RIFF) decode/encode without external tools (a copy of
``birdnet_go_tpu/audio/wav.py``, which the port may not import).

Supports the reference's offline-analysis input contract
(doc/wiki/file-analysis.md): 16/24/32-bit integer PCM plus IEEE float32,
any sample rate (resampled downstream), multi-channel downmixed to mono.
Output (clip export) is 16-bit PCM, the reference's core format
(internal/conf/consts.go:14-17).
"""

from __future__ import annotations

import dataclasses
import io
import struct

import numpy as np

_FMT_PCM = 1
_FMT_IEEE_FLOAT = 3
_FMT_EXTENSIBLE = 0xFFFE


@dataclasses.dataclass(frozen=True)
class WavInfo:
    sample_rate: int
    channels: int
    bit_depth: int
    num_frames: int

    @property
    def duration_seconds(self) -> float:
        return self.num_frames / float(self.sample_rate)


def read_wav(path_or_file, mono: bool = True
             ) -> tuple[np.ndarray, WavInfo]:
    """Read a WAV file → (float32 samples in [-1, 1], WavInfo).

    `mono=True` averages channels (the reference feeds mono analysis audio).
    """
    if hasattr(path_or_file, "read"):
        data = path_or_file.read()
    else:
        with open(path_or_file, "rb") as f:
            data = f.read()
    if len(data) < 12 or data[0:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")

    fmt = None
    fmt_body = b""
    pcm = None
    pos = 12
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
            fmt_body = body
        elif cid == b"data":
            pcm = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    if fmt is None or pcm is None:
        raise ValueError("missing fmt or data chunk")

    audio_fmt, channels, rate, _, _, bits = fmt
    if audio_fmt == _FMT_EXTENSIBLE and len(fmt_body) >= 26:
        # SubFormat GUID's first two bytes carry the real format tag.
        (audio_fmt,) = struct.unpack("<H", fmt_body[24:26])
    if audio_fmt == _FMT_IEEE_FLOAT or (audio_fmt == _FMT_PCM and bits == 32
                                        and _looks_float32(pcm)):
        x = np.frombuffer(pcm, dtype="<f4").astype(np.float32)
    elif bits == 16:
        x = np.frombuffer(pcm, dtype="<i2").astype(np.float32) / 32768.0
    elif bits == 24:
        raw = np.frombuffer(pcm, dtype=np.uint8)
        n = len(raw) // 3
        raw = raw[:n * 3].reshape(n, 3)
        as32 = (raw[:, 0].astype(np.uint32)
                | (raw[:, 1].astype(np.uint32) << 8)
                | (raw[:, 2].astype(np.uint32) << 16))
        signed = as32.astype(np.int32)
        signed = np.where(signed >= (1 << 23), signed - (1 << 24), signed)
        x = signed.astype(np.float32) / float(1 << 23)
    elif bits == 32:
        x = np.frombuffer(pcm, dtype="<i4").astype(np.float32) / float(1 << 31)
    elif bits == 8:
        x = (np.frombuffer(pcm, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported bit depth {bits}")

    if channels > 1:
        n = len(x) // channels
        x = x[:n * channels].reshape(n, channels)
        if mono:
            x = x.mean(axis=1)
        num_frames = n
    else:
        num_frames = len(x)
    return x, WavInfo(rate, channels, bits, num_frames)


def _looks_float32(pcm: bytes) -> bool:
    """Heuristic for mislabeled 32-bit chunks: float32 audio stays in [-4,4]
    AND shows a plausible signal. Probes head/middle/tail of the data chunk
    (a leading-silence int32 field recording must not pass on zeros alone)
    and requires some samples with float-audio-like magnitude."""
    n = len(pcm) & ~3
    if n == 0:
        return False
    spans = [pcm[:4096]]
    if n > 4096:
        mid = (n // 2) & ~3
        spans.append(pcm[mid:mid + 4096])
        spans.append(pcm[n - 4096:n])
    probe = np.frombuffer(b"".join(s[:len(s) & ~3] for s in spans),
                          dtype="<f4")
    if probe.size == 0:
        return False
    if not np.isfinite(probe).all():
        return False
    mags = np.abs(probe)
    if mags.max() > 4.0:
        return False
    # Genuine float audio has samples in a sane dynamic range; int32 PCM
    # reinterpreted as float yields either zeros (silence) or denormals /
    # tiny magnitudes far below 1e-5.
    plausible = (mags >= 1e-5) & (mags <= 4.0)
    return bool(plausible.any())


def write_wav(path_or_file, samples: np.ndarray, sample_rate: int) -> None:
    """Write mono float32 [-1,1] (or int16) samples as 16-bit PCM WAV."""
    if samples.dtype != np.int16:
        samples = np.clip(np.asarray(samples) * 32768.0, -32768, 32767)
        samples = np.round(samples).astype("<i2")
    pcm = samples.astype("<i2").tobytes()
    hdr = io.BytesIO()
    hdr.write(b"RIFF")
    hdr.write(struct.pack("<I", 36 + len(pcm)))
    hdr.write(b"WAVE")
    hdr.write(b"fmt ")
    hdr.write(struct.pack("<IHHIIHH", 16, _FMT_PCM, 1, sample_rate,
                          sample_rate * 2, 2, 16))
    hdr.write(b"data")
    hdr.write(struct.pack("<I", len(pcm)))
    hdr.write(pcm)
    blob = hdr.getvalue()
    if hasattr(path_or_file, "write"):
        path_or_file.write(blob)
    else:
        with open(path_or_file, "wb") as f:
            f.write(blob)
