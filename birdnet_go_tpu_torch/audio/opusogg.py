"""Ogg Opus container: mux native-encoded Opus packets into .opus files.

Reference parity: internal/audiocore/opus/encode.go (go-opus → libopus +
Ogg muxing). Here the codec runs in csrc/codecs.cpp (dlopen libopus,
same graceful-absence pattern as the ALSA shim) and this module writes the
RFC 7845 container: OpusHead/OpusTags on their own beginning-of-stream
pages, 20 ms packets with 48 kHz granule positions, end-of-stream flag and
a final-page granule that trims the encoder's zero padding.

A copy of ``birdnet_go_tpu/audio/opusogg.py`` for the port, which imports
nothing of the JAX package, bound to the port's codec library
(``native/lib.py`` ``_load_codecs``: ``csrc/codecs.cpp``, whose Opus and
MP3 parts are ``native/codecs.cpp``'s); ``tests/test_torch_codecs.py``
holds it to the original, byte for byte.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from pathlib import Path

import numpy as np

from birdnet_go_tpu_torch.native import lib as native

# ---------------------------------------------------------------- Ogg CRC32

# Ogg uses CRC-32 poly 0x04c11db7, no reflection, zero init/xor.
# Built eagerly at import: lazy init from the jobqueue worker and the
# live-stream executor concurrently would interleave appends.
def _build_crc_table() -> tuple[int, ...]:
    out = []
    for i in range(256):
        r = i << 24
        for _ in range(8):
            r = ((r << 1) ^ 0x04C11DB7) if r & 0x80000000 else (r << 1)
            r &= 0xFFFFFFFF
        out.append(r)
    return tuple(out)


_CRC_TABLE = _build_crc_table()


def ogg_crc(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ _CRC_TABLE[((crc >> 24) & 0xFF) ^ b]
    return crc


# ---------------------------------------------------------------- Ogg pages

def _page(serial: int, seq: int, granule: int, packets: list[bytes],
          *, bos: bool = False, eos: bool = False,
          continued: bool = False) -> bytes:
    """One Ogg page. Each packet must be < 255*255 bytes (Opus packets at
    our bitrates are ~200 B; 20 ms frames never approach the limit)."""
    lacing = bytearray()
    body = bytearray()
    for pkt in packets:
        n = len(pkt)
        while n >= 255:
            lacing.append(255)
            n -= 255
        lacing.append(n)
        body += pkt
    header_type = (0x01 if continued else 0) | (0x02 if bos else 0) \
        | (0x04 if eos else 0)
    header = struct.pack("<4sBBqIIIB", b"OggS", 0, header_type,
                         granule, serial, seq, 0, len(lacing)) \
        + bytes(lacing)
    page = bytearray(header + bytes(body))
    crc = ogg_crc(bytes(page))
    page[22:26] = struct.pack("<I", crc)
    return bytes(page)


def mux_ogg_opus(packets: list[bytes], *, channels: int, preskip_48k: int,
                 input_rate: int, total_samples_48k: int,
                 serial: int = 0x42697264) -> bytes:
    """Assemble a complete Ogg Opus stream (RFC 7845 §3-5)."""
    head = struct.pack("<8sBBHIhB", b"OpusHead", 1, channels, preskip_48k,
                       input_rate, 0, 0)
    vendor = b"birdnet-go-tpu native opus"
    tags = b"OpusTags" + struct.pack("<I", len(vendor)) + vendor \
        + struct.pack("<I", 0)
    out = bytearray()
    out += _page(serial, 0, 0, [head], bos=True)
    out += _page(serial, 1, 0, [tags])
    # audio pages: up to 50 packets (1 s) per page; granule = 48 kHz sample
    # count of the last completed packet + preskip; the final page's granule
    # trims zero padding down to the true signal length (RFC 7845 §4.4)
    seq = 2
    samples_per_pkt_48k = 960          # 20 ms at 48 kHz
    done = 0
    for i in range(0, len(packets), 50):
        group = packets[i:i + 50]
        done += len(group) * samples_per_pkt_48k
        last = i + len(group) >= len(packets)
        granule = preskip_48k + (min(done, total_samples_48k)
                                 if last else done)
        out += _page(serial, seq, granule, group, eos=last)
        seq += 1
    return bytes(out)


def parse_ogg_pages(blob: bytes) -> list[dict]:
    """Minimal Ogg page walker for tests/HLS: returns page dicts with
    verified CRCs."""
    pages = []
    off = 0
    while off + 27 <= len(blob):
        if blob[off:off + 4] != b"OggS":
            raise ValueError(f"bad capture pattern at {off}")
        (_, _ver, htype, granule, serial, seq, crc,
         nsegs) = struct.unpack_from("<4sBBqIIIB", blob, off)
        lacing = blob[off + 27:off + 27 + nsegs]
        body_len = sum(lacing)
        page_len = 27 + nsegs + body_len
        page = bytearray(blob[off:off + page_len])
        page[22:26] = b"\0\0\0\0"
        if ogg_crc(bytes(page)) != crc:
            raise ValueError(f"CRC mismatch on page {seq}")
        # split packets by lacing (255 = continuation)
        packets, cur = [], bytearray()
        bo = off + 27 + nsegs
        for lv in lacing:
            cur += blob[bo:bo + lv]
            bo += lv
            if lv < 255:
                packets.append(bytes(cur))
                cur = bytearray()
        pages.append({"granule": granule, "serial": serial, "seq": seq,
                      "type": htype, "packets": packets})
        off += page_len
    return pages


# ------------------------------------------------------------- codec access

_enc_lock = threading.Lock()


def opus_available() -> bool:
    lib = native._load_codecs()
    return bool(lib is not None and hasattr(lib, "bn_opus_available")
                and lib.bn_opus_available())


def mp3_available() -> bool:
    lib = native._load_codecs()
    return bool(lib is not None and hasattr(lib, "bn_mp3_available")
                and lib.bn_mp3_available())


# Opus only accepts these input rates (RFC 6716); shared with audio.encode
OPUS_RATES = (8000, 12000, 16000, 24000, 48000)
_OPUS_RATES = OPUS_RATES


def encode_opus_packets(pcm_i16: np.ndarray, rate: int,
                        bitrate: int = 64000) -> tuple[list[bytes], int]:
    """Mono int16 → (opus packets, preskip_at_rate). Raises RuntimeError
    when libopus is absent or the rate is not Opus-valid (callers resample
    to 48 kHz first — ops/resample.py)."""
    lib = native._load_codecs()
    if lib is None or not lib.bn_opus_available():
        raise RuntimeError("libopus unavailable")
    if rate not in _OPUS_RATES:
        raise RuntimeError(f"opus-invalid rate {rate}")
    pcm_i16 = np.ascontiguousarray(pcm_i16, np.int16)
    cap = max(len(pcm_i16) * 2, 1 << 16)
    out = ctypes.create_string_buffer(cap)
    n_pk = ctypes.c_int32()
    preskip = ctypes.c_int32()
    with _enc_lock:
        n = lib.bn_opus_encode(
            pcm_i16.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            len(pcm_i16), rate, 1, bitrate, out, cap,
            ctypes.byref(n_pk), ctypes.byref(preskip))
    if n < 0:
        raise RuntimeError(f"opus encode failed ({n})")
    packets, off = [], 0
    raw = out.raw[:n]
    for _ in range(n_pk.value):
        (ln,) = struct.unpack_from("<I", raw, off)
        packets.append(raw[off + 4:off + 4 + ln])
        off += 4 + ln
    return packets, preskip.value


def decode_opus_packets(packets: list[bytes], rate: int) -> np.ndarray:
    """Round-trip helper (tests, HLS validation): packets → mono int16."""
    lib = native._load_codecs()
    if lib is None or not lib.bn_opus_available():
        raise RuntimeError("libopus unavailable")
    blob = b"".join(struct.pack("<I", len(p)) + p for p in packets)
    cap = max((len(packets) + 1) * (rate * 60 // 1000), 1 << 14)
    out = np.empty(cap, np.int16)
    n = lib.bn_opus_decode(blob, len(blob), rate, 1,
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                           cap)
    if n < 0:
        raise RuntimeError(f"opus decode failed ({n})")
    return out[:n]


def encode_ogg_opus(pcm_i16: np.ndarray, rate: int, path: str | Path,
                    bitrate: int = 64000) -> Path:
    """int16 mono PCM → .opus file via the native encoder."""
    packets, preskip = encode_opus_packets(pcm_i16, rate, bitrate)
    total_48k = int(len(pcm_i16) * 48000 / rate)
    preskip_48k = int(preskip * 48000 / rate)
    blob = mux_ogg_opus(packets, channels=1, preskip_48k=preskip_48k,
                        input_rate=rate, total_samples_48k=total_48k)
    out = Path(path)
    tmp = out.with_suffix(out.suffix + ".tmp")
    tmp.write_bytes(blob)           # atomic temp+rename like the reference
    tmp.replace(out)
    return out


class OggOpusStreamer:
    """Incremental Ogg Opus stream for live HTTP audio: feed PCM chunks,
    get back Ogg bytes (header pages first) — one persistent encoder so
    chunk joins are seamless (reference role: HLS live audio; this is the
    Ogg/chunked-HTTP equivalent browsers play natively)."""

    def __init__(self, rate: int, bitrate: int = 64000,
                 serial: int = 0x4C697665):
        lib = native._load_codecs()
        if lib is None or not getattr(lib, "bn_opus_available", None) \
                or not lib.bn_opus_available() \
                or not hasattr(lib, "bn_opus_stream_create"):
            raise RuntimeError("libopus streaming unavailable")
        if rate not in _OPUS_RATES:
            raise RuntimeError(f"opus-invalid rate {rate}")
        self._lib = lib
        self.rate = rate
        self.serial = serial
        preskip = ctypes.c_int32()
        lib.bn_opus_stream_create.restype = ctypes.c_void_p
        self._h = lib.bn_opus_stream_create(rate, 1, bitrate,
                                            ctypes.byref(preskip))
        if not self._h:
            raise RuntimeError("opus stream encoder create failed")
        self.preskip_48k = int(preskip.value * 48000 / rate)
        self._seq = 2
        self._granule = self.preskip_48k
        self._header_sent = False

    def header_pages(self) -> bytes:
        head = struct.pack("<8sBBHIhB", b"OpusHead", 1, 1, self.preskip_48k,
                           self.rate, 0, 0)
        vendor = b"birdnet-go-tpu live"
        tags = b"OpusTags" + struct.pack("<I", len(vendor)) + vendor \
            + struct.pack("<I", 0)
        self._header_sent = True
        return _page(self.serial, 0, 0, [head], bos=True) \
            + _page(self.serial, 1, 0, [tags])

    def feed(self, pcm_i16: np.ndarray) -> bytes:
        """PCM chunk → zero or more complete Ogg pages."""
        out = b"" if self._header_sent else self.header_pages()
        pcm_i16 = np.ascontiguousarray(pcm_i16, np.int16)
        cap = max(len(pcm_i16) * 2, 1 << 14)
        buf = ctypes.create_string_buffer(cap)
        n_pk = ctypes.c_int32()
        n = self._lib.bn_opus_stream_encode(
            ctypes.c_void_p(self._h),
            pcm_i16.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            len(pcm_i16), buf, cap, ctypes.byref(n_pk))
        if n < 0:
            raise RuntimeError(f"opus stream encode failed ({n})")
        packets, off = [], 0
        raw = buf.raw[:n]
        for _ in range(n_pk.value):
            (ln,) = struct.unpack_from("<I", raw, off)
            packets.append(raw[off + 4:off + 4 + ln])
            off += 4 + ln
        if not packets:
            return out
        self._granule += len(packets) * 960   # 20 ms @ 48 kHz granule units
        return out + _page(self.serial, self._next_seq(), self._granule,
                           packets)

    def _next_seq(self) -> int:
        s = self._seq
        self._seq += 1
        return s

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.bn_opus_stream_destroy(ctypes.c_void_p(self._h))
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def encode_mp3(pcm_i16: np.ndarray, rate: int, path: str | Path,
               bitrate_kbps: int = 128) -> Path:
    """int16 mono PCM → .mp3 file via dlopen'd LAME."""
    lib = native._load_codecs()
    if lib is None or not lib.bn_mp3_available():
        raise RuntimeError("libmp3lame unavailable")
    pcm_i16 = np.ascontiguousarray(pcm_i16, np.int16)
    cap = max(len(pcm_i16), 1 << 16)
    out = ctypes.create_string_buffer(cap)
    with _enc_lock:
        n = lib.bn_mp3_encode(
            pcm_i16.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            len(pcm_i16), rate, 1, bitrate_kbps, out, cap)
    if n < 0:
        raise RuntimeError(f"mp3 encode failed ({n})")
    p = Path(path)
    tmp = p.with_suffix(p.suffix + ".tmp")
    tmp.write_bytes(out.raw[:n])
    tmp.replace(p)
    return p
