"""Native AAC-LC: streaming encoder, ADTS framing, and M4A (MP4) muxing.

Reference: internal/audiocore/aac/encode.go (pure-Go AAC-LC encoder) and
hlsmux/codec_aac.go (AAC fMP4 HLS). Here encoding runs through the
dlopen'd system libavcodec in csrc/codecs.cpp (bn_aac_stream_*) — the
same graceful-absence contract as Opus/MP3: when the library is missing,
available() is False and callers fall back to FLAC.

The container layer is pure Python:
  - adts_bytes(): raw .aac ADTS stream (one 7-byte header per packet);
  - write_m4a()/read_m4a(): progressive MP4 with a real sample table
    (mp4a + esds carrying the encoder's AudioSpecificConfig);
  - decode_aac(): round-trip oracle via the libavcodec decoder.

A copy of ``birdnet_go_tpu/audio/aacenc.py`` for the port, which imports
nothing of the JAX package, bound to the port's codec library
(``native/lib.py`` ``_load_codecs``). Its AAC part reaches libavcodec
without FFmpeg's headers (``csrc/codecs.cpp``): the AudioSpecificConfig is
built from the rate index and the channel count as FFmpeg's encoder writes
it, the priming is the encoder's 1024 samples, and the decoder reads ADTS
frames. ``tests/test_torch_codecs.py`` holds the packets, the ASC, the
decoded PCM and the containers to the original, byte for byte.
"""

from __future__ import annotations

import ctypes
import struct
from pathlib import Path

import numpy as np

from birdnet_go_tpu_torch.native import lib as native

AAC_FRAME_SAMPLES = 1024

# ADTS / AudioSpecificConfig sampling-frequency index (ISO 14496-3 §1.6.3.4)
_FREQ_INDEX = {96000: 0, 88200: 1, 64000: 2, 48000: 3, 44100: 4, 32000: 5,
               24000: 6, 22050: 7, 16000: 8, 12000: 9, 11025: 10, 8000: 11,
               7350: 12}


def supported_rate(rate: int) -> bool:
    return rate in _FREQ_INDEX


def available() -> bool:
    lib = native._load_codecs()
    return (lib is not None and hasattr(lib, "bn_aac_available")
            and bool(lib.bn_aac_available()))


def _split_packets(buf: bytes) -> list[bytes]:
    out = []
    off = 0
    while off + 4 <= len(buf):
        n = int.from_bytes(buf[off:off + 4], "little")
        off += 4
        out.append(buf[off:off + n])
        off += n
    return out


class AacStreamEncoder:
    """Persistent AAC-LC encoder: partial 1024-sample frames carry over
    across feed() calls, so live HLS segments join without encoder resets
    (same contract as the streaming Opus handle)."""

    def __init__(self, sample_rate: int, channels: int = 1,
                 bitrate: int = 96000):
        if not supported_rate(sample_rate):
            raise ValueError(f"AAC does not support {sample_rate} Hz")
        lib = native._load_codecs()
        if lib is None or not hasattr(lib, "bn_aac_stream_create") \
                or not lib.bn_aac_available():
            raise RuntimeError("native AAC encoder unavailable")
        self._lib = lib
        self.sample_rate = sample_rate
        self.channels = channels
        asc = ctypes.create_string_buffer(64)
        asc_len = ctypes.c_int32(0)
        self._h = lib.bn_aac_stream_create(sample_rate, channels, bitrate,
                                           asc, 64, ctypes.byref(asc_len))
        if not self._h:
            raise RuntimeError("bn_aac_stream_create failed")
        self.asc = asc.raw[:asc_len.value]
        # encoder priming delay in samples — MP4 edit lists trim it
        self.priming = int(lib.bn_aac_stream_delay(self._h)) \
            if hasattr(lib, "bn_aac_stream_delay") else 0
        if self.priming <= 0:
            self.priming = AAC_FRAME_SAMPLES
        self._out = ctypes.create_string_buffer(1 << 20)
        # chunk seconds sized so ONE chunk's output can never overflow
        # the packet buffer at the CONFIGURED bitrate (overflow loses the
        # drained packet irrecoverably inside the encoder): budget half
        # the buffer per chunk, bitrate/8 bytes per second + headroom
        safe_s = (len(self._out) / 2) / (max(bitrate, 8000) / 8 * 1.5)
        self._chunk_s = max(1.0, min(30.0, safe_s))

    def feed(self, pcm_i16: np.ndarray) -> list[bytes]:
        pcm = np.ascontiguousarray(pcm_i16, np.int16)
        packets: list[bytes] = []
        step = int(self.sample_rate * self._chunk_s) * self.channels
        for off in range(0, max(len(pcm), 1), step):
            chunk = pcm[off:off + step]
            if not len(chunk) and off:
                break
            npk = ctypes.c_int32(0)
            w = self._lib.bn_aac_stream_encode(
                self._h, native._i16_ptr(chunk),
                len(chunk) // self.channels,
                self._out, len(self._out), ctypes.byref(npk))
            if w < 0:
                raise RuntimeError(f"AAC encode failed ({w})")
            packets.extend(_split_packets(self._out.raw[:w]))
        return packets

    def flush(self) -> list[bytes]:
        npk = ctypes.c_int32(0)
        w = self._lib.bn_aac_stream_flush(self._h, self._out,
                                          len(self._out), ctypes.byref(npk))
        if w < 0:
            raise RuntimeError(f"AAC flush failed ({w})")
        return _split_packets(self._out.raw[:w])

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.bn_aac_stream_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def encode_aac(pcm_i16: np.ndarray, sample_rate: int, channels: int = 1,
               bitrate: int = 96000) -> tuple[list[bytes], bytes]:
    """One-shot encode → (raw AAC packets, AudioSpecificConfig)."""
    packets, asc, _ = encode_aac_with_priming(pcm_i16, sample_rate,
                                              channels, bitrate)
    return packets, asc


def encode_aac_with_priming(pcm_i16: np.ndarray, sample_rate: int,
                            channels: int = 1, bitrate: int = 96000
                            ) -> tuple[list[bytes], bytes, int]:
    """One-shot encode → (packets, ASC, encoder priming samples)."""
    enc = AacStreamEncoder(sample_rate, channels, bitrate)
    try:
        packets = enc.feed(pcm_i16) + enc.flush()
        return packets, enc.asc, enc.priming
    finally:
        enc.close()


def decode_aac(packets: list[bytes], asc: bytes, sample_rate: int,
               channels: int = 1) -> np.ndarray:
    """Round-trip oracle: raw packets + ASC → interleaved int16 PCM
    (includes the codec's priming delay at the head)."""
    lib = native._load_codecs()
    if lib is None or not lib.bn_aac_available():
        raise RuntimeError("native AAC decoder unavailable")
    blob = b"".join(struct.pack("<I", len(p)) + p for p in packets)
    cap = (len(packets) + 4) * AAC_FRAME_SAMPLES * channels
    out = np.zeros(cap, np.int16)
    n = lib.bn_aac_decode(blob, len(blob), asc, len(asc), sample_rate,
                          channels, native._i16_ptr(out), cap // channels)
    if n < 0:
        raise RuntimeError(f"AAC decode failed ({n})")
    return out[:n * channels]


# ------------------------------------------------------------------- ADTS

def adts_bytes(packets: list[bytes], sample_rate: int,
               channels: int = 1) -> bytes:
    """Raw .aac stream: 7-byte ADTS header (no CRC) per packet."""
    fi = _FREQ_INDEX[sample_rate]
    out = bytearray()
    for p in packets:
        ln = len(p) + 7
        hdr = bytes([
            0xFF, 0xF1,                                   # sync, MPEG-4, no CRC
            # profile LC (AOT 2 → 1), freq index, channel cfg high bit
            (1 << 6) | (fi << 2) | ((channels >> 2) & 1),
            ((channels & 3) << 6) | ((ln >> 11) & 0x3),
            (ln >> 3) & 0xFF,
            ((ln & 0x7) << 5) | 0x1F,                     # fullness=0x7FF
            0xFC,                                         # 1 AAC frame
        ])
        out += hdr + p
    return bytes(out)


def parse_adts(data: bytes) -> list[bytes]:
    """Split an ADTS stream back into raw AAC packets (test oracle)."""
    out = []
    off = 0
    while off + 7 <= len(data):
        if data[off] != 0xFF or (data[off + 1] & 0xF0) != 0xF0:
            break
        ln = ((data[off + 3] & 0x3) << 11) | (data[off + 4] << 3) \
            | (data[off + 5] >> 5)
        crc = 0 if (data[off + 1] & 1) else 2
        out.append(data[off + 7 + crc:off + ln])
        off += ln
    return out


# ------------------------------------------------------------------- M4A

def _esds(asc: bytes, bitrate: int = 96000) -> bytes:
    from birdnet_go_tpu_torch.audio.hlsmux import full_box

    dsi = bytes([0x05, len(asc)]) + asc                  # DecoderSpecificInfo
    dcd = bytes([0x04, 13 + len(dsi),
                 0x40,                                    # OTI: MPEG-4 audio
                 0x15,                                    # audio stream
                 0, 0, 0]) \
        + struct.pack(">II", bitrate, bitrate) + dsi      # max/avg bitrate
    sl = bytes([0x06, 0x01, 0x02])                        # SLConfig: MP4
    es = bytes([0x03, 3 + len(dcd) + len(sl)]) \
        + struct.pack(">HB", 0, 0) + dcd + sl             # ES_ID 0
    return full_box(b"esds", 0, 0, es)


def mp4a_entry(asc: bytes, sample_rate: int, channels: int = 1,
               bitrate: int = 96000) -> bytes:
    from birdnet_go_tpu_torch.audio.hlsmux import box

    entry_rate = min(sample_rate, 0xFFFF)
    return box(b"mp4a",
               b"\x00" * 6 + struct.pack(">H", 1)         # data ref idx
               + b"\x00" * 8
               + struct.pack(">HH", channels, 16)
               + b"\x00" * 4
               + struct.pack(">I", entry_rate << 16)
               + _esds(asc, bitrate))


def write_m4a(path: str | Path, packets: list[bytes], asc: bytes,
              sample_rate: int, channels: int = 1,
              bitrate: int = 96000, priming: int = 0) -> Path:
    """Progressive MP4 (.m4a): ftyp + moov (full sample table) + mdat.
    Every sample is one AAC frame of 1024 samples at mdhd timescale ==
    sample_rate, so players derive exact duration. `priming` (the
    encoder delay in samples) is trimmed via an edit list so playback
    starts at the real audio, not the codec warm-up."""
    from birdnet_go_tpu_torch.audio.hlsmux import _unity_matrix, box, full_box

    n = len(packets)
    duration = n * AAC_FRAME_SAMPLES
    presented = max(duration - priming, 0)
    ftyp = box(b"ftyp", b"M4A " + struct.pack(">I", 512)
               + b"M4A isomiso2mp42")
    stsd = full_box(b"stsd", 0, 0, struct.pack(">I", 1)
                    + mp4a_entry(asc, sample_rate, channels, bitrate))
    stts = full_box(b"stts", 0, 0,
                    struct.pack(">III", 1, n, AAC_FRAME_SAMPLES))
    stsc = full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))
    stsz = full_box(b"stsz", 0, 0, struct.pack(">II", 0, n)
                    + b"".join(struct.pack(">I", len(p)) for p in packets))
    # edit list: skip the priming samples (media_time = priming) for the
    # presented duration — the standard MP4 encoder-delay mechanism
    edts = b""
    if priming > 0:
        elst = full_box(b"elst", 0, 0,
                        struct.pack(">I", 1)
                        + struct.pack(">IiHH", presented, priming, 1, 0))
        edts = box(b"edts", elst)

    def build_moov(chunk_offset: int) -> bytes:
        stco = full_box(b"stco", 0, 0, struct.pack(">II", 1, chunk_offset))
        stbl = box(b"stbl", stsd + stts + stsc + stsz + stco)
        url_ = full_box(b"url ", 0, 1, b"")
        dref = full_box(b"dref", 0, 0, struct.pack(">I", 1) + url_)
        dinf = box(b"dinf", dref)
        smhd = full_box(b"smhd", 0, 0, struct.pack(">HH", 0, 0))
        minf = box(b"minf", smhd + dinf + stbl)
        hdlr = full_box(b"hdlr", 0, 0, b"\x00" * 4 + b"soun" + b"\x00" * 12
                        + b"SoundHandler\x00")
        mdhd = full_box(b"mdhd", 0, 0,
                        struct.pack(">IIII", 0, 0, sample_rate, duration)
                        + struct.pack(">HH", 0x55C4, 0))
        mdia = box(b"mdia", mdhd + hdlr + minf)
        tkhd = full_box(b"tkhd", 0, 7,
                        struct.pack(">IIII", 0, 0, 1, 0)
                        + struct.pack(">I", presented if priming else
                                      duration)
                        + b"\x00" * 8
                        + struct.pack(">HHHH", 0, 0, 0x0100, 0)
                        + _unity_matrix() + struct.pack(">II", 0, 0))
        trak = box(b"trak", tkhd + edts + mdia)
        mvhd = full_box(b"mvhd", 0, 0,
                        struct.pack(">IIII", 0, 0, sample_rate,
                                    presented if priming else duration)
                        + struct.pack(">I", 0x00010000)
                        + struct.pack(">H", 0x0100)
                        + b"\x00" * 10 + _unity_matrix()
                        + b"\x00" * 24 + struct.pack(">I", 2))
        return box(b"moov", mvhd + trak)

    moov_size = len(build_moov(0))
    mdat_payload_off = len(ftyp) + moov_size + 8
    moov = build_moov(mdat_payload_off)
    assert len(moov) == moov_size
    mdat = box(b"mdat", b"".join(packets))
    out = Path(path)
    tmp = out.with_name(out.name + ".tmp")
    tmp.write_bytes(ftyp + moov + mdat)
    tmp.rename(out)
    return out


def _desc_len(buf: bytes, i: int) -> tuple[int, int]:
    """ISO 14496-1 expandable length (0x80-continuation bytes — ffmpeg
    writes these; our own writer uses the single-byte form)."""
    ln = 0
    for _ in range(4):
        b = buf[i]
        i += 1
        ln = (ln << 7) | (b & 0x7F)
        if not b & 0x80:
            break
    return ln, i


def read_m4a(path: str | Path
             ) -> tuple[list[bytes], bytes, int, int]:
    """Parse an .m4a → (packets, asc, sample_rate, priming_samples).

    A general progressive-MP4 reader, not just an inverse of write_m4a:
    chunk offsets come from the real stsc/stco walk (absolute file
    offsets), esds descriptor lengths use the expandable encoding, and
    the edit list's media_time yields the encoder priming — so
    ffmpeg-written fallback clips parse too, not only our own."""
    data = Path(path).read_bytes()

    def children(buf: bytes):
        off = 0
        while off + 8 <= len(buf):
            size = struct.unpack(">I", buf[off:off + 4])[0]
            if size < 8:
                break
            kind = buf[off + 4:off + 8]
            yield kind, buf[off + 8:off + size]
            off += size

    top = dict(children(data))
    moov = dict(children(top[b"moov"]))
    trak = dict(children(moov[b"trak"]))
    mdia = dict(children(trak[b"mdia"]))
    rate = struct.unpack(">I", mdia[b"mdhd"][4 + 8:4 + 12])[0]
    priming = 0
    if b"edts" in trak:
        elst = dict(children(trak[b"edts"]))[b"elst"]
        version = elst[0]
        count = struct.unpack(">I", elst[4:8])[0]
        if count >= 1:
            if version == 1:
                mt = struct.unpack(">q", elst[16:24])[0]
            else:
                mt = struct.unpack(">i", elst[12:16])[0]
            priming = max(int(mt), 0)
    stbl = dict(children(dict(children(mdia[b"minf"]))[b"stbl"]))
    stsz = stbl[b"stsz"][4:]
    fixed, count = struct.unpack(">II", stsz[:8])
    sizes = ([fixed] * count if fixed
             else list(struct.unpack(f">{count}I",
                                     stsz[8:8 + 4 * count])))
    # chunk layout: stsc patterns (first_chunk, samples_per_chunk) over
    # stco/co64 absolute offsets
    stsc = stbl[b"stsc"][4:]
    n_stsc = struct.unpack(">I", stsc[:4])[0]
    patterns = [struct.unpack(">III", stsc[4 + 12 * i:16 + 12 * i])
                for i in range(n_stsc)]
    if b"stco" in stbl:
        stco = stbl[b"stco"][4:]
        n_chunks = struct.unpack(">I", stco[:4])[0]
        offsets = struct.unpack(f">{n_chunks}I", stco[4:4 + 4 * n_chunks])
    else:
        co64 = stbl[b"co64"][4:]
        n_chunks = struct.unpack(">I", co64[:4])[0]
        offsets = struct.unpack(f">{n_chunks}Q", co64[4:4 + 8 * n_chunks])
    # samples-per-chunk for every chunk from the stsc run-length patterns
    spc = []
    for i, (first, per, _) in enumerate(patterns):
        last = patterns[i + 1][0] if i + 1 < len(patterns) \
            else n_chunks + 1
        spc += [per] * (last - first)
    packets = []
    si = 0
    for ci, chunk_off in enumerate(offsets):
        off = int(chunk_off)
        for _ in range(spc[ci] if ci < len(spc) else 0):
            if si >= len(sizes):
                break
            packets.append(data[off:off + sizes[si]])
            off += sizes[si]
            si += 1
    # esds → AudioSpecificConfig
    stsd = stbl[b"stsd"][4 + 4:]
    mp4a = dict(children(stsd))[b"mp4a"]
    esds = dict(children(mp4a[28:]))[b"esds"][4:]
    i = 0
    asc = b""
    while i < len(esds):
        tag = esds[i]
        ln, j = _desc_len(esds, i + 1)
        if tag == 0x03:
            i = j + 3                      # ES_ID(2) + flags(1)
        elif tag == 0x04:
            i = j + 13                     # DecoderConfigDescriptor body
        elif tag == 0x05:
            asc = esds[j:j + ln]
            break
        else:
            i = j + ln
    return packets, asc, rate, priming
