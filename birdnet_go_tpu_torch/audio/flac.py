"""Native FLAC codec (lossless; fixed linear predictors + Rice coding).

Reference: internal/audiocore/flac (go-flac) — native clip export without
FFmpeg. This implements a spec-compliant FLAC stream: fLaC marker,
STREAMINFO metadata block (with MD5 of the unencoded samples), and frames
whose subframes are chosen per block for size: CONSTANT for flat blocks,
FIXED order 0-4 with partitioned-Rice residuals (the real FLAC
compression mechanism) when it wins, VERBATIM as the guaranteed fallback.
UTF-8-style frame numbering and CRC-8/CRC-16 as required. A decoder for
the same subframe set lives here too — round-trip tests verify bit-exact
reconstruction and the STREAMINFO MD5.

A copy of ``birdnet_go_tpu/audio/flac.py`` for the port;
``tests/test_torch_aux.py`` holds it to the original.
"""

from __future__ import annotations

import hashlib
import struct
from pathlib import Path

import numpy as np

_BLOCK = 4096                       # samples per frame


class _BitWriter:
    def __init__(self):
        self._out = bytearray()
        self._acc = 0
        self._nbits = 0

    def write(self, value: int, bits: int) -> None:
        self._acc = (self._acc << bits) | (value & ((1 << bits) - 1))
        self._nbits += bits
        while self._nbits >= 8:
            self._nbits -= 8
            self._out.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def write_unary(self, q: int) -> None:
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def write_bit_array(self, bits: np.ndarray) -> None:
        """Bulk-append a 0/1 uint8 array (vectorized via np.packbits)."""
        if self._nbits:
            lead = np.array([(self._acc >> (self._nbits - 1 - i)) & 1
                             for i in range(self._nbits)], np.uint8)
            bits = np.concatenate([lead, bits])
            self._acc = 0
            self._nbits = 0
        n_full = len(bits) & ~7
        if n_full:
            self._out += np.packbits(bits[:n_full]).tobytes()
        for b in bits[n_full:]:
            self.write(int(b), 1)

    def bytes_aligned(self) -> bytes:
        if self._nbits:
            pad = 8 - self._nbits
            self.write(0, pad)
        return bytes(self._out)

    def bit_length(self) -> int:
        return len(self._out) * 8 + self._nbits


class _BitReader:
    def __init__(self, data: bytes, pos_bits: int = 0):
        self.data = data
        self.pos = pos_bits

    def read(self, bits: int) -> int:
        v = 0
        for _ in range(bits):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def read_unary(self) -> int:
        q = 0
        while self.read(1) == 0:
            q += 1
        return q

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7


def _zigzag(res: np.ndarray) -> np.ndarray:
    """Signed residual → FLAC's folded unsigned coding."""
    res = res.astype(np.int64)
    return np.where(res >= 0, res << 1, (-res << 1) - 1)


def _rice_cost(u: np.ndarray, k: int) -> int:
    return int(np.sum(u >> k)) + len(u) * (k + 1)


def _best_rice_k(u: np.ndarray) -> tuple[int, int]:
    """(k, cost) minimizing the single-partition Rice size."""
    if len(u) == 0:
        return 0, 0
    mean = max(1.0, float(u.mean()))
    guess = min(14, max(0, int(np.log2(mean))))
    best_k, best_cost = 0, None
    for k in range(max(0, guess - 2), min(14, guess + 3) + 1):
        c = _rice_cost(u, k)
        if best_cost is None or c < best_cost:
            best_k, best_cost = k, c
    return best_k, best_cost


_FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


def _fixed_residual(block: np.ndarray, order: int) -> np.ndarray:
    x = block.astype(np.int64)
    r = x
    for _ in range(order):
        r = np.diff(r)
    return r                        # len = len(block) - order


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 \
                else (crc << 1) & 0xFFFF
    return crc


def _utf8_like(n: int) -> bytes:
    """FLAC frame-number coding (UTF-8-style, up to 36 bits)."""
    if n < 0x80:
        return bytes([n])
    out = []
    bits = n.bit_length()
    n_bytes = 2
    while bits > (7 - n_bytes) + 6 * (n_bytes - 1) and n_bytes < 7:
        n_bytes += 1
    payload = n
    tail = []
    for _ in range(n_bytes - 1):
        tail.append(0x80 | (payload & 0x3F))
        payload >>= 6
    lead_prefix = (0xFF << (8 - n_bytes)) & 0xFF
    out.append(lead_prefix | payload)
    out.extend(reversed(tail))
    return bytes(out)


_RATE_CODE = {88200: 0x1, 176400: 0x2, 192000: 0x3, 8000: 0x4, 16000: 0x5,
              22050: 0x6, 24000: 0x7, 32000: 0x8, 44100: 0x9, 48000: 0xA,
              96000: 0xB}


def streaminfo_block(sample_rate: int, total_samples: int,
                     md5: bytes = b"\x00" * 16) -> bytes:
    """STREAMINFO metadata block body (34 bytes, mono/16-bit)."""
    min_bs = min(_BLOCK, total_samples) if total_samples else _BLOCK
    info = struct.pack(">HH", min_bs, _BLOCK)
    info += b"\x00\x00\x00" * 2                      # unknown frame sizes
    # rate(20) | channels-1(3) | bps-1(5) | total samples(36) = 64 bits
    packed = (sample_rate << 44) | (0 << 41) | (15 << 36) | total_samples
    info += packed.to_bytes(8, "big")
    info += md5
    return info


def encode_flac_frames(samples: np.ndarray, sample_rate: int,
                       first_frame_number: int = 0) -> list[bytes]:
    """Mono int16 samples → list of raw FLAC frames (no stream header).

    Used directly by the HLS fMP4 muxer, where each frame is one MP4
    sample (RFC 9639 ISO-BMFF encapsulation)."""
    samples = np.asarray(samples, np.int16)
    n = len(samples)
    frames = []
    rate_code = _RATE_CODE.get(sample_rate)
    for i, start in enumerate(range(0, n, _BLOCK)):
        fi = first_frame_number + i
        block = samples[start:start + _BLOCK]
        bs = len(block)
        # frame header: sync(14)=0x3FFE, reserved, blocking=fixed(0)
        hdr = bytearray(b"\xff\xf8")
        if bs == _BLOCK:
            bs_code, bs_extra = 0xC, b""                 # 4096
        else:
            bs_code, bs_extra = 0x7, struct.pack(">H", bs - 1)  # 16-bit end
        if rate_code is not None:
            sr_code, sr_extra = rate_code, b""
        elif sample_rate < 65536:
            sr_code, sr_extra = 0xD, struct.pack(">H", sample_rate)  # Hz
        else:
            sr_code, sr_extra = 0xE, struct.pack(">H", sample_rate // 10)
        hdr.append((bs_code << 4) | sr_code)
        # channels=mono(0), sample size=16 (code 0b100), reserved 0
        hdr.append((0x0 << 4) | (0b100 << 1))
        hdr += _utf8_like(fi)
        hdr += bs_extra + sr_extra
        hdr.append(_crc8(bytes(hdr)))
        body = bytearray(hdr)
        body += _encode_subframe(block)
        body += struct.pack(">H", _crc16(bytes(body)))
        frames.append(bytes(body))
    return frames


def encode_flac(samples: np.ndarray, sample_rate: int) -> bytes:
    """Mono int16 samples → complete FLAC stream bytes."""
    samples = np.asarray(samples, np.int16)
    md5 = hashlib.md5(samples.astype("<i2").tobytes()).digest()
    info = streaminfo_block(sample_rate, len(samples), md5)
    header = b"fLaC" + bytes([0x80, 0, 0, len(info)]) + info
    return header + b"".join(encode_flac_frames(samples, sample_rate))


def _encode_subframe(block: np.ndarray) -> bytes:
    """Pick the smallest of CONSTANT / FIXED(0-4)+Rice / VERBATIM."""
    bs = len(block)
    if bs and np.all(block == block[0]):
        w = _BitWriter()
        w.write(0b000000 << 1, 8)                        # CONSTANT
        w.write(int(block[0]) & 0xFFFF, 16)
        return w.bytes_aligned()

    best = None                      # (cost_bits, order, k, residual)
    for order in range(0, 5):
        if order >= bs:
            break
        res = _fixed_residual(block, order)
        u = _zigzag(res)
        k, cost = _best_rice_k(u)
        total = 8 + order * 16 + 2 + 4 + 4 + cost
        if best is None or total < best[0]:
            best = (total, order, k, u)

    verbatim_bits = 8 + bs * 16
    if best is None or best[0] >= verbatim_bits:
        # VERBATIM stays byte-aligned after the 1-byte subframe header
        return bytes([0b000001 << 1]) + block.astype(">i2").tobytes()

    _, order, k, u = best
    w = _BitWriter()
    w.write((0b001000 | order) << 1, 8)                  # FIXED, order
    for s in block[:order]:                              # warmup samples
        w.write(int(s) & 0xFFFF, 16)
    w.write(0b00, 2)                                     # 4-bit Rice params
    w.write(0, 4)                                        # partition order 0
    w.write(k, 4)
    # vectorized Rice coding: unary quotient + k-bit remainder per value
    q = (u >> k).astype(np.int64)
    lengths = q + 1 + k
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    bits = np.zeros(int(lengths.sum()), np.uint8)
    bits[starts + q] = 1                                 # unary terminator
    if k:
        rem = (u & ((1 << k) - 1)).astype(np.int64)
        pos = (starts + q + 1)[:, None] + np.arange(k)
        vals = (rem[:, None] >> np.arange(k - 1, -1, -1)) & 1
        bits[pos.ravel()] = vals.ravel().astype(np.uint8)
    w.write_bit_array(bits)
    return w.bytes_aligned()


# ---------------------------------------------------------------- decoder

def decode_flac(data: bytes) -> tuple[np.ndarray, int]:
    """Decode a mono FLAC stream produced by encode_flac (CONSTANT /
    VERBATIM / FIXED subframes) → (int16 samples, sample_rate). Verifies
    frame CRCs and the STREAMINFO MD5."""
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    pos = 4
    info = None
    while True:
        hdr = data[pos:pos + 4]
        last = hdr[0] & 0x80
        btype = hdr[0] & 0x7F
        size = int.from_bytes(hdr[1:4], "big")
        body = data[pos + 4:pos + 4 + size]
        if btype == 0:
            info = body
        pos += 4 + size
        if last:
            break
    if info is None:
        raise ValueError("missing STREAMINFO")
    packed = int.from_bytes(info[10:18], "big")
    sample_rate = packed >> 44
    total = packed & ((1 << 36) - 1)
    md5_expected = info[18:34]

    out = np.zeros(total, np.int16)
    filled = 0
    while filled < total and pos < len(data):
        frame_start = pos
        if data[pos] != 0xFF or (data[pos + 1] & 0xFC) != 0xF8:
            raise ValueError(f"bad frame sync at {pos}")
        bs_code = data[pos + 2] >> 4
        sr_code = data[pos + 2] & 0xF
        pos += 4                                 # sync+codes+chan/bps byte
        # UTF-8-like frame number
        first = data[pos]
        pos += 1
        if first >= 0x80:
            n_cont = 8 - (~first & 0xFF).bit_length() - 1
            pos += n_cont
        if bs_code == 0x6:
            bs = data[pos] + 1
            pos += 1
        elif bs_code == 0x7:
            bs = struct.unpack(">H", data[pos:pos + 2])[0] + 1
            pos += 2
        elif bs_code == 0xC:
            bs = 4096
        elif 0x8 <= bs_code <= 0xF:
            bs = 256 << (bs_code - 8)
        elif 0x2 <= bs_code <= 0x5:
            bs = 576 << (bs_code - 2)
        else:
            bs = 192
        if sr_code == 0xC:
            pos += 1
        elif sr_code in (0xD, 0xE):
            pos += 2
        pos += 1                                 # CRC-8 (verified below)
        if _crc8(data[frame_start:pos - 1]) != data[pos - 1]:
            raise ValueError("frame header CRC mismatch")

        r = _BitReader(data, pos * 8)
        stype = (r.read(8) >> 1) & 0x3F
        block = np.zeros(bs, np.int64)
        if stype == 0:                           # CONSTANT
            v = r.read(16)
            if v >= 1 << 15:
                v -= 1 << 16
            block[:] = v
        elif stype == 1:                         # VERBATIM
            for i in range(bs):
                v = r.read(16)
                block[i] = v - (1 << 16) if v >= 1 << 15 else v
        elif 8 <= stype <= 12:                   # FIXED order 0-4
            order = stype - 8
            for i in range(order):
                v = r.read(16)
                block[i] = v - (1 << 16) if v >= 1 << 15 else v
            method = r.read(2)
            if method != 0:
                raise ValueError("unsupported residual method")
            part_order = r.read(4)
            n_res = bs - order
            res = np.zeros(n_res, np.int64)
            idx = 0
            for p in range(1 << part_order):
                k = r.read(4)
                count = (bs >> part_order) - (order if p == 0 else 0)
                for _ in range(count):
                    q = r.read_unary()
                    v = (q << k) | (r.read(k) if k else 0)
                    res[idx] = (v >> 1) if (v & 1) == 0 else -((v + 1) >> 1)
                    idx += 1
            # Integrate the fixed predictor `order` times. diff^k warmups
            # derive from the x warmups; each integration level k-1 is
            # cumsum([level_{k-1}[0], level_k...]).
            if order == 0:
                block[:] = res
            else:
                levels = [block[:order].copy()]
                for _ in range(1, order):
                    levels.append(np.diff(levels[-1]))
                seq = res
                for k in range(order, 0, -1):
                    head = levels[k - 1][:1]
                    seq = np.cumsum(np.concatenate([head, seq]))
                block[:] = seq
        else:
            raise ValueError(f"unsupported subframe type {stype}")
        r.align()
        pos = r.pos >> 3
        crc = struct.unpack(">H", data[pos:pos + 2])[0]
        if _crc16(data[frame_start:pos]) != crc:
            raise ValueError("frame CRC-16 mismatch")
        pos += 2
        out[filled:filled + bs] = block[:bs].astype(np.int16)
        filled += bs

    # all-zero MD5 = "unset" per spec (the HLS muxer's per-segment wrap)
    if md5_expected != b"\x00" * 16 and \
            hashlib.md5(out.astype("<i2").tobytes()).digest() != md5_expected:
        raise ValueError("decoded MD5 mismatch")
    return out, sample_rate


def write_flac(path: str | Path, samples: np.ndarray,
               sample_rate: int) -> Path:
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(encode_flac(samples, sample_rate))
    tmp.rename(path)
    return path
