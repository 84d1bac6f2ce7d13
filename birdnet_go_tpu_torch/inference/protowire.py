"""Minimal protobuf wire-format decoder/encoder (no generated code, no
protobuf runtime dependency on the hot path).

Supports the subset ONNX uses: varint (0), 64-bit (1), length-delimited
(2), 32-bit (5). Messages decode into {field_number: [raw values]} dicts;
schema knowledge lives in the caller (onnx_import.py).

A copy of ``birdnet_go_tpu/inference/protowire.py``, encoders included: the
port's replica generators (``diag/replicas.py``) write ONNX with them.
"""

from __future__ import annotations

import struct


def read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def decode_message(buf: bytes) -> dict[int, list]:
    """One pass over a serialized message → {field: [values]}.

    Values: int for varint/fixed, bytes for length-delimited (caller
    decides whether it's a string, sub-message, or packed repeated field).
    """
    fields: dict[int, list] = {}
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = read_varint(buf, pos)
        field = tag >> 3
        wire = tag & 7
        if wire == 0:
            val, pos = read_varint(buf, pos)
        elif wire == 1:
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:
            length, pos = read_varint(buf, pos)
            val = buf[pos:pos + length]
            pos += length
        elif wire == 5:
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.setdefault(field, []).append(val)
    return fields


def zigzag_decode(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def signed(v: int, bits: int = 64) -> int:
    """Interpret an unsigned varint as two's-complement."""
    if v >= 1 << (bits - 1):
        v -= 1 << bits
    return v


def decode_packed_varints(buf: bytes) -> list[int]:
    out = []
    pos = 0
    while pos < len(buf):
        v, pos = read_varint(buf, pos)
        out.append(v)
    return out


def decode_packed_floats(buf: bytes) -> list[float]:
    return list(struct.unpack(f"<{len(buf) // 4}f", buf[:len(buf) // 4 * 4]))


def decode_packed_doubles(buf: bytes) -> list[float]:
    return list(struct.unpack(f"<{len(buf) // 8}d", buf[:len(buf) // 8 * 8]))


# -- encoding (tests + checkpoint export) --------------------------------------


def encode_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def encode_tag(field: int, wire: int) -> bytes:
    return encode_varint((field << 3) | wire)


def encode_len_field(field: int, payload: bytes) -> bytes:
    return encode_tag(field, 2) + encode_varint(len(payload)) + payload


def encode_varint_field(field: int, v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    return encode_tag(field, 0) + encode_varint(v)


def encode_float_field(field: int, v: float) -> bytes:
    return encode_tag(field, 5) + struct.pack("<f", v)
