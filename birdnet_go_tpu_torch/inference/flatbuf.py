"""Minimal FlatBuffers wire-format reader (no generated code).

A copy of ``birdnet_go_tpu/inference/flatbuf.py``: the port cannot import
``birdnet_go_tpu.inference``, whose ``__init__`` imports the JAX backend.

Implements just enough of the FlatBuffers binary format to navigate a
.tflite model: root table, vtables, scalar/offset fields, vectors, strings,
and struct-less nested tables. Field numbering follows the public TFLite
schema (tensorflow/lite/schema/schema.fbs).

Wire format essentials:
- file starts with a uoffset32 to the root table (+ optional file id);
- a table starts with a soffset32 to its vtable; vtable = [vtable_bytes,
  table_bytes, field_offset_0, field_offset_1, ...] as uint16s, where a
  zero field offset means "absent";
- vectors are [length:uint32][elements...]; strings are vectors of bytes.
"""

from __future__ import annotations

import struct


class Table:
    """A table at absolute position `pos` within `buf`."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int):
        self.buf = buf
        self.pos = pos

    # -- low-level ----------------------------------------------------------

    def _u16(self, off: int) -> int:
        return struct.unpack_from("<H", self.buf, off)[0]

    def _i32(self, off: int) -> int:
        return struct.unpack_from("<i", self.buf, off)[0]

    def _u32(self, off: int) -> int:
        return struct.unpack_from("<I", self.buf, off)[0]

    def _field_pos(self, field_id: int) -> int | None:
        """Absolute position of field `field_id`, or None if absent."""
        vtable = self.pos - self._i32(self.pos)
        vtable_len = self._u16(vtable)
        entry = 4 + 2 * field_id
        if entry + 2 > vtable_len:
            return None
        rel = self._u16(vtable + entry)
        if rel == 0:
            return None
        return self.pos + rel

    # -- scalar fields --------------------------------------------------------

    def get_scalar(self, field_id: int, fmt: str, default=0):
        p = self._field_pos(field_id)
        if p is None:
            return default
        return struct.unpack_from(fmt, self.buf, p)[0]

    def get_int(self, field_id: int, default: int = 0) -> int:
        return self.get_scalar(field_id, "<i", default)

    def get_uint(self, field_id: int, default: int = 0) -> int:
        return self.get_scalar(field_id, "<I", default)

    def get_byte(self, field_id: int, default: int = 0) -> int:
        return self.get_scalar(field_id, "<b", default)

    def get_float(self, field_id: int, default: float = 0.0) -> float:
        return self.get_scalar(field_id, "<f", default)

    def get_bool(self, field_id: int, default: bool = False) -> bool:
        return bool(self.get_scalar(field_id, "<B", int(default)))

    # -- offset fields ---------------------------------------------------------

    def _indirect(self, p: int) -> int:
        return p + self._u32(p)

    def get_table(self, field_id: int) -> "Table | None":
        p = self._field_pos(field_id)
        if p is None:
            return None
        return Table(self.buf, self._indirect(p))

    def get_string(self, field_id: int) -> str | None:
        p = self._field_pos(field_id)
        if p is None:
            return None
        vp = self._indirect(p)
        n = self._u32(vp)
        return self.buf[vp + 4:vp + 4 + n].decode("utf-8")

    def _vector(self, field_id: int) -> tuple[int, int] | None:
        """(elements_pos, length) of a vector field."""
        p = self._field_pos(field_id)
        if p is None:
            return None
        vp = self._indirect(p)
        return vp + 4, self._u32(vp)

    def get_int_vector(self, field_id: int, fmt: str = "<i",
                       size: int = 4) -> list[int]:
        v = self._vector(field_id)
        if v is None:
            return []
        pos, n = v
        return [struct.unpack_from(fmt, self.buf, pos + i * size)[0]
                for i in range(n)]

    def get_float_vector(self, field_id: int) -> list[float]:
        return self.get_int_vector(field_id, "<f", 4)

    def get_table_vector(self, field_id: int) -> list["Table"]:
        v = self._vector(field_id)
        if v is None:
            return []
        pos, n = v
        return [Table(self.buf, self._indirect(pos + i * 4))
                for i in range(n)]

    def get_bytes_vector(self, field_id: int) -> bytes:
        """A [ubyte] vector field as raw bytes."""
        v = self._vector(field_id)
        if v is None:
            return b""
        pos, n = v
        return self.buf[pos:pos + n]


def root_table(buf: bytes) -> Table:
    (root_off,) = struct.unpack_from("<I", buf, 0)
    return Table(buf, root_off)
