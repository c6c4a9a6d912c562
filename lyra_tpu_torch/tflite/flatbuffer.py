"""Minimal generic FlatBuffers reader — the port's copy of
lyra_tpu/tflite/flatbuffer.py (the accessors its TFLite parser uses).

Just enough of the FlatBuffers binary format to read TFLite model files
without depending on TensorFlow or generated schema bindings.  The format:

* offset 0: uint32 offset to the root table (plus optional file identifier).
* table: int32 at table position P gives P - soffset = vtable position.
* vtable: uint16 vtable_size, uint16 table_size, then uint16 field offsets
  relative to P (0 == field absent).
* reference fields (string / table / vector) store a uint32 offset relative
  to the field's own location.
* vector: uint32 length followed by elements; string: uint32 length + bytes.
"""

from __future__ import annotations

import struct

import numpy as np

_u8 = struct.Struct("<B")
_i8 = struct.Struct("<b")
_u16 = struct.Struct("<H")
_i32 = struct.Struct("<i")
_u32 = struct.Struct("<I")
_f32 = struct.Struct("<f")


class Table:
    """A lazily-decoded flatbuffer table at position `pos` in `buf`."""

    __slots__ = ("buf", "pos", "_vtable", "_vtable_len")

    def __init__(self, buf: memoryview, pos: int):
        self.buf = buf
        self.pos = pos
        vtable = pos - _i32.unpack_from(buf, pos)[0]
        self._vtable = vtable
        self._vtable_len = _u16.unpack_from(buf, vtable)[0]

    def _field_offset(self, field_id: int) -> int:
        """Absolute position of field's data, or 0 if absent."""
        vt_off = 4 + 2 * field_id
        if vt_off >= self._vtable_len:
            return 0
        rel = _u16.unpack_from(self.buf, self._vtable + vt_off)[0]
        return self.pos + rel if rel else 0

    def _scalar(self, field_id: int, st: struct.Struct, default):
        off = self._field_offset(field_id)
        return st.unpack_from(self.buf, off)[0] if off else default

    def i8(self, f, default=0):
        return self._scalar(f, _i8, default)

    def bool_(self, f, default=False):
        return bool(self._scalar(f, _u8, int(default)))

    def i32(self, f, default=0):
        return self._scalar(f, _i32, default)

    def u32(self, f, default=0):
        return self._scalar(f, _u32, default)

    def f32(self, f, default=0.0):
        return self._scalar(f, _f32, default)

    def _indirect(self, off: int) -> int:
        return off + _u32.unpack_from(self.buf, off)[0]

    def string(self, f, default=None):
        off = self._field_offset(f)
        if not off:
            return default
        p = self._indirect(off)
        n = _u32.unpack_from(self.buf, p)[0]
        return bytes(self.buf[p + 4 : p + 4 + n]).decode("utf-8")

    def table(self, f):
        off = self._field_offset(f)
        if not off:
            return None
        return Table(self.buf, self._indirect(off))

    def _vector_pos(self, f):
        off = self._field_offset(f)
        if not off:
            return None, 0
        p = self._indirect(off)
        n = _u32.unpack_from(self.buf, p)[0]
        return p + 4, n

    def scalar_vector(self, f, dtype) -> np.ndarray:
        """Vector of scalars as a numpy array (zero-copy view of the buffer)."""
        p, n = self._vector_pos(f)
        if p is None:
            return np.empty(0, dtype=dtype)
        dt = np.dtype(dtype).newbyteorder("<")
        return np.frombuffer(self.buf, dtype=dt, count=n, offset=p)

    def table_vector(self, f):
        p, n = self._vector_pos(f)
        if p is None:
            return []
        out = []
        for i in range(n):
            loc = p + 4 * i
            out.append(Table(self.buf, loc + _u32.unpack_from(self.buf, loc)[0]))
        return out

    def bytes_vector(self, f) -> bytes:
        p, n = self._vector_pos(f)
        if p is None:
            return b""
        return bytes(self.buf[p : p + n])


def root(data: bytes) -> Table:
    buf = memoryview(data)
    return Table(buf, _u32.unpack_from(buf, 0)[0])


def file_identifier(data: bytes) -> str:
    return bytes(data[4:8]).decode("ascii", errors="replace")
