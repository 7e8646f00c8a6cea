"""A reader of the JAX package's msgpack checkpoints, pure Python and numpy
(the counterpart of ``flax.serialization.msgpack_restore``; the JAX package
writes its ``TrainState`` with ``flax.serialization.to_bytes``).

It reads the part of msgpack that flax writes: maps, arrays, str, bin,
int, float, bool and nil; ext type 1 (an ndarray: a packed ``(shape,
dtype name, C-order bytes)``) and ext type 3 (a numpy scalar, packed as a
0-d ndarray); flax's ``__msgpack_chunked_array__`` maps of arrays past
its chunk size are joined back.  ``bfloat16`` leaves are read as uint16
and widened to float32 (numpy has no bfloat16).  Any other type byte
raises ``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.pos}")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt,
                             self.take(struct.calcsize(">" + fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        scalars = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
                   0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in scalars:
            return self.unpack(scalars[b])
        sized = {0xC4: ("B", bytes), 0xC5: ("H", bytes), 0xC6: ("I", bytes),
                 0xD9: ("B", str), 0xDA: ("H", str), 0xDB: ("I", str),
                 0xDC: ("H", list), 0xDD: ("I", list),
                 0xDE: ("H", dict), 0xDF: ("I", dict)}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind is bytes:
                return bytes(self.take(n))
            if kind is str:
                return str(self.take(n), "utf-8")
            return self.array(n) if kind is list else self.map(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(self.unpack("b"), fixext[b])
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: "B", 0xC8: "H", 0xC9: "I"}[b])
            return self.ext(self.unpack("b"), n)
        raise ValueError(f"msgpack: type byte 0x{b:02x} is not read "
                         f"(at byte {self.pos - 1})")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, code: int, n: int):
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        raise ValueError(f"msgpack: ext type {code} is not read")


def _ndarray(payload: bytes) -> np.ndarray:
    """flax's ``_ndarray_from_bytes``: a packed (shape, dtype, bytes)."""
    shape, dtype, buf = _Reader(payload).value()
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    if dtype == "bfloat16":  # the high half of a float32
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(dtype)).reshape(shape)


def _unchunk(tree):
    """flax's ``_unchunk_array_leaves_in_place``, as a copy."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes):
    """Decode flax msgpack bytes into nested dicts of numpy arrays and
    Python scalars."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} bytes "
                         "after the first object")
    return _unchunk(tree)
