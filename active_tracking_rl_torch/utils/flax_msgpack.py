"""The byte format of flax's ``serialization.to_bytes`` / ``msgpack_restore``.

A small msgpack encoder and decoder, so that the port reads and writes the
JAX package's parameter files with neither flax nor the ``msgpack`` package.
It covers what those files hold: maps, str, bin, int, float, bool, nil,
arrays and flax's ndarray extension (ext type 1, the msgpack bytes of
``[shape, dtype name, C-order raw bytes]``). Maps are written with their
keys sorted, as flax writes a params tree, so ``packb`` of a tree gives the
bytes ``to_bytes`` gives. flax's chunked form for arrays over 1 GiB is not
handled.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

import numpy as np

EXT_NDARRAY = 1


def _head(out: List[bytes], n: int, fix: int, fix_max: int,
          codes: Tuple[int, int, int]) -> None:
    """A length header: the fix form below `fix_max`, else 8/16/32 bits
    (`codes`, with None where a width does not exist)."""
    if n < fix_max:
        out.append(bytes([fix | n]))
    elif codes[0] is not None and n < 1 << 8:
        out.append(struct.pack(">BB", codes[0], n))
    elif n < 1 << 16:
        out.append(struct.pack(">BH", codes[1], n))
    else:
        out.append(struct.pack(">BI", codes[2], n))


def _int(out: List[bytes], x: int) -> None:
    if 0 <= x < 0x80:
        out.append(struct.pack(">B", x))
    elif -32 <= x < 0:
        out.append(struct.pack(">b", x))
    elif x >= 0:
        for code, fmt, top in ((0xcc, ">BB", 1 << 8), (0xcd, ">BH", 1 << 16),
                               (0xce, ">BI", 1 << 32), (0xcf, ">BQ", 1 << 64)):
            if x < top:
                out.append(struct.pack(fmt, code, x))
                return
        raise OverflowError(x)
    else:
        for code, fmt, low in ((0xd0, ">Bb", -(1 << 7)),
                               (0xd1, ">Bh", -(1 << 15)),
                               (0xd2, ">Bi", -(1 << 31)),
                               (0xd3, ">Bq", -(1 << 63))):
            if x >= low:
                out.append(struct.pack(fmt, code, x))
                return
        raise OverflowError(x)


def _ext(out: List[bytes], code: int, data: bytes) -> None:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    n = len(data)
    if n in fixed:
        out.append(struct.pack(">Bb", fixed[n], code))
    elif n < 1 << 8:
        out.append(struct.pack(">BBb", 0xc7, n, code))
    elif n < 1 << 16:
        out.append(struct.pack(">BHb", 0xc8, n, code))
    else:
        out.append(struct.pack(">BIb", 0xc9, n, code))
    out.append(data)


def _ndarray_bytes(x: np.ndarray) -> bytes:
    if x.dtype.hasobject or x.dtype.fields is not None:
        raise ValueError(f"cannot serialize dtype {x.dtype}")
    return packb((tuple(x.shape), x.dtype.name, x.tobytes("C")))


def _pack(out: List[bytes], obj: Any) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.ndarray):
        _ext(out, EXT_NDARRAY, _ndarray_bytes(obj))
    elif isinstance(obj, int):
        _int(out, obj)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xcb, obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _head(out, len(data), 0xa0, 32, (0xd9, 0xda, 0xdb))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray)):
        _head(out, len(obj), 0, 0, (0xc4, 0xc5, 0xc6))
        out.append(bytes(obj))
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 16, (None, 0xdc, 0xdd))
        for x in obj:
            _pack(out, x)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 16, (None, 0xde, 0xdf))
        for k in sorted(obj):
            _pack(out, k)
            _pack(out, obj[k])
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """msgpack bytes of `obj`: a tree of dicts, lists, tuples, scalars and
    numpy arrays."""
    out: List[bytes] = []
    _pack(out, obj)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.unpack(">B")
        if b < 0x80:
            return b
        if b >= 0xe0:
            return b - 0x100
        if b & 0xf0 == 0x80:
            return self.map(b & 0x0f)
        if b & 0xf0 == 0x90:
            return self.array(b & 0x0f)
        if b & 0xe0 == 0xa0:
            return self.take(b & 0x1f).decode("utf-8")
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        ints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
                0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q",
                0xca: ">f", 0xcb: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        sizes = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I",       # bin
                 0xd9: ">B", 0xda: ">H", 0xdb: ">I",       # str
                 0xdc: ">H", 0xdd: ">I",                   # array
                 0xde: ">H", 0xdf: ">I",                   # map
                 0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}       # ext
        fixext = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        if b not in sizes:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        n = self.unpack(sizes[b])
        if b <= 0xc6:
            return self.take(n)
        if b <= 0xc9:
            return self.ext(n)
        if b <= 0xdb:
            return self.take(n).decode("utf-8")
        return self.array(n) if b <= 0xdd else self.map(n)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        data = self.take(n)
        if code != EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, raw = unpackb(data)
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()


def unpackb(data: bytes) -> Any:
    """The object that msgpack bytes hold; flax's ndarrays come back as
    numpy arrays."""
    reader = _Reader(data)
    out = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out
