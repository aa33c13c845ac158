"""The MessagePack subset a checkpoint manifest holds: maps, arrays,
str, bytes, int, bool, None and float.

``packb`` gives the bytes ``msgpack.packb`` gives for these values (its
defaults: str as the str family, bytes as bin, floats as float 64, each
int in the smallest form); ``unpackb`` reads them back, and float 32
too.  The port carries its own codec so that reading and writing the
reference's ``manifest.msgpack`` needs no package beyond numpy and
torch.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple


def _len_head(n: int, fix: int, fix_max: int, heads) -> bytes:
    if n <= fix_max:
        return bytes([fix | n])
    for code, fmt, lim in heads:
        if n < lim:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} too large for msgpack")


_STR = ((0xd9, ">B", 1 << 8), (0xda, ">H", 1 << 16), (0xdb, ">I", 1 << 32))
_BIN = ((0xc4, ">B", 1 << 8), (0xc5, ">H", 1 << 16), (0xc6, ">I", 1 << 32))
_ARR = ((0xdc, ">H", 1 << 16), (0xdd, ">I", 1 << 32))
_MAP = ((0xde, ">H", 1 << 16), (0xdf, ">I", 1 << 32))


def _int(n: int) -> bytes:
    if n < -(1 << 5):
        for code, fmt, lim in ((0xd0, ">b", 1 << 7), (0xd1, ">h", 1 << 15),
                               (0xd2, ">i", 1 << 31), (0xd3, ">q", 1 << 63)):
            if n >= -lim:
                return bytes([code]) + struct.pack(fmt, n)
        raise OverflowError(f"int {n} too small for msgpack")
    if n < (1 << 7):
        return struct.pack(">b", n)
    for code, fmt, lim in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                           (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
        if n < lim:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"int {n} too large for msgpack")


def _pack(obj: Any, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(int(obj)))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_len_head(len(raw), 0xa0, 31, _STR) + raw)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(_len_head(len(obj), 0, -1, _BIN) + bytes(obj))
    elif isinstance(obj, (list, tuple)):
        out.append(_len_head(len(obj), 0x90, 15, _ARR))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_len_head(len(obj), 0x80, 15, _MAP))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    out: list = []
    _pack(obj, out)
    return b"".join(out)


_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
          0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q",
          0xca: ">f", 0xcb: ">d"}
_SIZED = {0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
          0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
          0xdc: (">H", "arr"), 0xdd: (">I", "arr"),
          0xde: (">H", "map"), 0xdf: (">I", "map")}


def _unpack(buf: bytes, i: int) -> Tuple[Any, int]:
    b = buf[i]
    i += 1
    if b <= 0x7f:
        return b, i
    if b >= 0xe0:
        return b - 0x100, i
    if 0xa0 <= b <= 0xbf:
        return _body("str", b & 0x1f, buf, i)
    if 0x90 <= b <= 0x9f:
        return _body("arr", b & 0x0f, buf, i)
    if 0x80 <= b <= 0x8f:
        return _body("map", b & 0x0f, buf, i)
    if b == 0xc0:
        return None, i
    if b in (0xc2, 0xc3):
        return b == 0xc3, i
    if b in _FIXED:
        fmt = _FIXED[b]
        n = struct.calcsize(fmt)
        return struct.unpack_from(fmt, buf, i)[0], i + n
    if b in _SIZED:
        fmt, kind = _SIZED[b]
        n = struct.unpack_from(fmt, buf, i)[0]
        return _body(kind, n, buf, i + struct.calcsize(fmt))
    raise ValueError(f"msgpack type byte 0x{b:02x} not supported")


def _body(kind: str, n: int, buf: bytes, i: int) -> Tuple[Any, int]:
    if kind == "str":
        return bytes(buf[i:i + n]).decode("utf-8"), i + n
    if kind == "bin":
        return bytes(buf[i:i + n]), i + n
    if kind == "arr":
        out = []
        for _ in range(n):
            v, i = _unpack(buf, i)
            out.append(v)
        return out, i
    d = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        d[k], i = _unpack(buf, i)
    return d, i


def unpackb(buf: bytes) -> Any:
    obj, i = _unpack(buf, 0)
    if i != len(buf):
        raise ValueError(f"{len(buf) - i} trailing bytes after the object")
    return obj
