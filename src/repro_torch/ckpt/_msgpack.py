"""The subset of MessagePack a checkpoint manifest needs: maps, strings,
integers, lists (arrays), booleans and nil.

It writes what ``msgpack.packb`` writes for these values (the smallest
encoding of each, strings as the str family) and reads what it reads
(``msgpack.unpackb``: str keys and values, lists for arrays), so a
manifest of the JAX package's checkpoints reads here and one written here
reads there, without the ``msgpack`` package.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        n = len(data)
        if n < 32:
            out.append(0xA0 | n)
        elif n < 1 << 8:
            out += bytes((0xD9, n))
        elif n < 1 << 16:
            out += b"\xda" + struct.pack(">H", n)
        else:
            out += b"\xdb" + struct.pack(">I", n)
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 0xDC, out)
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 0xDE, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} into a "
                        f"manifest")


def _pack_len(n: int, fix: int, code16: int, out: bytearray) -> None:
    if n < 16:
        out.append(fix | n)
    elif n < 1 << 16:
        out += bytes((code16,)) + struct.pack(">H", n)
    else:
        out += bytes((code16 + 1,)) + struct.pack(">I", n)


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 128:
        out.append(n)
    elif -32 <= n < 0:
        out += struct.pack(">b", n)
    elif n >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < top:
                out += bytes((code,)) + struct.pack(fmt, n)
                return
        raise OverflowError(f"{n} does not fit in 64 bits")
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)),
                               (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)),
                               (0xD3, ">q", -(1 << 63))):
            if n >= low:
                out += bytes((code,)) + struct.pack(fmt, n)
                return
        raise OverflowError(f"{n} does not fit in 64 bits")


def unpackb(data: bytes) -> Any:
    obj, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} bytes after the manifest")
    return obj


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


def _unpack(buf: memoryview, i: int) -> Tuple[Any, int]:
    b = buf[i]
    i += 1
    if b < 0x80:
        return b, i
    if b >= 0xE0:
        return b - 0x100, i
    if 0x80 <= b <= 0x8F:
        return _unpack_map(buf, i, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _unpack_list(buf, i, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        return _str(buf, i, b & 0x1F)
    if b == 0xC0:
        return None, i
    if b in (0xC2, 0xC3):
        return b == 0xC3, i
    if b in _FIXED:
        fmt = _FIXED[b]
        size = struct.calcsize(fmt)
        return struct.unpack_from(fmt, buf, i)[0], i + size
    if b in (0xD9, 0xDA, 0xDB):
        fmt = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]
        n = struct.unpack_from(fmt, buf, i)[0]
        return _str(buf, i + struct.calcsize(fmt), n)
    if b in (0xDC, 0xDD):
        fmt = ">H" if b == 0xDC else ">I"
        n = struct.unpack_from(fmt, buf, i)[0]
        return _unpack_list(buf, i + struct.calcsize(fmt), n)
    if b in (0xDE, 0xDF):
        fmt = ">H" if b == 0xDE else ">I"
        n = struct.unpack_from(fmt, buf, i)[0]
        return _unpack_map(buf, i + struct.calcsize(fmt), n)
    raise ValueError(f"MessagePack type byte 0x{b:02x} is not part of a "
                     f"manifest")


def _str(buf: memoryview, i: int, n: int) -> Tuple[str, int]:
    return bytes(buf[i:i + n]).decode("utf-8"), i + n


def _unpack_list(buf: memoryview, i: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        x, i = _unpack(buf, i)
        out.append(x)
    return out, i


def _unpack_map(buf: memoryview, i: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        v, i = _unpack(buf, i)
        out[k] = v
    return out, i
