"""A msgpack codec for the subset that the checkpoints and the blob store
write: maps, arrays (lists and tuples), str, bin, ints, floats, booleans
and None.

`packb(obj)` gives the same bytes as `msgpack.packb(obj, use_bin_type=True)`:
every value takes its smallest form (fixint, fixstr, fixarray, fixmap,
then 8-, 16-, 32- and 64-bit widths; positive ints unsigned, floats as
float64), and a map keeps its insertion order. So a checkpoint written by
the port hashes (`state.sha256`) as one written by the JAX package.
`unpackb(data)` reads what `packb` writes as `msgpack.unpackb(data,
raw=False)` does: str as str, bin as bytes, arrays as lists. The port
needs no `msgpack` package.
"""
from __future__ import annotations

import struct

__all__ = ["packb", "unpackb"]


def _sized(out: bytearray, n: int, forms) -> None:
    """Append the header of the smallest form that holds length `n`:
    forms = [(limit, prefix, struct format or None for a fix form)]."""
    for limit, prefix, fmt in forms:
        if n < limit:
            if fmt is None:
                out.append(prefix | n)
            else:
                out.append(prefix)
                out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} exceeds msgpack's 32-bit limit")


_STR = [(32, 0xA0, None), (1 << 8, 0xD9, ">B"), (1 << 16, 0xDA, ">H"),
        (1 << 32, 0xDB, ">I")]
_BIN = [(1 << 8, 0xC4, ">B"), (1 << 16, 0xC5, ">H"), (1 << 32, 0xC6, ">I")]
_ARRAY = [(16, 0x90, None), (1 << 16, 0xDC, ">H"), (1 << 32, 0xDD, ">I")]
_MAP = [(16, 0x80, None), (1 << 16, 0xDE, ">H"), (1 << 32, 0xDF, ">I")]


def _pack_int(out: bytearray, n: int) -> None:
    if 0 <= n < 128:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for limit, code, fmt in ((1 << 8, 0xCC, ">B"), (1 << 16, 0xCD, ">H"),
                                 (1 << 32, 0xCE, ">I"), (1 << 64, 0xCF, ">Q")):
            if n < limit:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"int {n} does not fit in 64 bits")
    else:
        for limit, code, fmt in ((1 << 7, 0xD0, ">b"), (1 << 15, 0xD1, ">h"),
                                 (1 << 31, 0xD2, ">i"), (1 << 63, 0xD3, ">q")):
            if n >= -limit:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"int {n} does not fit in 64 bits")


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _sized(out, len(data), _STR)
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _sized(out, len(data), _BIN)
        out += data
    elif isinstance(obj, (list, tuple)):
        _sized(out, len(obj), _ARRAY)
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _sized(out, len(obj), _MAP)
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} object")


def packb(obj) -> bytes:
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        view = self.data[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
          0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCB: ">d"}
_LENGTH = {0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
           0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
           0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
           0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


def _unpack(r: _Reader):
    code = r.take(1)[0]
    if code < 0x80:
        return code
    if code >= 0xE0:
        return code - 0x100
    if code in _FIXED:
        return r.unpack(_FIXED[code])
    if code in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[code]
    if 0xA0 <= code <= 0xBF:
        kind, n = "str", code & 0x1F
    elif 0x90 <= code <= 0x9F:
        kind, n = "array", code & 0x0F
    elif 0x80 <= code <= 0x8F:
        kind, n = "map", code & 0x0F
    elif code in _LENGTH:
        kind, fmt = _LENGTH[code]
        n = r.unpack(fmt)
    else:
        raise ValueError(f"unsupported msgpack type byte 0x{code:02x}")
    if kind == "str":
        return bytes(r.take(n)).decode("utf-8")
    if kind == "bin":
        return bytes(r.take(n))
    if kind == "array":
        return [_unpack(r) for _ in range(n)]
    out = {}
    for _ in range(n):
        k = _unpack(r)
        out[k] = _unpack(r)
    return out


def unpackb(data: bytes):
    r = _Reader(data)
    obj = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} extra bytes after the "
                         "msgpack object")
    return obj
