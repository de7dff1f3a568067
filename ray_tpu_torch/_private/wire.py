"""The msgpack subset the control plane speaks, in pure Python.

``packb(obj)`` gives the bytes of ``msgpack.packb(obj, use_bin_type=True)``
and ``unpackb(data)`` reads them back as ``msgpack.unpackb(data,
raw=False)`` does, for the types the core's messages hold: ``None``,
``bool``, ``int`` (-2**63 .. 2**64 - 1, each in its smallest encoding),
``float`` (float64), ``str`` (utf-8), ``bytes`` / ``bytearray`` /
``memoryview`` (bin), ``list`` / ``tuple`` (array; read back as lists) and
``dict`` (map). Any other type raises ``TypeError``: nothing is pickled
behind the caller's back. The port's RPC layer (``rpc.py``) frames its
messages with it, so the port speaks the JAX core's wire without the
``msgpack`` package.
"""
from __future__ import annotations

import struct

_B = struct.Struct(">B").pack
_BB = struct.Struct(">BB").pack
_BH = struct.Struct(">BH").pack
_BI = struct.Struct(">BI").pack
_BQ = struct.Struct(">BQ").pack
_Bb = struct.Struct(">Bb").pack
_Bh = struct.Struct(">Bh").pack
_Bi = struct.Struct(">Bi").pack
_Bq = struct.Struct(">Bq").pack
_Bd = struct.Struct(">Bd").pack


def _int(v: int, out: list) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(_B(v))
        elif v < 0x100:
            out.append(_BB(0xCC, v))
        elif v < 0x10000:
            out.append(_BH(0xCD, v))
        elif v < 0x100000000:
            out.append(_BI(0xCE, v))
        elif v < 0x10000000000000000:
            out.append(_BQ(0xCF, v))
        else:
            raise OverflowError("Integer value out of range")
    elif v >= -32:
        out.append(_B(v & 0xFF))
    elif v >= -0x80:
        out.append(_Bb(0xD0, v))
    elif v >= -0x8000:
        out.append(_Bh(0xD1, v))
    elif v >= -0x80000000:
        out.append(_Bi(0xD2, v))
    elif v >= -0x8000000000000000:
        out.append(_Bq(0xD3, v))
    else:
        raise OverflowError("Integer value out of range")


def _header(n: int, small: int, small_max: int, b16: int, b32: int,
            out: list) -> None:
    if n <= small_max:
        out.append(_B(small | n))
    elif n < 0x10000:
        out.append(_BH(b16, n))
    elif n < 0x100000000:
        out.append(_BI(b32, n))
    else:
        raise ValueError("object too large for msgpack")


def _bin(b, out: list) -> None:
    n = len(b)
    if n < 0x100:
        out.append(_BB(0xC4, n))
    elif n < 0x10000:
        out.append(_BH(0xC5, n))
    elif n < 0x100000000:
        out.append(_BI(0xC6, n))
    else:
        raise ValueError("bytes too large for msgpack")
    out.append(b)


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _int(obj, out)
    elif isinstance(obj, float):
        out.append(_Bd(0xCB, obj))
    elif isinstance(obj, (bytes, bytearray)):
        _bin(bytes(obj), out)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        n = len(b)
        if n < 32:
            out.append(_B(0xA0 | n))
        elif n < 0x100:
            out.append(_BB(0xD9, n))
        elif n < 0x10000:
            out.append(_BH(0xDA, n))
        elif n < 0x100000000:
            out.append(_BI(0xDB, n))
        else:
            raise ValueError("str too large for msgpack")
        out.append(b)
    elif isinstance(obj, dict):
        _header(len(obj), 0x80, 15, 0xDE, 0xDF, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _header(len(obj), 0x90, 15, 0xDC, 0xDD, out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, memoryview):
        _bin(obj.tobytes(), out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)``, byte for byte."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


_U16 = struct.Struct(">H").unpack_from
_U32 = struct.Struct(">I").unpack_from
_U64 = struct.Struct(">Q").unpack_from
_I8 = struct.Struct(">b").unpack_from
_I16 = struct.Struct(">h").unpack_from
_I32 = struct.Struct(">i").unpack_from
_I64 = struct.Struct(">q").unpack_from
_F32 = struct.Struct(">f").unpack_from
_F64 = struct.Struct(">d").unpack_from

# fixed-width scalars: marker -> (reader, width)
_SCALARS = {
    0xCC: (lambda d, i: d[i], 1), 0xCD: (_U16, 2), 0xCE: (_U32, 4),
    0xCF: (_U64, 8), 0xD0: (_I8, 1), 0xD1: (_I16, 2), 0xD2: (_I32, 4),
    0xD3: (_I64, 8), 0xCA: (_F32, 4), 0xCB: (_F64, 8),
}
# length-prefixed: marker -> (kind, width of the length)
_SIZED = {
    0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
    0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
    0xDC: ("array", 2), 0xDD: ("array", 4),
    0xDE: ("map", 2), 0xDF: ("map", 4),
}
_LEN = {1: lambda d, i: (d[i],), 2: _U16, 4: _U32}


def _unpack(d: bytes, i: int):
    m = d[i]
    i += 1
    if m < 0x80:
        return m, i
    if m >= 0xE0:
        return m - 0x100, i
    if 0xA0 <= m <= 0xBF:
        n = m & 0x1F
        return d[i:i + n].decode("utf-8"), i + n
    if 0x90 <= m <= 0x9F:
        return _array(d, i, m & 0x0F)
    if 0x80 <= m <= 0x8F:
        return _map(d, i, m & 0x0F)
    if m == 0xC0:
        return None, i
    if m == 0xC2:
        return False, i
    if m == 0xC3:
        return True, i
    scalar = _SCALARS.get(m)
    if scalar is not None:
        read, width = scalar
        v = read(d, i)
        return (v if isinstance(v, int) else v[0]), i + width
    sized = _SIZED.get(m)
    if sized is None:
        raise ValueError(f"unsupported msgpack marker 0x{m:02x}")
    kind, width = sized
    (n,) = _LEN[width](d, i)
    i += width
    if kind == "bin":
        return bytes(d[i:i + n]), i + n
    if kind == "str":
        return bytes(d[i:i + n]).decode("utf-8"), i + n
    if kind == "array":
        return _array(d, i, n)
    return _map(d, i, n)


def _array(d, i, n):
    out = []
    for _ in range(n):
        v, i = _unpack(d, i)
        out.append(v)
    return out, i


def _map(d, i, n):
    out = {}
    for _ in range(n):
        k, i = _unpack(d, i)
        v, i = _unpack(d, i)
        out[k] = v
    return out, i


def unpackb(data) -> object:
    """``msgpack.unpackb(data, raw=False)`` for what ``packb`` writes."""
    d = bytes(data) if not isinstance(data, bytes) else data
    obj, end = _unpack(d, 0)
    if end != len(d):
        raise ValueError(f"extra data after the message ({len(d) - end} B)")
    return obj
