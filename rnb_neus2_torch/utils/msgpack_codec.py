"""msgpack for the subset that flax's `msgpack_serialize` writes, in numpy and
the standard library (the card's host has neither `msgpack` nor `flax`).

Types: nil, bool, int, float (always float64, as `msgpack.packb` writes a
Python float), str, bin, array (list or tuple) and map (dict, in insertion
order), plus flax's extension types (`flax/serialization.py`,
`_MsgpackExtType`):

- ext 1, an ndarray: its payload is the msgpack of (shape, dtype name,
  C-order bytes);
- ext 3, a numpy scalar: the same payload for the 0-d array.

Every header takes the smallest encoding, as `msgpack.packb` does, so the
bytes equal `msgpack.packb(obj, default=flax's ext hook)` for the same
object. The reader also joins flax's `__msgpack_chunked_array__` maps (an
array above 2^30 bytes, written as flat chunks) back into arrays; the
writer writes every array whole (a snapshot's largest is 42 MB).
"""

from __future__ import annotations

import struct
from typing import Any, List

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"


def packb(obj: Any) -> bytes:
    """Serialize `obj`; the parts are joined once at the end."""
    parts: List[Any] = []
    _pack(obj, parts)
    return b"".join(parts)


def unpackb(data) -> Any:
    """Deserialize bytes written by `packb`, `msgpack.packb` or flax.
    Arrays come back as read-only numpy views of `data`."""
    buf = memoryview(data).cast("B")
    obj, pos = _unpack(buf, 0)
    if pos != len(buf):
        raise ValueError(f"msgpack: {len(buf) - pos} trailing bytes")
    return obj


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _sized(n: int, fix_tag: int, fix_max: int, tags, what: str) -> bytes:
    """Header of a str, bin, array or map of length n: the fix form when
    n <= fix_max (fix_tag | n), else the smallest of the 8/16/32-bit
    forms whose tags are given (None where the form does not exist)."""
    if fix_tag is not None and n <= fix_max:
        return bytes([fix_tag | n])
    for tag, fmt, limit in zip(tags, (">B", ">H", ">I"),
                               (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if tag is not None and n <= limit:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: {what} of length {n} is too long")


def _int(v: int) -> bytes:
    if 0 <= v <= 0x7F:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for tag, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                (0xCE, ">I", 0xFFFFFFFF),
                                (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= limit:
                return bytes([tag]) + struct.pack(fmt, v)
    else:
        for tag, fmt, bits in ((0xD0, ">b", 7), (0xD1, ">h", 15),
                               (0xD2, ">i", 31), (0xD3, ">q", 63)):
            if v >= -(1 << bits):
                return bytes([tag]) + struct.pack(fmt, v)
    raise OverflowError(f"msgpack: integer {v} does not fit 64 bits")


def _ext(code: int, payload: List[Any]) -> List[Any]:
    n = sum(len(p) for p in payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = bytes([fixed[n], code])
    else:
        head = _sized(n, None, 0, (0xC7, 0xC8, 0xC9), "ext") + bytes([code])
    return [head, *payload]


def _ndarray_payload(arr: np.ndarray) -> List[Any]:
    """flax's `_ndarray_to_bytes`: the msgpack of (shape, dtype name,
    C-order bytes). The data goes in as a view, not a copy."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("msgpack: object and structured dtypes are not "
                         "supported")
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    parts: List[Any] = [b"\x93"]
    _pack(list(arr.shape), parts)
    _pack(arr.dtype.name, parts)
    parts.append(_sized(flat.nbytes, None, 0, (0xC4, 0xC5, 0xC6), "bin"))
    parts.append(flat.data)
    return parts


def _pack(obj: Any, out: List[Any]) -> None:
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        out.append(_int(obj))
    elif t is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif t is str:
        b = obj.encode("utf-8")
        out.append(_sized(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB), "str"))
        out.append(b)
    elif t in (bytes, bytearray, memoryview):
        b = memoryview(obj).cast("B")
        out.append(_sized(len(b), None, 0, (0xC4, 0xC5, 0xC6), "bin"))
        out.append(b)
    elif t in (list, tuple):
        out.append(_sized(len(obj), 0x90, 15, (None, 0xDC, 0xDD), "array"))
        for v in obj:
            _pack(v, out)
    elif t is dict:
        out.append(_sized(len(obj), 0x80, 15, (None, 0xDE, 0xDF), "map"))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        out.extend(_ext(EXT_NDARRAY, _ndarray_payload(obj)))
    elif isinstance(obj, np.generic):
        out.extend(_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(obj))))
    else:
        raise TypeError(f"msgpack: cannot serialize {t.__name__}")


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

_FIXED = {  # tag -> (struct format, byte count) of the scalar forms
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


def _length(buf, pos: int, nbytes: int):
    return struct.unpack_from(_LEN[nbytes], buf, pos)[0], pos + nbytes


def _unpack(buf, pos: int):
    tag = buf[pos]
    pos += 1
    if tag <= 0x7F:
        return tag, pos
    if tag >= 0xE0:
        return tag - 0x100, pos
    if 0x80 <= tag <= 0x8F:
        return _map(buf, pos, tag & 0x0F)
    if 0x90 <= tag <= 0x9F:
        return _array(buf, pos, tag & 0x0F)
    if 0xA0 <= tag <= 0xBF:
        return _str(buf, pos, tag & 0x1F)
    if tag == 0xC0:
        return None, pos
    if tag in (0xC2, 0xC3):
        return tag == 0xC3, pos
    if tag in _FIXED:
        fmt, n = _FIXED[tag]
        return struct.unpack_from(fmt, buf, pos)[0], pos + n
    if tag in (0xC4, 0xC5, 0xC6):
        n, pos = _length(buf, pos, 1 << (tag - 0xC4))
        return bytes(buf[pos:pos + n]), pos + n
    if tag in (0xD9, 0xDA, 0xDB):
        n, pos = _length(buf, pos, 1 << (tag - 0xD9))
        return _str(buf, pos, n)
    if tag in (0xDC, 0xDD):
        n, pos = _length(buf, pos, 2 << (tag - 0xDC))
        return _array(buf, pos, n)
    if tag in (0xDE, 0xDF):
        n, pos = _length(buf, pos, 2 << (tag - 0xDE))
        return _map(buf, pos, n)
    if 0xD4 <= tag <= 0xD8:
        return _ext_value(buf, pos + 1, buf[pos], 1 << (tag - 0xD4))
    if tag in (0xC7, 0xC8, 0xC9):
        n, pos = _length(buf, pos, 1 << (tag - 0xC7))
        return _ext_value(buf, pos + 1, buf[pos], n)
    raise ValueError(f"msgpack: unknown tag 0x{tag:02x} at byte {pos - 1}")


def _str(buf, pos: int, n: int):
    return str(buf[pos:pos + n], "utf-8"), pos + n


def _array(buf, pos: int, n: int):
    out = []
    for _ in range(n):
        v, pos = _unpack(buf, pos)
        out.append(v)
    return out, pos


def _map(buf, pos: int, n: int):
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        out[k], pos = _unpack(buf, pos)
    if CHUNKED in out:
        return _unchunk(out), pos
    return out, pos


def _unchunk(d: dict) -> np.ndarray:
    shape = [d["shape"][str(i)] for i in range(len(d["shape"]))]
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return np.concatenate(chunks).reshape(shape)


def _ext_value(buf, pos: int, code: int, n: int):
    """flax's ext types 1 (ndarray) and 3 (numpy scalar). The array is a
    view of `buf`, not a copy."""
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise ValueError(f"msgpack: unsupported ext type {code}")
    end = pos + n
    if buf[pos] != 0x93:
        raise ValueError("msgpack: an ndarray payload is not a 3-array")
    shape, p = _unpack(buf, pos + 1)
    name, p = _unpack(buf, p)
    tag = buf[p]
    if tag not in (0xC4, 0xC5, 0xC6):
        raise ValueError("msgpack: an ndarray payload holds no bin")
    size, p = _length(buf, p + 1, 1 << (tag - 0xC4))
    if p + size != end:
        raise ValueError("msgpack: ext payload length mismatch")
    arr = np.frombuffer(buf[p:end], dtype=np.dtype(name)).reshape(shape)
    return (arr[()] if code == EXT_NPSCALAR else arr), end
