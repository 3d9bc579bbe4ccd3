"""The checkpoint payload codec: msgpack for the subset that the JAX
package's ``flax.serialization.msgpack_serialize`` writes, without the
``msgpack`` or ``flax`` packages.

The subset: maps with str keys, ints, floats, bools, nil, str and bin;
ext type 1, an ndarray, and ext type 3, a numpy scalar, each packed as the
msgpack array ``(shape, dtype name, C-order bytes)``; and flax's chunked
form of an array above 2**30 bytes (``{"__msgpack_chunked_array__": True,
"shape": {...}, "chunks": {...}}``), which :func:`unpackb` joins back into
one array and :func:`packb` writes for such an array.

:func:`packb` writes the bytes flax writes for the same tree: map keys
in sorted order (``msgpack_serialize`` copies the tree with
``jax.tree_util``, which sorts them), then msgpack-python's encoding (the
smallest form of each int, str and container length; floats as
float64). :func:`unpackb` returns nested dicts whose
leaves are numpy arrays (0-d for a scalar ext), except for a ``bfloat16``
leaf, which numpy cannot hold: it comes back as a ``torch.bfloat16``
tensor (the bytes read through a ``uint16`` view), and :func:`packb`
writes such a tensor as ``bfloat16``.
"""

import struct
from typing import Any, Dict

import numpy as np
import torch

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
MAX_CHUNK_SIZE = 2**30  # flax's: arrays above this many bytes go in chunks
_CHUNKED = "__msgpack_chunked_array__"


# ---- encoder ----------------------------------------------------------------


def _pack_int(out: bytearray, v: int):
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for marker, fmt, hi in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2**64 - 1)):
            if v <= hi:
                out.append(marker)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack's uint64")
    else:
        for marker, fmt, lo in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                                (0xD2, ">i", -0x80000000), (0xD3, ">q", -(2**63))):
            if v >= lo:
                out.append(marker)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack's int64")


def _pack_len(out: bytearray, n: int, fix_base, fix_max, markers):
    """A length header: the fix form when ``n <= fix_max``, else the first
    of ``markers`` (8-, 16- and 32-bit, ``None`` where the type has no
    such form) that holds ``n``."""
    if fix_base is not None and n <= fix_max:
        out.append(fix_base | n)
        return
    for marker, fmt, hi in zip(markers, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if marker is not None and n <= hi:
            out.append(marker)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"length {n} does not fit msgpack")


def _pack_str(out: bytearray, s: str):
    b = s.encode("utf-8")
    _pack_len(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
    out += b


def _pack_bin(out: bytearray, b: bytes):
    _pack_len(out, len(b), None, -1, (0xC4, 0xC5, 0xC6))
    out += b


def _pack_ext(out: bytearray, code: int, data: bytes):
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_len(out, len(data), None, -1, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _array_parts(value):
    """``(shape, dtype name, C-order bytes)`` of a numpy array or a torch
    tensor (a bf16 tensor through its ``uint16`` bits)."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return tuple(t.shape), "bfloat16", t.view(torch.uint16).numpy().tobytes()
        value = t.numpy()
    arr = np.asarray(value)
    if arr.dtype.hasobject or arr.dtype.isalignedstruct or arr.dtype.fields:
        raise ValueError(f"dtype {arr.dtype} cannot be serialized")
    return arr.shape, arr.dtype.name, arr.tobytes("C")


def _ndarray_bytes(value) -> bytes:
    shape, name, raw = _array_parts(value)
    out = bytearray([0x93])  # fixarray of 3
    _pack_len(out, len(shape), 0x90, 15, (None, 0xDC, 0xDD))
    for d in shape:
        _pack_int(out, int(d))
    _pack_str(out, name)
    _pack_bin(out, raw)
    return bytes(out)


def _chunked(value) -> Dict[str, Any]:
    """flax's ``_chunk``: the flat array in pieces of at most
    ``MAX_CHUNK_SIZE`` bytes."""
    arr = np.asarray(value)
    step = max(1, MAX_CHUNK_SIZE // arr.dtype.itemsize)
    flat = arr.reshape(-1)
    chunks = [flat[i : i + step] for i in range(0, flat.size, step)]
    return {
        _CHUNKED: True,
        "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
        "chunks": {str(i): c for i, c in enumerate(chunks)},
    }


def _nbytes(value) -> int:
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    return np.asarray(value).nbytes


def _pack(out: bytearray, value, in_map: bool):
    if value is None:
        out.append(0xC0)
    elif value is True:
        out.append(0xC3)
    elif value is False:
        out.append(0xC2)
    elif type(value) is int:
        _pack_int(out, value)
    elif type(value) is float:
        out.append(0xCB)
        out += struct.pack(">d", value)
    elif type(value) is str:
        _pack_str(out, value)
    elif type(value) is bytes:
        _pack_bin(out, value)
    elif type(value) is dict:
        if any(type(k) is not str for k in value):
            raise TypeError(f"map keys {sorted(map(repr, value))} are not all str")
        _pack_map(out, sorted(value.items()))
    elif isinstance(value, (np.ndarray, torch.Tensor)):
        if in_map and _nbytes(value) > MAX_CHUNK_SIZE:
            if isinstance(value, torch.Tensor) and value.dtype == torch.bfloat16:
                raise ValueError("a bfloat16 array above 2**30 bytes cannot be chunked")
            # flax adds this map after its sorted copy: insertion order
            chunked = _chunked(value)
            _pack_map(out, [(_CHUNKED, True), ("shape", list(chunked["shape"].items())),
                            ("chunks", list(chunked["chunks"].items()))])
        else:
            _pack_ext(out, EXT_NDARRAY, _ndarray_bytes(value))
    elif isinstance(value, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(value)))
    else:
        raise TypeError(f"cannot serialize {type(value).__name__}")


def _pack_map(out: bytearray, items):
    """A map of ``(key, value)`` pairs in the order given; a value that is
    a list of pairs is a map in its order too."""
    _pack_len(out, len(items), 0x80, 15, (None, 0xDE, 0xDF))
    for k, v in items:
        _pack_str(out, k)
        if type(v) is list:
            _pack_map(out, v)
        else:
            _pack(out, v, in_map=True)


def packb(tree) -> bytes:
    """The msgpack bytes of ``tree`` (nested str-keyed dicts whose leaves
    are None, bool, int, float, str, bytes, numpy arrays and scalars, or
    torch tensors)."""
    out = bytearray()
    _pack(out, tree, in_map=False)
    return bytes(out)


# ---- decoder ----------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack payload is truncated")
        view = self.data[self.pos : self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_UINT = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}
_SINT = {0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LEN8_16_32 = (">B", ">H", ">I")
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _read(r: _Reader, raw_str: bool = False):
    b = r.unpack(">B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_read(r, raw_str) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return _str(r.take(b & 0x1F), raw_str)
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in (0xC4, 0xC5, 0xC6):
        return bytes(r.take(r.unpack(_LEN8_16_32[b - 0xC4])))
    if b in (0xC7, 0xC8, 0xC9):
        n = r.unpack(_LEN8_16_32[b - 0xC7])
        return _ext(r.unpack(">b"), bytes(r.take(n)))
    if b == 0xCB:
        return r.unpack(">d")
    if b in _UINT:
        return r.unpack(_UINT[b])
    if b in _SINT:
        return r.unpack(_SINT[b])
    if b in _FIXEXT:
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(_FIXEXT[b])))
    if b in (0xD9, 0xDA, 0xDB):
        return _str(r.take(r.unpack(_LEN8_16_32[b - 0xD9])), raw_str)
    if b in (0xDC, 0xDD):
        n = r.unpack(">H" if b == 0xDC else ">I")
        return [_read(r, raw_str) for _ in range(n)]
    if b in (0xDE, 0xDF):
        return _read_map(r, r.unpack(">H" if b == 0xDE else ">I"))
    raise ValueError(f"msgpack byte 0x{b:02x} is not in the subset the checkpoint uses")


def _str(view: memoryview, raw: bool):
    return bytes(view) if raw else str(view, "utf-8")


def _read_map(r: _Reader, n: int) -> Dict[str, Any]:
    out = {}
    for _ in range(n):
        key = _read(r)
        if not isinstance(key, str):
            raise ValueError(f"map key {key!r} is not a str")
        out[key] = _read(r)
    if out.get(_CHUNKED) is True:
        return _unchunk(out)
    return out


def _ndarray(data: bytes):
    r = _Reader(data)
    parts = _read(r, raw_str=True)
    if r.pos != len(data) or not isinstance(parts, list) or len(parts) != 3:
        raise ValueError("an ndarray ext is not (shape, dtype, bytes)")
    shape, name, raw = parts
    shape = tuple(int(d) for d in shape)
    if name == b"bfloat16":
        bits = np.frombuffer(raw, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(raw, dtype=np.dtype(name.decode())).reshape(shape, order="C")


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        arr = _ndarray(data)
        return arr if isinstance(arr, torch.Tensor) else arr[()]
    raise ValueError(f"msgpack ext type {code} is not in the subset the checkpoint uses")


def _unchunk(d: Dict[str, Any]) -> np.ndarray:
    """flax's ``_unchunk``: the pieces joined and reshaped."""
    shape = tuple(int(d["shape"][str(i)]) for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if any(isinstance(c, torch.Tensor) for c in chunks):
        raise ValueError("a chunked bfloat16 array is not supported")
    return np.concatenate(chunks).reshape(shape)


def unpackb(data: bytes):
    """The tree that :func:`packb` (or flax's ``msgpack_serialize``) wrote.
    Raises ``ValueError`` on anything outside the subset, on a truncated
    payload and on trailing bytes."""
    r = _Reader(data)
    tree = _read(r)
    if r.pos != len(r.data):
        raise ValueError("msgpack payload has trailing bytes")
    return tree
