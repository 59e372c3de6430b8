"""flax's msgpack serialization of parameter trees, on numpy alone.

The JAX package writes ``params.msgpack`` with ``flax.serialization.to_bytes``
and reads it with ``from_bytes`` (pipelines/pipeline.py:666-719). This module
reads and writes the same bytes without ``msgpack`` or ``flax``, for the
subset a parameter tree uses (flax/serialization.py):

- nested maps with str keys (flax's state dict of dicts, lists and tuples);
- arrays as msgpack ext type 1, whose payload is the msgpack array
  ``[shape, dtype name, C-order buffer]`` (``_ndarray_to_bytes``); numpy
  scalars as ext type 3 with the same payload; complex numbers as ext type 2;
- arrays of more than :data:`MAX_CHUNK_SIZE` bytes as the chunked form
  ``{"__msgpack_chunked_array__": True, "shape": {"0": ..}, "chunks": {"0": flat
  chunk, ..}}`` (``_chunk``), since one msgpack object holds < 2**31 bytes;
- None, bools, ints, floats, str and bytes as msgpack's own types.

:func:`to_bytes` gives the bytes ``flax.serialization.to_bytes`` gives for a
tree of dicts (ints in their shortest form, floats as float64, str as str,
bytes as bin). :func:`from_bytes` returns the nested dicts with writable numpy
arrays; ``bfloat16`` leaves come back as float32 (numpy has no bfloat16, and
every bfloat16 value is a float32 value).
"""

from __future__ import annotations

import struct
from typing import Any, Optional

import numpy as np

MAX_CHUNK_SIZE = 2**30  # flax's: msgpack's 2**31 - 1 byte limit per object, with a margin
CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


# ------------------------------------------------------------------- writing

def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16), (0xCE, ">I", 1 << 32),
                               (0xCF, ">Q", 1 << 64)):
            if v < top:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit in msgpack's uint64")
    else:
        for code, fmt, bottom in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)), (0xD2, ">i", -(1 << 31)),
                                  (0xD3, ">q", -(1 << 63))):
            if v >= bottom:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit in msgpack's int64")


def _pack_len(out: bytearray, n: int, fix: Optional[int], fix_max: int, codes) -> None:
    """A length header: the fix form below ``fix_max``, else the 8/16/32-bit forms in ``codes``."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of length {n} is too large")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct or arr.dtype.names is not None:
        raise ValueError(f"arrays of dtype {arr.dtype} cannot be serialized")
    out = bytearray()
    _pack(out, [list(arr.shape), arr.dtype.name, arr.tobytes("C")])
    return bytes(out)


def _chunk(arr: np.ndarray) -> dict:
    """flax's ``_chunk``: the flat array in pieces of at most MAX_CHUNK_SIZE bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {CHUNKED: True, "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _pack(out: bytearray, x: Any) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True or x is False:
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, int) and not isinstance(x, np.generic):
        _pack_int(out, x)
    elif isinstance(x, float) and not isinstance(x, np.generic):
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif isinstance(x, str):
        b = x.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(x, (bytes, bytearray, memoryview)):
        b = bytes(x)
        _pack_len(out, len(b), None, 0, (0xC4, 0xC5, 0xC6))
        out += b
    elif isinstance(x, dict):
        _pack_len(out, len(x), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in x.items():
            if not isinstance(k, str):
                raise TypeError(f"map keys must be str, got {type(k).__name__} {k!r}")
            _pack(out, k)
            _pack(out, v)
    elif isinstance(x, (list, tuple)):
        _pack_len(out, len(x), 0x90, 16, (None, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    elif isinstance(x, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_payload(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_payload(np.asarray(x)))
    elif isinstance(x, complex):
        payload = bytearray()
        _pack(payload, [x.real, x.imag])
        _pack_ext(out, _EXT_COMPLEX, bytes(payload))
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def _state_dict(x: Any) -> Any:
    """flax's ``to_state_dict`` for plain trees (lists and tuples become
    {"0": ..} maps), with oversized arrays chunked."""
    if isinstance(x, dict):
        return {str(k): _state_dict(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(x)}
    if hasattr(x, "__array__") and not isinstance(x, (np.ndarray, np.generic)):
        x = np.asarray(x)  # a torch tensor or another array type
    if isinstance(x, np.ndarray) and x.size * x.dtype.itemsize > MAX_CHUNK_SIZE:
        return _chunk(x)
    return x


def to_bytes(tree: Any) -> bytes:
    """The bytes ``flax.serialization.to_bytes(tree)`` writes for a tree of
    dicts, lists and tuples with array and scalar leaves."""
    out = bytearray()
    _pack(out, _state_dict(tree))
    return bytes(out)


# ------------------------------------------------------------------- reading

def _bf16_as_f32(buf, count: int) -> np.ndarray:
    return (np.frombuffer(buf, np.uint16, count).astype(np.uint32) << 16).view(np.float32)


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"truncated: needs {n} bytes at offset {self.pos} of {len(self.data)}")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack_from(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        c = self.take(1)[0]
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if c < 0x90:
            return self.map(c & 0x0F)
        if c < 0xA0:
            return self.array(c & 0x0F)
        if c < 0xC0:
            return self.str(c & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        if c in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack_from((">B", ">H", ">I")[c - 0xC4])))
        if c in (0xC7, 0xC8, 0xC9):
            n = self.unpack_from((">B", ">H", ">I")[c - 0xC7])
            return self.ext(self.unpack_from(">b"), n)
        if c in (0xCA, 0xCB):
            return self.unpack_from(">f" if c == 0xCA else ">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in ints:
            return self.unpack_from(ints[c])
        if c in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
            return self.ext(self.unpack_from(">b"), 1 << (c - 0xD4))
        if c in (0xD9, 0xDA, 0xDB):
            return self.str(self.unpack_from((">B", ">H", ">I")[c - 0xD9]))
        if c in (0xDC, 0xDD):
            return self.array(self.unpack_from(">H" if c == 0xDC else ">I"))
        if c in (0xDE, 0xDF):
            return self.map(self.unpack_from(">H" if c == 0xDE else ">I"))
        raise ValueError(f"unknown msgpack type byte 0x{c:02x} at offset {self.pos - 1}")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def ext(self, code: int, n: int) -> Any:
        payload = self.take(n)
        if code == _EXT_COMPLEX:
            re, im = _Reader(payload).read()
            return complex(re, im)
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, dtype, buf = _Reader(payload).read()
            dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
            count = int(np.prod(shape, dtype=np.int64))
            if dtype == "bfloat16":
                arr = _bf16_as_f32(buf, count)
            else:
                arr = np.frombuffer(buf, np.dtype(dtype), count).copy()
            arr = arr.reshape(shape)
            return arr[()] if code == _EXT_NPSCALAR else arr
        raise ValueError(f"unknown msgpack ext type {code}")


def _unchunk(x: Any) -> Any:
    if isinstance(x, dict):
        if x.get(CHUNKED) is True:
            shape = tuple(x["shape"][str(i)] for i in range(len(x["shape"])))
            chunks = [x["chunks"][str(i)] for i in range(len(x["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in x.items()}
    return x


def from_bytes(data: bytes, path: Optional[str] = None) -> Any:
    """The tree that ``to_bytes`` (or flax) wrote: nested dicts, chunked arrays
    joined. Raises ``ValueError`` naming ``path`` for empty, truncated or
    corrupt data, as the JAX package's ``_read_params`` does."""
    name = repr(path) if path is not None else "the data"
    if not data:
        raise ValueError(f"{name} is empty — the save that wrote it was interrupted. Re-save the pipeline "
                         "(saves are atomic) or restore from a training checkpoint.")
    reader = _Reader(data)
    try:
        tree = reader.read()
        if reader.pos != len(reader.data):
            raise ValueError(f"{len(reader.data) - reader.pos} bytes left after the tree")
        return _unchunk(tree)
    except (ValueError, KeyError, TypeError, UnicodeDecodeError, struct.error) as e:
        raise ValueError(f"{name} is corrupt or truncated: {e}") from e


def load(path: str) -> Any:
    """Read a ``params.msgpack`` file: :func:`from_bytes` of its bytes."""
    with open(path, "rb") as fh:
        return from_bytes(fh.read(), path)
