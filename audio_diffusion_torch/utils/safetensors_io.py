"""The ``.safetensors`` file format, on numpy alone.

A file is an 8-byte little-endian header length N, a JSON header of N bytes
(``{name: {"dtype": "F32", "shape": [...], "data_offsets": [begin, end]},
"__metadata__": {...}}``, offsets relative to the end of the header), and the
raw little-endian buffers. diffusers writes ``diffusion_pytorch_model.safetensors``
in it; the JAX package reads that through the ``safetensors`` package
(utils/torch_import.py:31-50), which the port does not use.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Optional

import numpy as np

_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64, "I32": np.int32,
           "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}
_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}


def load_file(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of ``path`` as a writable numpy array; BF16 is read as
    float32 (numpy has no bfloat16, and every bfloat16 value is a float32 one)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if len(data) < 8:
        raise ValueError(f"{path!r} is not a safetensors file: {len(data)} bytes")
    n = struct.unpack("<Q", data[:8])[0]
    if 8 + n > len(data):
        raise ValueError(f"{path!r} is truncated: a header of {n} bytes in a file of {len(data)}")
    try:
        header = json.loads(data[8:8 + n])
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path!r} has a corrupt safetensors header: {e}") from e
    body = memoryview(data)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        shape, dtype = tuple(info["shape"]), info["dtype"]
        if end > len(body):
            raise ValueError(f"{path!r} is truncated: {name!r} ends at {end} of {len(body)} data bytes")
        buf = body[begin:end]
        if dtype == "BF16":
            arr = (np.frombuffer(buf, "<u2").astype(np.uint32) << 16).view(np.float32)
        elif dtype in _DTYPES:
            arr = np.frombuffer(buf, np.dtype(_DTYPES[dtype]).newbyteorder("<")).astype(_DTYPES[dtype])
        else:
            raise ValueError(f"{path!r}: {name!r} has dtype {dtype}, which the port does not read")
        out[name] = arr.reshape(shape)
    return out


def save_file(tensors: Dict[str, np.ndarray], path: str, metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (names in sorted order, the header padded with spaces
    to a multiple of 8 bytes, as the ``safetensors`` package pads it) through
    a temporary file, an fsync and a rename."""
    header, offset, buffers = {}, 0, []
    if metadata:
        header["__metadata__"] = dict(metadata)
    for name in sorted(tensors):
        arr = np.asarray(tensors[name], order="C")
        if arr.dtype not in _NAMES:
            raise ValueError(f"{name!r}: dtype {arr.dtype} has no safetensors name here")
        buf = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": _NAMES[arr.dtype], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(buf)]}
        buffers.append(buf)
        offset += len(buf)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(struct.pack("<Q", len(head)))
        fh.write(head)
        for buf in buffers:
            fh.write(buf)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
