"""Reader and writer of the safetensors format in numpy.

The layout (the `safetensors` package's): an 8-byte little-endian header
length N, N bytes of JSON mapping each tensor's name to its `dtype`
("F32", "I64", ...), `shape` and `data_offsets` ([begin, end) in the byte
buffer that follows the header; an optional "__metadata__" entry maps
strings to strings; this writer writes none), then the raw little-endian buffers. The writer pads
the header with spaces to a multiple of 8 bytes and lays the buffers out
in name order, back to back. The offline tools write their latent shards
with it (the card's machine has no `safetensors` package), and the files
load with `safetensors.numpy.load_file`.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping

import numpy as np

DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8,
    "BOOL": np.bool_,
}
_CODES = {np.dtype(v): k for k, v in DTYPES.items()}
# A header longer than this is not a tensor file (the package's own limit).
MAX_HEADER = 100_000_000


def save_file(tensors: Mapping[str, np.ndarray], path: str) -> None:
    """Write `tensors` (name -> numpy array) to `path`, through a temporary
    file renamed into place."""
    header: Dict[str, object] = {}
    arrays, offset = [], 0
    for name in sorted(tensors):
        a = np.asarray(tensors[name])
        code = _CODES.get(a.dtype)
        if code is None:
            raise TypeError(f"save_file: {name}: dtype {a.dtype} has no safetensors code")
        raw = np.ascontiguousarray(a, dtype=a.dtype.newbyteorder("<")).tobytes()
        header[name] = {"dtype": code, "shape": list(a.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        arrays.append(raw)
        offset += len(raw)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for raw in arrays:
            f.write(raw)
    os.replace(tmp, path)


def _header(f, size: int):
    head = f.read(8)
    if len(head) != 8:
        raise ValueError("safetensors: file shorter than its 8-byte header length")
    (n,) = struct.unpack("<Q", head)
    if n > MAX_HEADER or 8 + n > size:
        raise ValueError(f"safetensors: header length {n} does not fit a {size}-byte file")
    header = json.loads(f.read(n))
    if not isinstance(header, dict):
        raise ValueError("safetensors: the header is not a JSON object")
    return header


def load_file(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of `path` as a numpy array (name -> array), checked
    against the header: a known dtype, a byte range that holds exactly the
    shape's elements, and no range past the end of the file."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        header = _header(f, size)
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = DTYPES.get(info.get("dtype"))
        if dtype is None:
            raise ValueError(f"safetensors: {name}: unknown dtype {info.get('dtype')!r}")
        shape = tuple(int(s) for s in info["shape"])
        begin, end = (int(o) for o in info["data_offsets"])
        want = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
        if not 0 <= begin <= end <= len(data) or end - begin != want:
            raise ValueError(f"safetensors: {name}: byte range [{begin}, {end}) does not "
                             f"hold {shape} {info['dtype']} in a {len(data)}-byte buffer")
        le = np.dtype(dtype).newbyteorder("<")
        out[name] = np.frombuffer(data, dtype=le, count=want // le.itemsize,
                                  offset=begin).reshape(shape).astype(dtype)
    return out
