"""A reader of the safetensors checkpoint format, on the standard library
and numpy alone (the card's machine has no ``safetensors`` package).

A file is an 8-byte little-endian header length N, then N bytes of JSON
mapping each tensor name to its ``dtype``, ``shape`` and ``data_offsets``
(begin and end, relative to the end of the header), with an optional
``__metadata__`` entry of strings, then the raw little-endian data.

``read_safetensors`` memory-maps the file and returns a numpy view of each
tensor, so nothing is read until a tensor is used. numpy has no bf16, so a
``BF16`` tensor comes back as its raw 16-bit patterns in an int16 array,
and ``to_torch`` reinterprets those bits as torch.bfloat16.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

# safetensors dtype -> (numpy dtype of the stored bits, torch dtype)
DTYPES = {
    "BF16": (np.dtype("<i2"), torch.bfloat16),
    "F16": (np.dtype("<f2"), torch.float16),
    "F32": (np.dtype("<f4"), torch.float32),
    "I32": (np.dtype("<i4"), torch.int32),
    "I64": (np.dtype("<i8"), torch.int64),
}


class SafetensorsError(ValueError):
    pass


def read_header(path: str) -> tuple[dict, int]:
    """(header without ``__metadata__``, offset of the data section)."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise SafetensorsError(f"{path}: shorter than the 8-byte header length")
        (n,) = struct.unpack("<Q", raw)
        text = f.read(n)
    if len(text) != n:
        raise SafetensorsError(f"{path}: header of {n} bytes runs past the end of the file")
    header = json.loads(text)
    header.pop("__metadata__", None)
    return header, 8 + n


def read_safetensors(path: str) -> dict[str, tuple[np.ndarray, torch.dtype]]:
    """name -> (numpy view of the stored bits, the tensor's torch dtype),
    memory-mapped copy-on-write: writing to a view never reaches the file."""
    header, start = read_header(path)
    data = np.memmap(path, dtype=np.uint8, mode="c")
    out = {}
    for name, info in header.items():
        kind = info["dtype"]
        if kind not in DTYPES:
            raise SafetensorsError(f"{path}: {name} has dtype {kind}, which is not read")
        np_dtype, torch_dtype = DTYPES[kind]
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        if end - begin != np_dtype.itemsize * int(np.prod(shape)) or start + end > data.size:
            raise SafetensorsError(f"{path}: {name}'s data_offsets do not match its shape")
        out[name] = (data[start + begin:start + end].view(np_dtype).reshape(shape), torch_dtype)
    return out


def to_torch(entry: tuple[np.ndarray, torch.dtype], device) -> torch.Tensor:
    """Upload one tensor to ``device`` as it is stored (bf16 bits go up as
    int16 and are reinterpreted there, with no host conversion)."""
    arr, dtype = entry
    t = torch.from_numpy(arr).to(device=device, copy=True)
    return t.view(dtype) if t.dtype != dtype else t
