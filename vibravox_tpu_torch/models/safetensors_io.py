"""A reader and writer of the safetensors format, without the package.

The published EBEN weights are ``model.safetensors`` files.  The format: an
8-byte little-endian header length ``n``, ``n`` bytes of JSON (``{name:
{"dtype", "shape", "data_offsets": [begin, end]}}``, an optional
``__metadata__`` of strings first, padded with spaces to a multiple of 8),
then the tensors' little-endian bytes, back to back.  ``save_file`` lays a
file out as ``safetensors.torch.save_file`` does (the tensors sorted by
dtype, widest first, then by name), so both give the same bytes.
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path
from typing import Dict, Mapping, Union

import torch

__all__ = ["load_file", "save_file"]

# safetensors' names, in its order: a file holds the tensors of the first
# dtype first
_DTYPES = (
    ("I64", torch.int64), ("F64", torch.float64), ("F32", torch.float32), ("I32", torch.int32),
    ("BF16", torch.bfloat16), ("F16", torch.float16), ("I16", torch.int16), ("I8", torch.int8),
    ("U8", torch.uint8), ("BOOL", torch.bool),
)
_BY_NAME = dict(_DTYPES)
_NAME = {dtype: name for name, dtype in _DTYPES}
_RANK = {dtype: i for i, (_, dtype) in enumerate(_DTYPES)}

PathLike = Union[str, os.PathLike]


def _as_bytes(t: torch.Tensor) -> bytes:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def save_file(tensors: Mapping[str, torch.Tensor], path: PathLike) -> None:
    """Writes ``tensors`` (CPU or GPU, any strides) to ``path`` through a
    temporary file renamed into place."""
    for name, t in tensors.items():
        if t.dtype not in _NAME:
            raise TypeError(f"{name}: dtype {t.dtype} is not one of {sorted(_BY_NAME)}")
    order = sorted(tensors, key=lambda k: (_RANK[tensors[k].dtype], k))
    header: Dict[str, object] = {}
    chunks, offset = [], 0
    for name in order:
        data = _as_bytes(tensors[name])
        header[name] = {"dtype": _NAME[tensors[name].dtype], "shape": list(tensors[name].shape),
                        "data_offsets": [offset, offset + len(data)]}
        chunks.append(data)
        offset += len(data)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    path = Path(path)
    tmp = path.with_name(f".{path.name}.tmp")
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for data in chunks:
            f.write(data)
    os.replace(tmp, path)


def load_file(path: PathLike) -> Dict[str, torch.Tensor]:
    """The tensors of a safetensors file, on the CPU, in the file's order."""
    raw = bytearray(Path(path).read_bytes())
    if len(raw) < 8:
        raise ValueError(f"{path}: too short for a safetensors file")
    (n,) = struct.unpack("<Q", raw[:8])
    if 8 + n > len(raw):
        raise ValueError(f"{path}: header length {n} runs past the end of the file")
    header = json.loads(raw[8:8 + n].decode())
    header.pop("__metadata__", None)
    start, end_of_file = 8 + n, len(raw) - 8 - n
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if info["dtype"] not in _BY_NAME:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, not one of {sorted(_BY_NAME)}")
        dtype, shape = _BY_NAME[info["dtype"]], tuple(info["shape"])
        begin, end = info["data_offsets"]
        numel = 1
        for d in shape:
            numel *= d
        if not 0 <= begin <= end <= end_of_file or end - begin != numel * dtype.itemsize:
            raise ValueError(f"{path}: {name}'s data_offsets {info['data_offsets']} do not fit {shape} {dtype}")
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(raw, dtype=dtype, count=numel, offset=start + begin).reshape(shape)
    return out
