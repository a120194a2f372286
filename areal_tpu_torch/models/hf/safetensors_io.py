"""Read and write the safetensors format with torch alone.

The JAX package reads and writes checkpoints through the `safetensors`
package; the port must run where only torch is installed, so this module
implements the format itself:

    8 bytes   little-endian u64 N, the header's length
    N bytes   JSON: {name: {"dtype", "shape", "data_offsets": [b, e]}, ...}
              plus an optional "__metadata__": {str: str}; padded with
              spaces to a multiple of 8 bytes
    rest      the tensors' raw little-endian bytes; a tensor's bytes are
              [b, e) counted from the end of the header

`load_file` maps the file and hands out tensors that view the map
(`torch.frombuffer`), so reading a multi-GB checkpoint copies nothing
until the caller moves a tensor to its device and dtype.
"""

import json
import mmap
import struct
from typing import Dict, Optional, Tuple

import torch

_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def read_header(path: str) -> Tuple[Dict, int]:
    """(header dict, byte offset of the data section) of a file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return header, 8 + n


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file as a CPU tensor viewing a
    copy-on-write map of the file (the map lives as long as its
    tensors).  `__metadata__` is not a tensor and is skipped."""
    header, start = read_header(path)
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {info['dtype']}")
        shape = [int(s) for s in info["shape"]]
        b, e = (int(x) for x in info["data_offsets"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        count = (e - b) // itemsize
        if count * itemsize != e - b or count != _numel(shape):
            raise ValueError(f"{path}: tensor {name!r} has {e - b} bytes for shape {shape}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        elif (start + b) % itemsize:
            # A misaligned tensor cannot be viewed in place: copy its bytes.
            raw = torch.frombuffer(mm, dtype=torch.uint8, count=e - b, offset=start + b)
            out[name] = raw.clone().view(dtype).reshape(shape)
        else:
            out[name] = torch.frombuffer(
                mm, dtype=dtype, count=count, offset=start + b
            ).reshape(shape)
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def save_file(
    tensors: Dict[str, torch.Tensor], path: str, metadata: Optional[Dict[str, str]] = None
) -> None:
    """Write `tensors` (any device; each written contiguous, in its own
    dtype) to `path`.  Wider dtypes first, then by name, as the
    `safetensors` package orders them: every tensor then starts at a
    multiple of its element size."""
    header: Dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    names = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    off = 0
    for name in names:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r} has unsupported dtype {t.dtype}")
        n = t.numel() * t.element_size()
        header[name] = {
            "dtype": _NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [off, off + n],
        }
        off += n
    blob = json.dumps(header, separators=(",", ":")).encode("utf-8")
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in names:
            t = tensors[name].detach().to("cpu").contiguous().reshape(-1)
            if t.numel():
                f.write(t.view(torch.uint8).numpy().data)
