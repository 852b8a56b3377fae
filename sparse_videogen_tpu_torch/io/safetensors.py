"""The safetensors format in the standard library, numpy and torch (the port
reads checkpoints on hosts without the `safetensors` package).

A file is an 8-byte little-endian header length N, N bytes of JSON
(`{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{...}}`, offsets relative to the end of the header) and the raw
little-endian tensor bytes. BF16 travels as uint16 and is viewed back.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

# format name -> (numpy dtype of the raw bytes, torch dtype)
DTYPES = {
    "F32": (np.dtype("<f4"), torch.float32),
    "F16": (np.dtype("<f2"), torch.float16),
    "BF16": (np.dtype("<u2"), torch.bfloat16),
    "I64": (np.dtype("<i8"), torch.int64),
    "I32": (np.dtype("<i4"), torch.int32),
    "U8": (np.dtype("u1"), torch.uint8),
}
_NAMES = {tdt: name for name, (_, tdt) in DTYPES.items()}


def _header(f, path: str) -> tuple[dict, int]:
    raw = f.read(8)
    if len(raw) != 8:
        raise ValueError(f"{path}: not a safetensors file (shorter than its header length)")
    (n,) = struct.unpack("<Q", raw)
    header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def load_file(path: str, device="cpu") -> dict[str, torch.Tensor]:
    """Every tensor of one .safetensors file, in its stored dtype."""
    out = {}
    with open(path, "rb") as f:
        header, start = _header(f, path)
        for name, info in header.items():
            if info["dtype"] not in DTYPES:
                raise NotImplementedError(f"{path}: tensor {name} has dtype {info['dtype']}, "
                                          f"not one of {sorted(DTYPES)}")
            np_dt, t_dt = DTYPES[info["dtype"]]
            begin, end = info["data_offsets"]
            shape = tuple(info["shape"])
            if end - begin != np_dt.itemsize * int(np.prod(shape, dtype=np.int64)):
                raise ValueError(f"{path}: tensor {name} spans {end - begin} bytes, shape {shape} {info['dtype']}")
            f.seek(start + begin)
            arr = np.fromfile(f, dtype=np_dt, count=(end - begin) // np_dt.itemsize).reshape(shape)
            t = torch.from_numpy(arr)
            out[name] = (t.view(t_dt) if t_dt == torch.bfloat16 else t).to(device)
    return out


def load_dir(path: str, device="cpu") -> dict[str, torch.Tensor]:
    """Every *.safetensors file of a directory, in sorted order, as one flat
    dict (io/checkpoint.py's load_safetensors_dir in the JAX package)."""
    files = sorted(os.path.join(path, f) for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors file in {path}")
    out = {}
    for f in files:
        out.update(load_file(f, device))
    return out


def save_file(tensors: dict[str, torch.Tensor], path: str) -> None:
    """Write tensors (any device; F32, F16, BF16, I64, I32 or U8) in name
    order; the header is padded with spaces to a multiple of 8 bytes."""
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().to("cpu").contiguous()
        if t.dtype not in _NAMES:
            raise NotImplementedError(f"tensor {name} has dtype {t.dtype}, not one of {sorted(_NAMES.values())}")
        raw = (t.view(torch.uint16) if t.dtype == torch.bfloat16 else t).numpy()
        blob = raw.astype(DTYPES[_NAMES[t.dtype]][0], copy=False).tobytes()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for blob in blobs:
            f.write(blob)
