"""Read HF checkpoint directories into torch state dicts (the port's
counterpart of ``runbooks_tpu.models.convert.load_torch_state_dict``).

The safetensors reader is written from the format's specification, so the
port needs no ``safetensors`` package:

  8 bytes    little-endian u64 N, the header's length
  N bytes    JSON: {name: {"dtype": "BF16", "shape": [...],
             "data_offsets": [begin, end]}, "__metadata__": {...}}
  the rest   the tensors' raw little-endian bytes, offsets relative to
             the end of the header

Tensors come back as views of a private (copy-on-write) memory map of the
file: nothing is read until a caller touches it, and a caller that casts
or transposes each tensor into its own buffer never holds a second copy of
the checkpoint. BF16 goes straight to ``torch.bfloat16``: numpy has no
bfloat16 of its own, so it never passes through numpy.
"""

from __future__ import annotations

import glob
import json
import mmap
import os
import struct
from typing import Dict

import torch

DTYPES = {"F32": torch.float32, "F16": torch.float16,
          "BF16": torch.bfloat16}
# A header past this is not a checkpoint header (the reference
# implementation refuses headers over 100 MB too).
MAX_HEADER_BYTES = 100 * 1024 * 1024


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """{name: tensor} of one .safetensors file. Raises ValueError on a
    malformed file and on a dtype other than F32, F16 and BF16, by name."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: too short for a safetensors header")
        (n,) = struct.unpack("<Q", head)
        if n > MAX_HEADER_BYTES:
            raise ValueError(f"{path}: header of {n} bytes")
        try:
            header = json.loads(f.read(n))
        except (UnicodeDecodeError, ValueError) as exc:
            raise ValueError(f"{path}: header is not JSON") from exc
        if not isinstance(header, dict):
            raise ValueError(f"{path}: header is not a JSON object")
        size = os.fstat(f.fileno()).st_size
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    start, data_len = 8 + n, size - 8 - n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = DTYPES.get(info.get("dtype"))
        if dtype is None:
            raise ValueError(
                f"{path}: tensor {name!r} has dtype {info.get('dtype')!r}; "
                f"this reader takes {sorted(DTYPES)}")
        shape = [int(s) for s in info["shape"]]
        begin, end = (int(o) for o in info["data_offsets"])
        count = 1
        for s in shape:
            count *= s
        itemsize = dtype.itemsize
        if not 0 <= begin <= end <= data_len \
                or end - begin != count * itemsize:
            raise ValueError(
                f"{path}: tensor {name!r} of shape {shape} {info['dtype']} "
                f"has data_offsets {[begin, end]} in {data_len} data bytes")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        elif (start + begin) % itemsize:
            # The map is page-aligned: a misaligned tensor gets a copy.
            out[name] = torch.frombuffer(
                bytearray(buf[start + begin:start + end]),
                dtype=dtype).reshape(shape)
        else:
            out[name] = torch.frombuffer(buf, dtype=dtype, count=count,
                                         offset=start + begin
                                         ).reshape(shape)
    return out


def load_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    """A local HF checkpoint directory as {name: tensor}: every
    ``*.safetensors`` in sorted order (a sharded directory's index file is
    not needed), else every ``*.bin`` through ``torch.load(...,
    weights_only=True)`` cast to float32, as the reference reads them."""
    sd: Dict[str, torch.Tensor] = {}
    st_files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    for path in st_files:
        sd.update(read_safetensors(path))
    if st_files:
        return sd
    for path in sorted(glob.glob(os.path.join(model_dir, "*.bin"))):
        part = torch.load(path, map_location="cpu", weights_only=True)
        for key, val in part.items():
            sd[key] = val.float()
    if not sd:
        raise FileNotFoundError(f"no safetensors/bin weights in {model_dir}")
    return sd
