"""HF CLIP checkpoints -> the port's towers
(``rangeclip_tpu/models/clip/convert.py``).

The towers carry HF's submodule names (``model.py``), so the conversion is a
split of the state dict by prefix: ``text_model.*`` and ``text_projection``
go to :class:`CLIPTextTower`, ``vision_model.*`` and ``visual_projection``
to :class:`CLIPVisionTower`; ``logit_scale`` and the ``position_ids``
buffers some checkpoints carry are dropped.

``.bin`` files load with ``torch.load(weights_only=True)``.  ``.safetensors``
files load with :func:`read_safetensors`, a reader of the format written
here with numpy (an 8-byte little-endian header length, a JSON header of
dtype / shape / byte range per tensor, then the raw little-endian buffers),
so no ``safetensors`` package is needed; bf16 tensors widen exactly to
float32.  :func:`write_safetensors` writes the same format.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from rangeclip_tpu_torch.models.clip.model import (
    CLIPTextTower,
    CLIPVisionTower,
)

_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8",
           "I32": "<i4", "I16": "<i2", "I8": "i1", "U64": "<u8",
           "U32": "<u4", "U16": "<u2", "U8": "u1", "BOOL": "?"}
_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}
_TOWERS = {"text": ("text_model.", "text_projection."),
           "vision": ("vision_model.", "visual_projection.")}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A ``.safetensors`` file -> {name: numpy array}; BF16 -> float32."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())  # writable, so torch.from_numpy is too
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if info["dtype"] == "BF16":
            bits = np.frombuffer(data, "<u2", (end - begin) // 2, begin)
            array = (bits.astype(np.uint32) << 16).view(np.float32)
        elif info["dtype"] in _DTYPES:
            dtype = np.dtype(_DTYPES[info["dtype"]])
            array = np.frombuffer(data, dtype, (end - begin) // dtype.itemsize,
                                  begin)
        else:
            raise ValueError(f"{path}: unsupported dtype {info['dtype']} "
                             f"of {name}")
        out[name] = array.reshape(shape)
    return out


def write_safetensors(path: str, tensors: Mapping[str, np.ndarray]) -> str:
    """{name: numpy array} -> a ``.safetensors`` file (no BF16: numpy has
    no such type)."""
    header, offset, buffers = {}, 0, []
    for name in sorted(tensors):
        array = np.ascontiguousarray(tensors[name])
        array = array.astype(array.dtype.newbyteorder("<"), copy=False)
        raw = array.tobytes()
        header[name] = {"dtype": _NAMES[np.dtype(array.dtype.str)],
                        "shape": list(array.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        buffers.append(raw)
        offset += len(raw)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # the format pads the header to 8 bytes
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for raw in buffers:
            f.write(raw)
    return path


def load_hf_clip_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """An HF CLIP checkpoint file (``.safetensors`` or a torch ``.bin``)
    -> a state dict of CPU tensors."""
    if path.endswith(".safetensors"):
        return {k: torch.from_numpy(v) for k, v in
                read_safetensors(path).items()}
    return torch.load(path, map_location="cpu", weights_only=True)


def tower_state_dict(state_dict: Mapping[str, torch.Tensor],
                     tower: str) -> Dict[str, torch.Tensor]:
    """The HF state dict's entries of one tower ("text" or "vision"), with
    the ``text_model.`` / ``vision_model.`` prefix stripped: the tower's
    ``state_dict()`` keys."""
    body, projection = _TOWERS[tower]
    out = {}
    for key, value in state_dict.items():
        if key.endswith("position_ids"):
            continue
        if key.startswith(body):
            out[key[len(body):]] = value
        elif key.startswith(projection):
            out[key] = value
    return out


def hf_state_dict(text: CLIPTextTower, vision: CLIPVisionTower
                  ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`tower_state_dict`: two towers -> one HF CLIP
    state dict (without ``logit_scale``)."""
    out = {}
    for tower, module in (("text", text), ("vision", vision)):
        body, projection = _TOWERS[tower]
        for key, value in module.state_dict().items():
            out[key if key.startswith(projection) else body + key] = value
    return out


def convert_clip_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor],
                                                Dict[str, torch.Tensor]]:
    """-> (text tower state dict, vision tower state dict)."""
    sd = load_hf_clip_checkpoint(path)
    return tower_state_dict(sd, "text"), tower_state_dict(sd, "vision")
