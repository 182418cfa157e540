"""Read a HuggingFace checkpoint directory into a state dict, and merge it
into a model (the port's counterpart of the JAX package's
``models/hf_bridge.py::load_torch_checkpoint_dir``).

A directory holds ``*.safetensors`` files or, failing those, ``*.bin``
files. A ``.safetensors`` file is read here without the ``safetensors``
package: an 8-byte little-endian header length, a JSON header naming each
tensor's dtype, shape and byte range, then the raw little-endian bytes. A
``.bin`` file is a ``torch.save`` state dict, read with
``weights_only=True``. The port's models use HF parameter names, so the
state dict goes into them as it is. :func:`write_safetensors` writes the
format, so that a port model's state dict becomes an HF-named checkpoint
directory without the ``safetensors`` package.
"""

from __future__ import annotations

import json
import math
import os
import struct
import zlib
from typing import Dict

import numpy as np
import torch
from torch import nn

StateDict = Dict[str, torch.Tensor]

# safetensors dtype names -> torch dtypes
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: str) -> StateDict:
    """Every tensor of one ``.safetensors`` file, on the CPU."""
    out: StateDict = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data_start = 8 + n
        for name, info in header.items():
            if name == "__metadata__":
                continue
            if info["dtype"] not in SAFETENSORS_DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, "
                                 f"which this reader does not take")
            dtype = SAFETENSORS_DTYPES[info["dtype"]]
            begin, end = info["data_offsets"]
            t = torch.empty(info["shape"], dtype=dtype)
            nbytes = math.prod(info["shape"]) * t.element_size()
            if end - begin != nbytes:
                raise ValueError(f"{path}: tensor {name!r} spans {end - begin} bytes, its "
                                 f"shape and dtype need {nbytes}")
            f.seek(data_start + begin)
            if nbytes and f.readinto(t.view(-1).view(torch.uint8).numpy()) != nbytes:
                raise ValueError(f"{path}: tensor {name!r} is cut short")
            out[name] = t
    return out


def write_safetensors(path: str, state_dict: StateDict) -> int:
    """Write ``state_dict`` (tensors on any device) as one ``.safetensors``
    file, tensor after tensor in name order; returns the bytes written. The
    file is written beside ``path`` and renamed into place."""
    names = {v: k for k, v in SAFETENSORS_DTYPES.items()}
    header, offset = {}, 0
    for name in sorted(state_dict):
        t = state_dict[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * ((-len(blob)) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)) + blob)
        for name in sorted(state_dict):
            t = state_dict[name].detach().contiguous().cpu()
            if t.numel():
                f.write(memoryview(t.view(-1).view(torch.uint8).numpy()))
    os.replace(tmp, path)
    return 8 + len(blob) + offset


def load_checkpoint_dir(path: str) -> StateDict:
    """The state dict of every ``.safetensors`` file of ``path``, or, when
    there is none, of every ``.bin`` file, in name order."""
    names = sorted(os.listdir(path))
    st = [n for n in names if n.endswith(".safetensors")]
    if st:
        return {k: v for n in st for k, v in read_safetensors(os.path.join(path, n)).items()}
    bins = [n for n in names if n.endswith(".bin")]
    if not bins:
        raise FileNotFoundError(f"no .safetensors or .bin files under {path}")
    out: StateDict = {}
    for n in bins:
        out.update(torch.load(os.path.join(path, n), map_location="cpu", weights_only=True))
    return out


def fresh_lora_a(key: str, in_features: int, r: int) -> torch.Tensor:
    """The ``lora_a [r, in]`` of a linear that the checkpoint holds without
    adapters, as the JAX package's bridge makes it (``hf_bridge._t5_linear``
    / ``_opt_linear``): N(0, 0.01) drawn by numpy seeded with the crc32 of
    the linear's name within the language model. Its ``lora_b`` is zero
    (peft's init: the adapted model computes the checkpoint's function)."""
    name = key.rpartition(".")[0].removeprefix("language_model.").removeprefix("model.decoder.")
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    return torch.from_numpy(
        np.ascontiguousarray(rng.normal(0, 1e-2, size=(in_features, r)).astype(np.float32).T))


@torch.no_grad()
def load_into(module: nn.Module, state_dict: StateDict) -> None:
    """Copy a checkpoint's tensors into every parameter and buffer of
    ``module`` (cast to their dtypes). The checkpoint must hold each of them
    at its shape, but for the LoRA adapters of a linear it holds (made as
    :func:`fresh_lora_a` says); its other entries (HF keeps tied copies and
    the Q-Former's text branch, which the port does not build) are not
    read."""
    own = module.state_dict()
    merged = {}
    for k, v in own.items():
        weight = state_dict.get(k.rpartition(".")[0] + ".weight")
        if k in state_dict:
            merged[k] = state_dict[k]
        elif k.endswith(".lora_a") and weight is not None:
            merged[k] = fresh_lora_a(k, weight.shape[1], v.shape[0])
        elif k.endswith(".lora_b") and weight is not None:
            merged[k] = torch.zeros_like(v)
    missing = sorted(k for k in own if k not in merged)
    if missing:
        raise KeyError(f"the checkpoint lacks {len(missing)} of the model's tensors, "
                       f"e.g. {missing[:3]}")
    bad = [k for k in own if tuple(merged[k].shape) != tuple(own[k].shape)]
    if bad:
        raise ValueError(f"checkpoint shapes differ from the model's at {bad[:3]}: "
                         f"{[tuple(merged[k].shape) for k in bad[:3]]} vs "
                         f"{[tuple(own[k].shape) for k in bad[:3]]}")
    module.load_state_dict(merged)
