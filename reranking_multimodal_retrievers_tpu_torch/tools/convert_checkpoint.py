"""Checkpoint conversion CLI (port of ``tools/convert_checkpoint.py``).

Parity with `tools/convert_flmr_original_checkpoint_to_pytorch.py` and the
HF-hub upload helpers: converts a torch ``FLMRModelForRetrieval`` checkpoint
directory (safetensors/bin, HF parameter names) into the port's checkpoint
(``<out_dir>/params``, which ``FLMRExecutor.load_checkpoint`` and
``cli.main --mode test --opts test.load_model_path=<out_dir>/params`` load,
plus ``<out_dir>/config.json``), and exports a port checkpoint to a flat
``.npz`` with the JAX package's keys (flax paths joined by ``/``) and
values, so that an ``.npz`` from either package is interchangeable.

Usage:
  python -m reranking_multimodal_retrievers_tpu_torch.tools.convert_checkpoint \
      --torch_dir /path/to/PreFLMR_ViT-B --out_dir ./flmr_port \
      --config configs/okvqa_flmr.json
  python -m reranking_multimodal_retrievers_tpu_torch.tools.convert_checkpoint \
      --export_npz ./flmr_port/params --out_dir ./flmr.npz
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict

import numpy as np
import torch

from ..executors.flmr_executor import flmr_config_from
from ..models import FLMRModelForRetrieval
from ..models.checkpoint_dir import load_checkpoint_dir
from ..models.weights import flax_flmr
from ..training.checkpointing import STATE_FILE
from ..utils.config_system import load_config


def convert_torch_to_port(torch_dir: str, out_dir: str, config_path: str) -> str:
    """Read the HF FLMR directory ``torch_dir`` into the state dict of the
    port's model for ``config_path``'s ``model_config`` (each tensor at the
    model's shape, in fp32; the directory's other entries, such as the
    query encoders' aliases of tied weights, are not read) and write it as
    the checkpoint ``<out_dir>/params`` with ``<out_dir>/config.json``."""
    config = load_config(config_path)
    flmr_config = flmr_config_from(config.get_path("model_config"))
    sd = load_checkpoint_dir(torch_dir)
    want = FLMRModelForRetrieval(flmr_config, device="meta").state_dict()
    missing = sorted(k for k in want if k not in sd)
    if missing:
        raise KeyError(f"{torch_dir} lacks {len(missing)} of the model's tensors, "
                       f"e.g. {missing[:3]}")
    model = {}
    for k, v in want.items():
        if tuple(sd[k].shape) != tuple(v.shape):
            raise ValueError(f"{torch_dir}: {k} has shape {tuple(sd[k].shape)}, the model's "
                             f"is {tuple(v.shape)}")
        model[k] = sd[k].to(v.dtype).contiguous()
    params = os.path.join(out_dir, "params")
    os.makedirs(params, exist_ok=True)
    torch.save({"model": model}, os.path.join(params, STATE_FILE))
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(flmr_config), f, default=str)
    return out_dir


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(_flatten(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def export_npz(params_dir: str, out_path: str) -> str:
    """The port checkpoint ``params_dir`` (its ``model`` state dict) as the
    JAX package's ``export_npz`` writes its FLMR params: flax paths joined
    by ``/``, flax layouts (``[in, out]`` kernels, HWIO convolutions)."""
    state = torch.load(os.path.join(os.path.abspath(params_dir), STATE_FILE),
                       map_location="cpu", weights_only=True)
    sd = {k: v.detach().float().numpy() for k, v in state["model"].items()}
    np.savez(out_path, **_flatten(flax_flmr(sd)))
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--torch_dir")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--config")
    p.add_argument("--export_npz", help="port checkpoint dir to export as npz")
    args = p.parse_args(argv)
    if args.export_npz:
        out = export_npz(args.export_npz, args.out_dir)
    else:
        if not (args.torch_dir and args.config):
            p.error("--torch_dir and --config are needed to convert")
        out = convert_torch_to_port(args.torch_dir, args.out_dir, args.config)
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
