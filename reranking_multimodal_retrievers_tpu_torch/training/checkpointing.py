"""Checkpoint management (port of ``training/checkpointing.py``).

The same ``index.json`` and the same retention: step-named checkpoints, the
top ``save_top_k`` on a monitored metric, checkpoints the metric never
reached kept by recency to the same budget, ``last`` and ``best`` always
kept; resolution explicit path > best > last; a ``strict=False`` partial
restore. Each checkpoint is a directory holding one ``torch.save`` file: for
a :class:`TrainState`, the model's, the optimizer's and the scheduler's state
dicts and the step.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .train_state import TrainState

STATE_FILE = "state.pt"


def _to_saveable(tree):
    """A state as nested dicts of tensors (numpy arrays become tensors)."""
    if isinstance(tree, TrainState):
        return {"step": tree.step, "model": tree.model.state_dict(),
                "optimizer": tree.optimizer.state_dict(),
                "scheduler": tree.scheduler.state_dict()}
    if isinstance(tree, dict):
        return {k: _to_saveable(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    return tree


class CheckpointManager:
    """Step-named checkpoints with top-k retention on a monitored metric and
    a ``last`` alias."""

    def __init__(self, ckpt_dir: str, monitor: Optional[str] = None, mode: str = "max",
                 save_top_k: int = 1):
        self.ckpt_dir = ckpt_dir
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        os.makedirs(ckpt_dir, exist_ok=True)
        self._index_path = os.path.join(ckpt_dir, "index.json")
        self._index = self._load_index()

    def _load_index(self) -> Dict[str, Any]:
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                return json.load(f)
        return {"checkpoints": [], "best": None, "last": None}

    def _write_index(self):
        with open(self._index_path, "w") as f:
            json.dump(self._index, f, indent=1)

    def save(self, state, step: int, metrics: Optional[Dict[str, float]] = None,
             name: Optional[str] = None) -> str:
        """Write ``state`` (a :class:`TrainState` or nested dicts of tensors or
        arrays) as checkpoint ``name`` (default ``step_<step>``), update the
        index and prune. Re-saving a name replaces its entry."""
        name = name or f"step_{step}"
        path = os.path.abspath(os.path.join(self.ckpt_dir, name))
        if os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path)
        torch.save(_to_saveable(state), os.path.join(path, STATE_FILE))
        entry = {"name": name, "step": step, "metrics": metrics or {}}
        self._index["checkpoints"] = [
            c for c in self._index["checkpoints"] if c["name"] != name]
        self._index["checkpoints"].append(entry)
        self._index["last"] = name
        score = (metrics or {}).get(self.monitor) if self.monitor else None
        if score is not None:
            best = self._index.get("best")
            better = (best is None
                      or (self.mode == "max" and score > best["score"])
                      or (self.mode == "min" and score < best["score"]))
            if better:
                self._index["best"] = {"name": name, "score": score}
        self._prune()
        self._write_index()
        return path

    def _prune(self):
        if self.save_top_k < 0 or self.monitor is None:
            return
        scored = [c for c in self._index["checkpoints"] if self.monitor in c["metrics"]]
        scored.sort(key=lambda c: c["metrics"][self.monitor], reverse=self.mode == "max")
        keep = {c["name"] for c in scored[: self.save_top_k]}
        # checkpoints the monitored metric never reached are kept by recency
        # to the same budget, never all deleted
        unscored = [c for c in self._index["checkpoints"] if self.monitor not in c["metrics"]]
        unscored.sort(key=lambda c: c["step"], reverse=True)
        keep.update(c["name"] for c in unscored[: self.save_top_k])
        keep.add(self._index.get("last"))
        best = self._index.get("best")
        if best:
            keep.add(best["name"])
        remaining = []
        for c in self._index["checkpoints"]:
            if c["name"] in keep:
                remaining.append(c)
            else:
                p = os.path.join(self.ckpt_dir, c["name"])
                if os.path.exists(p):
                    shutil.rmtree(p)
        self._index["checkpoints"] = remaining

    def resolve(self, load_model_path: Optional[str] = None) -> Optional[str]:
        """Explicit path > best > last (reference `experiment.py:483-514`)."""
        if load_model_path:
            return load_model_path
        best = self._index.get("best")
        if best:
            return os.path.join(self.ckpt_dir, best["name"])
        if self._index.get("last"):
            return os.path.join(self.ckpt_dir, self._index["last"])
        return None

    @staticmethod
    def restore(path: str, target=None, device: DeviceLike = "cuda"):
        """Load checkpoint ``path``. Without ``target``, return what was saved,
        its tensors on ``device``. With a :class:`TrainState`, load the
        model's entries it has (``strict=False``: the target keeps the rest),
        the optimizer's and the scheduler's state and the step into it, on
        the model's device, and return it. With nested dicts, return the
        target with every entry the checkpoint also has taken from it."""
        if isinstance(target, TrainState):
            dev = next(target.model.parameters()).device
        else:
            dev = resolve_device(device)
        restored = torch.load(os.path.join(os.path.abspath(path), STATE_FILE),
                              map_location=dev, weights_only=True)
        if target is None:
            return restored
        if isinstance(target, TrainState):
            target.model.load_state_dict(restored["model"], strict=False)
            unpack_opt_state(target.optimizer, restored["optimizer"])
            target.scheduler.load_state_dict(restored["scheduler"])
            target.step = restored["step"]
            return target
        return _partial_update(target, restored)


def pack_opt_state(optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """The optimizer's state as a saveable dict: ``optimizer.state_dict()``
    (moments and counts keyed by parameter position, and the groups)."""
    return optimizer.state_dict()


def unpack_opt_state(optimizer: torch.optim.Optimizer, packed: Dict[str, Any]):
    """Load :func:`pack_opt_state`'s output into a freshly made optimizer
    over the same parameters; returns the optimizer."""
    optimizer.load_state_dict(packed)
    return optimizer


def _partial_update(target, restored):
    """strict=False-style merge: entries present in both (same path) are
    taken from the checkpoint; everything else keeps the target's value."""
    if isinstance(target, dict) and isinstance(restored, dict):
        return {k: _partial_update(v, restored[k]) if k in restored else v
                for k, v in target.items()}
    return restored if restored is not None else target
