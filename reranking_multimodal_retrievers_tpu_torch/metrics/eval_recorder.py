"""EvalRecorder: per-sample / per-stat evaluation log container.

Parity with the reference (`runway_for_ml/utils/eval_recorder.py:18-332`):
column-wise sample logs with a stateful log index, **multi-pass** support
(``reset_for_new_pass`` rewinds the index so a second eval pass annotates the
same rows in place, `eval_recorder.py:52-55,158-183`), column-merge across
recorders of equal length (`:253-271`), rename for multiple eval passes
(`:37-42`), direct column set/replace (`:288-303`), and json+pkl round-trips.

Divergences by design: tensors arrive as numpy (no torch unwrap needed) and
the json format is a single file instead of three.
"""

from __future__ import annotations

import copy as _copy
import json
import os
import pickle
from typing import Any, Dict, Iterable, List, Optional


class EvalRecorder:
    def __init__(self, name: str = "eval", base_dir: str = "."):
        self.name = name
        self.base_dir = base_dir
        self.sample_logs: Dict[str, List[Any]] = {}
        self.stats_logs: Dict[str, List[Any]] = {}
        self.meta: Dict[str, Any] = {}
        self._log_index = 0

    # ----------------------------------------------------------- logging
    def log_sample_dict(self, sample: Dict[str, Any]) -> None:
        """Write ``sample`` at the current log index (reference
        `eval_recorder.py:185-199`): appends on a first pass; on a later pass
        (after :meth:`reset_for_new_pass`) overwrites/annotates the existing
        row, adding new columns backfilled with None."""
        idx = self._log_index
        n = self.num_samples
        assert idx <= n, f"log index {idx} beyond recorder length {n}"
        for k, v in sample.items():
            col = self.sample_logs.setdefault(k, [None] * n)
            if idx == len(col):
                col.append(v)
            else:
                col[idx] = v
        if idx >= n:  # first pass: backfill columns this sample didn't set
            for k, col in self.sample_logs.items():
                if len(col) == idx:
                    col.append(None)
        self._log_index += 1

    def log_sample_dict_batch(self, batch: Dict[str, List[Any]]) -> None:
        lengths = {len(v) for v in batch.values()}
        assert len(lengths) == 1, "batch columns must have equal length"
        for i in range(lengths.pop()):
            self.log_sample_dict({k: v[i] for k, v in batch.items()})

    def log_stats_dict(self, stats: Dict[str, Any]) -> None:
        for k, v in stats.items():
            self.stats_logs.setdefault(k, []).append(v)

    def reset_for_new_pass(self) -> None:
        """Rewind for another pass over the dataset (`:52-55`)."""
        self._log_index = 0

    # ------------------------------------------------------------ access
    @property
    def num_samples(self) -> int:
        return max((len(v) for v in self.sample_logs.values()), default=0)

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        return self.get_sample_logs_by_index(idx)

    def get_sample_logs_column(self, key: str) -> List[Any]:
        return self.sample_logs.get(key, [])

    def set_sample_logs_column(self, key: str, values: List[Any]) -> None:
        """Reference `:288-297`: column length must match."""
        assert len(values) == len(self), (
            f"Length mismatch: {key}: {len(values)} vs {len(self)}"
        )
        self.sample_logs[key] = list(values)

    def set_sample_logs_data(self, data: Dict[str, List[Any]]) -> None:
        """Reference `:299-311`: replace all columns, move index to tail."""
        lengths = {len(v) for v in data.values()}
        assert len(lengths) <= 1, "all columns must have the same length"
        self.sample_logs = {k: list(v) for k, v in data.items()}
        self._log_index = self.num_samples

    def get_sample_logs_by_index(self, idx: int) -> Dict[str, Any]:
        return {k: v[idx] for k, v in self.sample_logs.items()}

    def get_rows(self) -> List[Dict[str, Any]]:
        return [self.get_sample_logs_by_index(i) for i in range(self.num_samples)]

    def copy_data_from(self, other: "EvalRecorder") -> None:
        """Reference `:129-135` (name preserved)."""
        self.sample_logs = _copy.copy(other.sample_logs)
        self.stats_logs = _copy.copy(other.stats_logs)
        self.meta = _copy.copy(other.meta)
        self._log_index = other._log_index

    # ------------------------------------------------------------- merge
    def merge(self, other: "EvalRecorder") -> "EvalRecorder":
        """Row-append merge (across ranks/shards); see
        :meth:`merge_columns` for the reference's same-length column merge."""
        for row in other.get_rows():
            self._log_index = self.num_samples  # append at the tail
            self.log_sample_dict(row)
        for k, vs in other.stats_logs.items():
            self.stats_logs.setdefault(k, []).extend(vs)
        return self

    def merge_columns(self, others: Iterable["EvalRecorder"]) -> "EvalRecorder":
        """Reference ``merge`` (`:253-271`): same row count required;
        non-overlapping sample columns are adopted, stats are updated."""
        for other in others:
            assert len(other) == len(self), (
                "only EvalRecorders with the same number of rows can be merged"
            )
            for k, col in other.sample_logs.items():
                if k not in self.sample_logs:
                    self.sample_logs[k] = list(col)
            self.stats_logs.update(other.stats_logs)
        return self

    def rename(self, new_name: str, new_base_dir: Optional[str] = None) -> "EvalRecorder":
        """Reference `:37-42` — re-point the recorder for another eval pass."""
        self.name = new_name
        if new_base_dir:
            self.base_dir = new_base_dir
        return self

    # ---------------------------------------------------------- save/load
    def _paths(self, file_format: str):
        d = os.path.join(self.base_dir, self.name)
        return d, os.path.join(d, f"recorder.{file_format}")

    def save_to_disk(self, file_format: str = "pkl") -> str:
        d, path = self._paths(file_format)
        os.makedirs(d, exist_ok=True)
        payload = {
            "name": self.name,
            "sample_logs": self.sample_logs,
            "stats_logs": self.stats_logs,
            "meta": self.meta,
        }
        if file_format == "json":
            with open(path, "w") as f:
                json.dump(payload, f, default=str)
        else:
            with open(path, "wb") as f:
                pickle.dump(payload, f)
        return path

    @classmethod
    def load_from_disk(
        cls, name: str, base_dir: str, file_format: str = "pkl"
    ) -> "EvalRecorder":
        rec = cls(name=name, base_dir=base_dir)
        _, path = rec._paths(file_format)
        if file_format == "json":
            with open(path) as f:
                payload = json.load(f)
        else:
            with open(path, "rb") as f:
                payload = pickle.load(f)
        rec.sample_logs = payload["sample_logs"]
        rec.stats_logs = payload["stats_logs"]
        rec.meta = payload.get("meta", {})
        rec.reset_for_new_pass()  # reference `:124` — loaded recorders rewind
        return rec
