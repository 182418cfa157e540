"""Engine run-context, settings vocabulary, and provenance.

The role of `third_party/ColBERT/colbert/infra/` (SURVEY §2.8 "ColBERT
infra/config ... `Run` context, provenance"):

- :class:`EngineConfig` — the dataclass settings stack
  (`infra/config/settings.py:11-177`): resource / doc / query / training /
  indexing / search knobs with ColBERT's names and defaults, plus
  ``merge``-style composition where *explicitly set* fields of later
  sources win over earlier ones and defaults never clobber anything
  (the ``DefaultVal`` machinery of `core_config.py:14-60`, done here by
  remembering which kwargs the caller actually passed).
- :class:`Run` — the singleton run-context stack (`infra/run.py:10-78`):
  nested ``context(...)`` scopes that inherit the enclosing config,
  ``path_`` = root/experiment/name, guarded ``open`` that refuses to
  overwrite artifacts unless ``overwrite`` is set.
- :class:`Provenance` — artifact lineage (`infra/provenance.py:6-45`):
  creator call-site, timestamp, and an attached config snapshot,
  serializable to the ``.meta`` files the data containers write.

Port of the JAX package's ``engine/infra.py``: the same classes and
behaviour. ``Run.rank`` is ``torch.distributed.get_rank()`` when a process
group is initialised, else 0, where the JAX package reads
``jax.process_index()``.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import traceback
from contextlib import contextmanager
from typing import Any, Dict, Optional

import torch.distributed as dist


def _timestamp(daydir: bool = False) -> str:
    fmt = "%Y-%m/%d/%H.%M.%S" if daydir else "%Y-%m-%dT%H.%M.%S"
    return datetime.datetime.now().strftime(fmt)


@dataclasses.dataclass
class EngineConfig:
    """ColBERT's settings vocabulary (`settings.py:11-177`), one flat
    dataclass. Fields keep the reference names so configs translate 1:1."""

    # RunSettings
    overwrite: bool = False
    root: str = "experiments"
    experiment: str = "default"
    index_root: Optional[str] = None
    name: str = ""
    # ResourceSettings
    checkpoint: Optional[str] = None
    triples: Optional[str] = None
    collection: Optional[str] = None
    queries: Optional[str] = None
    index_name: Optional[str] = None
    # DocSettings
    dim: int = 128
    doc_maxlen: int = 220
    mask_punctuation: bool = True
    # QuerySettings
    query_maxlen: int = 32
    attend_to_mask_tokens: bool = False
    interaction: str = "colbert"
    # TrainingSettings
    similarity: str = "cosine"
    bsize: int = 32
    lr: float = 3e-6
    maxsteps: int = 500_000
    save_every: Optional[int] = None
    resume: bool = False
    warmup: Optional[int] = None
    nway: int = 2
    use_ib_negatives: bool = False
    distillation_alpha: float = 1.0
    ignore_scores: bool = False
    # IndexingSettings
    index_path: Optional[str] = None
    nbits: int = 1
    kmeans_niters: int = 20
    # SearchSettings
    ncells: Optional[int] = None
    centroid_score_threshold: Optional[float] = None
    ndocs: Optional[int] = None

    def __post_init__(self):
        self._auto_name = not self.name
        if not self.name:
            self.name = _timestamp(daydir=True)
        # NOTE: _explicit is set only by .make(); a plain EngineConfig(...)
        # has no _explicit attr, so from_existing treats ALL of its fields
        # as explicit (the natural constructor semantics) — EXCEPT the
        # auto-timestamped name, which must not clobber an enclosing Run
        # context's name during merges.

    @classmethod
    def make(cls, **kwargs) -> "EngineConfig":
        """Construct remembering which fields were explicitly set (the
        ``DefaultVal`` role)."""
        cfg = cls(**kwargs)
        cfg._explicit = set(kwargs)
        return cfg

    @classmethod
    def from_existing(cls, *sources: Optional["EngineConfig"]) -> "EngineConfig":
        """Merge left→right; later sources' explicitly-set fields win
        (`base_config.py` ``from_existing`` semantics)."""
        out: Dict[str, Any] = {}
        for src in sources:
            if src is None:
                continue
            explicit = getattr(src, "_explicit", None)
            if explicit is not None:
                names = explicit
            else:
                names = {f.name for f in dataclasses.fields(src)}
                if getattr(src, "_auto_name", False):
                    names = names - {"name"}
            for n in names:
                out[n] = getattr(src, n)
        return cls.make(**out)

    @property
    def index_root_(self) -> str:
        return self.index_root or os.path.join(
            self.root, self.experiment, "indexes"
        )

    @property
    def index_path_(self) -> str:
        return self.index_path or os.path.join(
            self.index_root_, self.index_name or "default"
        )

    def todict(self) -> Dict[str, Any]:
        return {
            f.name: getattr(self, f.name) for f in dataclasses.fields(self)
        }

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"config": self.todict()}, f, indent=2)

    @classmethod
    def load(cls, path: str) -> "EngineConfig":
        with open(path) as f:
            return cls.make(**json.load(f)["config"])


class Run:
    """Singleton run-context stack (`infra/run.py:10-78`)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance.stack = [EngineConfig.make()]
        return cls._instance

    @classmethod
    def _reset_for_tests(cls):
        cls._instance = None

    @property
    def config(self) -> EngineConfig:
        return self.stack[-1]

    def __getattr__(self, name):
        # config attribute passthrough (`run.py:37-41`)
        if name.startswith("_") or name in ("stack",):
            raise AttributeError(name)
        return getattr(self.stack[-1], name)

    @property
    def rank(self) -> int:
        """This process's rank in the initialised ``torch.distributed``
        process group, else 0."""
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
        return 0

    @property
    def path_(self) -> str:
        c = self.config
        return os.path.join(c.root, c.experiment, c.name)

    @contextmanager
    def context(self, run_config: EngineConfig, inherit_config: bool = True):
        if inherit_config:
            run_config = EngineConfig.from_existing(self.config, run_config)
        self.stack.append(run_config)
        try:
            yield
        finally:
            self.stack.pop()

    def open(self, path: str, mode: str = "r"):
        full = os.path.join(self.path_, path)
        os.makedirs(os.path.dirname(full) or ".", exist_ok=True)
        if ("w" in mode or "a" in mode) and not self.config.overwrite:
            assert not os.path.exists(full), (
                f"refusing to overwrite {full} (set overwrite=True)"
            )
        return open(full, mode=mode)

    def print(self, *args):
        print(f"[{self.rank}]", "\t\t", *args)

    def print_main(self, *args):
        if self.rank == 0:
            self.print(*args)


class Provenance:
    """Artifact lineage (`infra/provenance.py:6-45`): creation call-site,
    timestamp, and arbitrary attached attributes (e.g. the config
    snapshot)."""

    def __init__(self):
        self.initial_stacktrace = self._stacktrace()
        self.created_at = _timestamp()
        self.attrs: Dict[str, Any] = {}

    @staticmethod
    def _stacktrace(limit: int = 5):
        frames = traceback.extract_stack()[:-2][-limit:]
        return [
            f"{os.path.basename(fr.filename)}:{fr.lineno}:{fr.name}"
            for fr in frames
        ]

    def attach(self, **kwargs) -> "Provenance":
        self.attrs.update(kwargs)
        return self

    def todict(self) -> Dict[str, Any]:
        return {
            "created_at": self.created_at,
            "stacktrace": self.initial_stacktrace,
            **self.attrs,
        }

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump({"provenance": self.todict()}, f, indent=2)
