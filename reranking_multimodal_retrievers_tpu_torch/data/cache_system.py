"""Disk cache for pipeline node outputs (port of ``data/cache_system.py``).

Every output is pickled (tables included: ``data/table.py``), written to a
temporary file and renamed into place, so that an interrupted write never
leaves a truncated cache entry. The files are named ``<name>.tables.pkl``,
apart from the JAX package's ``<name>.hf`` / ``<name>.pkl`` entries for the
same node. A ``<name>.hf`` entry (HF ``datasets`` objects, saved with
``save_to_disk``) is read through ``data/arrow_io.py`` when this package
has no entry of its own; a JAX ``.pkl`` entry is not read (it may pickle
``datasets`` objects). Dummy-data runs cache under a separate subdirectory
so they never pollute real caches
(`runway_for_ml/data_module/data_pipeline.py:42-43`).
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any

SUFFIX = ".tables.pkl"


def cache_data_to_disk(data: Any, name: str, cache_dir: str) -> str:
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, name + SUFFIX)
    fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".pkl.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def load_data_from_disk(name: str, cache_dir: str):
    """The cached output, or None: this package's pickle, else a ``.hf``
    directory the JAX package saved."""
    path = os.path.join(cache_dir, name + SUFFIX)
    if os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    hf_path = os.path.join(cache_dir, name + ".hf")
    if os.path.isdir(hf_path):
        from .arrow_io import load_from_disk

        return load_from_disk(hf_path)
    return None


def cache_exists(name: str, cache_dir: str) -> bool:
    return (os.path.exists(os.path.join(cache_dir, name + SUFFIX))
            or os.path.isdir(os.path.join(cache_dir, name + ".hf")))


def dummy_scoped_path(path: str) -> str:
    """Redirect a side-artifact path into the dummy cache namespace.

    Dataset cache entries are already dummy-isolated (``cache/dummy/...``,
    mirroring the reference's split at `data_pipeline.py:42-43`), but
    transforms that write SIDE artifacts to config-fixed paths (synthetic
    vocab files, key images) would otherwise clobber the real artifacts when
    a ``--use_dummy_data`` run regenerates them with dummy-sized content —
    silently invalidating every checkpoint trained against the real vocab.
    ``cache/X/y`` maps to ``cache/dummy/X/y``; any other path is placed under
    ``cache/dummy/`` verbatim (minus a leading separator).
    """
    # Normalize so every spelling of the same cache path ('cache/x',
    # './cache/x', '/abs/cwd/cache/x') redirects identically:
    # a generator and a consumer that spell the path differently must not
    # end up with two different dummy locations.
    norm = os.path.normpath(path)
    if os.path.isabs(norm):
        rel = os.path.relpath(norm, os.getcwd())
        if not rel.startswith(".."):
            norm = rel
    norm = norm.replace(os.sep, "/")
    if norm.startswith("cache/"):
        rest = norm[len("cache/"):]
        if rest.startswith("dummy/"):
            return path
        return os.path.join("cache", "dummy", rest)
    return os.path.join("cache", "dummy", norm.lstrip("/"))
