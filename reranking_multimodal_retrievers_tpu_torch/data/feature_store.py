"""On-disk key-value feature store (port of the JAX package's
``data/feature_store.py``: the same layout, so a store written by either
package is read by the other).

The reference pushes precomputed tensors and captions into a local
ElasticSearch index so that expensive extraction passes are shareable and
resumable across pipelines and processes (`src/data_ops/vqa_data_ops.py:1313`
``ExtractImageFeaturesWithViTv3`` "saves tensors to ES";
`src/data_ops/infoseek_data_ops.py:766,939` ``CaptionImageWithBLIP2v2/v3``
write/read an ``image_captions`` index, with v3 skipping already-captioned
images). An external search daemon is the wrong dependency for an accelerator host's
input pipeline, so the rebuild uses a plain directory store: one ``.npy`` per
array and one ``.json`` per scalar/string payload, keyed by a sanitized id.
Multi-host safe for the write-once pattern these pipelines use (each key is
written atomically via rename).
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Any, Iterator, Optional

import numpy as np


def _sanitize(key: str) -> str:
    """Filesystem-safe name: keep readable ids, hash anything exotic."""
    if all(c.isalnum() or c in "-_." for c in key) and 0 < len(key) < 120:
        return key
    return hashlib.sha1(key.encode()).hexdigest()


class FeatureStore:
    """Directory-backed KV store for arrays and JSON payloads.

    >>> store = FeatureStore("/tmp/caps", index_name="image_captions")
    >>> store.put("img_1", "a photo of a cat")
    >>> "img_1" in store
    True
    """

    def __init__(self, base_dir: str, index_name: str = "features"):
        self.dir = os.path.join(base_dir, index_name)
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, key: str, ext: str) -> str:
        return os.path.join(self.dir, _sanitize(key) + ext)

    def put(self, key: str, value: Any) -> None:
        if isinstance(value, np.ndarray):
            path, writer = self._path(key, ".npy"), lambda f: np.save(f, value)
            other = self._path(key, ".json")
        else:
            path, writer = self._path(key, ".json"), (
                lambda f: f.write(json.dumps(value).encode())
            )
            other = self._path(key, ".npy")
        fd, tmp = tempfile.mkstemp(dir=self.dir)
        try:
            with os.fdopen(fd, "wb") as f:
                writer(f)
            os.replace(tmp, path)  # atomic publish
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        # a type-changing overwrite must not leave the old-extension file
        # shadowing the new value in get()/__contains__/keys()
        if os.path.exists(other):
            os.unlink(other)

    def get(self, key: str, default: Any = None) -> Any:
        npy = self._path(key, ".npy")
        if os.path.exists(npy):
            return np.load(npy)
        js = self._path(key, ".json")
        if os.path.exists(js):
            with open(js) as f:
                return json.load(f)
        return default

    def __contains__(self, key: str) -> bool:
        return (os.path.exists(self._path(key, ".npy"))
                or os.path.exists(self._path(key, ".json")))

    def keys(self) -> Iterator[str]:
        for name in sorted(os.listdir(self.dir)):
            base, ext = os.path.splitext(name)
            if ext in (".npy", ".json"):
                yield base

    def __len__(self) -> int:
        return sum(1 for _ in self.keys())
