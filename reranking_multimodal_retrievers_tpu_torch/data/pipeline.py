"""Lazy transform-DAG executor with content-keyed disk caching.

Parity with the reference ``DataPipeline``
(`runway_for_ml/data_module/data_pipeline.py:49-193`):

- nodes are named ``"<split>:<Name>"`` and declare ``transform_name``,
  ``input_node`` (or a list), ``setup_kwargs``, ``cache`` and ``regenerate``;
- execution is lazy and recursive from requested output nodes;
- the cache filename is keyed on the node id + a TRANSITIVE md5 over its own
  and every ancestor's (transform, setup_kwargs), so changing any upstream
  parameter invalidates exactly the affected downstream subtree;
- dummy-data mode caches under ``cache/dummy``;
- an in-memory cache avoids recomputation within a process.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Any, Dict, List, Optional

from ..utils.registries import DataTransform_Registry
from .cache_system import cache_data_to_disk, cache_exists, load_data_from_disk

logger = logging.getLogger(__name__)


class DataPipeline:
    def __init__(
        self,
        pipeline_config,
        use_dummy_data: bool = False,
        global_config=None,
        cache_dir: Optional[str] = None,
    ):
        self.config = pipeline_config
        self.use_dummy_data = use_dummy_data
        self.global_config = global_config
        base = cache_dir or pipeline_config.get("cache_dir", "cache")
        self.cache_dir = os.path.join(base, "dummy") if use_dummy_data else base
        self.transforms: Dict[str, dict] = dict(pipeline_config.get("transforms", {}))
        self.output_data: Dict[str, Any] = {}
        self._sig_memo: Dict[str, str] = {}

    # ------------------------------------------------------------------ keys
    def _node_signature(self, node_id: str) -> str:
        """Transitive content signature: the node's own transform + kwargs
        AND every ancestor's, so changing an upstream node's parameters
        invalidates the whole downstream subtree (this is what the module
        docstring promises; keying on the node's own kwargs alone served
        stale descendants computed from an old parent output)."""
        memo = self._sig_memo.get(node_id)
        if memo is not None:
            return memo
        info = self.transforms.get(node_id, {})
        parents = info.get("input_node")
        if parents is None:
            parents = []
        elif not isinstance(parents, (list, tuple)):
            parents = [parents]
        payload = json.dumps(
            {
                "transform": info.get("transform_name"),
                "kwargs": info.get("setup_kwargs", {}),
                "parents": [self._node_signature(p) for p in parents
                            if p in self.transforms],
            },
            sort_keys=True, default=str,
        )
        sig = hashlib.md5(payload.encode()).hexdigest()[:10]
        self._sig_memo[node_id] = sig
        return sig

    def _cache_name(self, node_id: str, trans_info: dict) -> str:
        safe = node_id.replace(":", "__").replace("/", "_")
        return f"{safe}-{self._node_signature(node_id)}"

    # ------------------------------------------------------------------ exec
    def _exec_node(self, node_id: str) -> Any:
        if node_id in self.output_data:
            return self.output_data[node_id]
        if node_id not in self.transforms:
            raise KeyError(f"pipeline node not found: {node_id}")
        trans_info = self.transforms[node_id]
        cache_name = self._cache_name(node_id, trans_info)
        use_cache = bool(trans_info.get("cache", False))
        regenerate = bool(trans_info.get("regenerate", False))

        if use_cache and not regenerate and cache_exists(cache_name, self.cache_dir):
            logger.info("cache hit for %s", node_id)
            data = load_data_from_disk(cache_name, self.cache_dir)
            self.output_data[node_id] = data
            return data

        input_node = trans_info.get("input_node")
        if input_node is None:
            inputs = None
        elif isinstance(input_node, (list, tuple)):
            inputs = [self._exec_node(n) for n in input_node]
        else:
            inputs = self._exec_node(input_node)

        name = trans_info["transform_name"]
        if name not in DataTransform_Registry:
            raise KeyError(f"transform not registered: {name}")
        functor = DataTransform_Registry[name](
            use_dummy_data=self.use_dummy_data,
            global_config=self.global_config,
            name=node_id,
        )
        functor.setup(**trans_info.get("setup_kwargs", {}))
        logger.info("executing %s (%s)", node_id, name)
        output = functor(inputs)

        if use_cache:
            cache_data_to_disk(output, cache_name, self.cache_dir)
        self.output_data[node_id] = output
        return output

    # ------------------------------------------------------------------- api
    def reset(self) -> None:
        """Clear the in-memory node cache so every transform re-runs
        (reference ``DataPipeline.reset`` used before each eval-pipeline run,
        `base_executor.py:346-348`). Disk caches are untouched — eval
        pipelines set ``cache: false`` on their nodes."""
        self.output_data = {}

    def apply_transforms(self) -> Dict[str, Any]:
        """Execute every ``output:*`` node (reference `:171-176`)."""
        outs = {}
        for node_id in self.transforms:
            if node_id.startswith("output:"):
                outs[node_id] = self._exec_node(node_id)
        return outs

    def get_data(self, node_ids: List[str], explode: bool = False,
                 input_data_dict: Optional[Dict[str, Any]] = None):
        """Execute the requested nodes (reference `:178-185`).

        ``input_data_dict`` pre-seeds named nodes with in-memory values —
        the executor hands its live EvalRecorder to the eval pipeline's
        ``input:GetEvaluationRecorder`` node this way (reference
        `base_executor.py:348-350`)."""
        if input_data_dict:
            self.output_data.update(input_data_dict)
        results = {n: self._exec_node(n) for n in node_ids}
        if explode:
            assert len(node_ids) == 1
            return results[node_ids[0]]
        return results
