"""Generic engine-level transforms (the runway vocabulary).

Port of the JAX package's ``data/ops/generic.py``: the identity node and
the EvalRecorder plumbing that turns post-hoc evaluation into pipeline nodes
(consumed from ``BaseExecutor.on_eval_end`` — reference
`runway_for_ml/executors/base_executor.py:335-372`). The JAX package's HF
dataset load/split/tokenize nodes (``LoadHFDataset``,
``SplitHFDatasetToTrainTestValidation``, ``HFDatasetTokenizeTransform``)
need HF ``datasets`` and are not ported; no config names them.

These are small but part of the engine's public vocabulary: configs name
them in ``eval_pipeline`` / data-pipeline nodes.
"""

from __future__ import annotations

import logging
from ...metrics.eval_recorder import EvalRecorder
from ...utils.registries import register_transform_functor
from ..transforms import BaseTransform

logger = logging.getLogger(__name__)


@register_transform_functor
class DummyTransform(BaseTransform):
    """Identity node (reference `data_transforms.py:258-263`)."""

    def setup(self, **kwargs):
        return super().setup(**kwargs)

    def _call(self, data):
        return data


@register_transform_functor
class GetEvaluationRecorder(BaseTransform):
    """Head node of an eval pipeline: pass through a recorder handed in by
    the executor, or load one from disk (reference
    `data_transforms.py:265-276`)."""

    def setup(self, base_dir=None, eval_record_name="test-evaluation",
              file_format="json", **kwargs):
        self.eval_record_name = eval_record_name
        self.base_dir = base_dir
        self.file_format = file_format
        return self

    def _call(self, data):
        if data is not None:  # executor-injected recorder (validation path)
            return data
        base = self.base_dir
        if base is None and self.global_config is not None:
            base = self.global_config.get_path(
                "meta.experiment_dir", ".") if hasattr(
                    self.global_config, "get_path") else "."
        return EvalRecorder.load_from_disk(
            self.eval_record_name, base or ".", file_format=self.file_format)


@register_transform_functor
class MergeAllEvalRecorderAndSave(BaseTransform):
    """Tail node: merge recorders (row-append across shards/passes), rename,
    save (reference `data_transforms.py:278-310`)."""

    def setup(self, eval_record_name="merged-test-evaluation",
              eval_recorder_prefix="merged", base_dir=None,
              file_format="json", save_recorder=True, **kwargs):
        self.eval_record_name = eval_record_name
        self.eval_recorder_prefix = eval_recorder_prefix
        self.base_dir = base_dir
        self.file_format = file_format
        self.save_recorder = save_recorder
        return self

    def _call(self, data):
        if isinstance(data, EvalRecorder):
            data = [data]
        recorder = data[0]
        for other in data[1:]:
            recorder.merge(other)
        name = (f"{self.eval_recorder_prefix}-{recorder.name}"
                if self.eval_recorder_prefix else self.eval_record_name)
        recorder.rename(name, new_base_dir=self.base_dir)
        if self.save_recorder:
            recorder.save_to_disk(file_format=self.file_format)
        return recorder
