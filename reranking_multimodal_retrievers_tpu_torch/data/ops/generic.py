"""Generic engine-level transforms (the runway vocabulary).

Port of the JAX package's ``data/ops/generic.py``: dataset load/split/
tokenize over ``data/table.py`` tables (a ``save_to_disk`` directory is
read by ``data/arrow_io.py``; a hub id raises), plus the EvalRecorder
plumbing that turns post-hoc evaluation into pipeline nodes (consumed from
``BaseExecutor.on_eval_end`` — reference
`runway_for_ml/executors/base_executor.py:335-372`).

These are small but part of the engine's public vocabulary: configs name
them in ``eval_pipeline`` / data-pipeline nodes.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

from ...metrics.eval_recorder import EvalRecorder
from ...utils.registries import register_transform_functor
from ..transforms import BaseTransform, HFDatasetTransform

logger = logging.getLogger(__name__)


@register_transform_functor
class DummyTransform(BaseTransform):
    """Identity node (reference `data_transforms.py:258-263`)."""

    def setup(self, **kwargs):
        return super().setup(**kwargs)

    def _call(self, data):
        return data


@register_transform_functor
class LoadHFDataset(BaseTransform):
    """Load a dataset from a local ``save_to_disk`` directory
    ``{dataset_path}/{dataset_name}`` (reference `data_transforms.py:214-228`;
    the JAX package falls back to ``datasets.load_dataset`` for anything
    else, which needs the network or pyarrow: here that raises)."""

    def setup(self, dataset_name: str, dataset_path: Optional[str] = None,
              fields: Optional[List[str]] = None, **kwargs):
        self.dataset_name = dataset_name
        self.dataset_path = dataset_path
        self.fields = fields or []
        return self

    def _call(self, data):
        from ..arrow_io import load_from_disk

        url = (f"{self.dataset_path}/{self.dataset_name}"
               if self.dataset_path else self.dataset_name)
        if not os.path.isdir(url):
            raise NotImplementedError(
                f"{url!r} is not a save_to_disk directory: hub ids need the network or "
                "pyarrow, which the port does without")
        ds = load_from_disk(url)
        if self.fields:  # project to the requested columns only
            if isinstance(ds, dict):
                ds = {k: v.select_columns([f for f in self.fields if f in v.column_names])
                      for k, v in ds.items()}
            else:
                ds = ds.select_columns([f for f in self.fields if f in ds.column_names])
        if self.use_dummy_data:
            ds = HFDatasetTransform(use_dummy_data=True).truncate_for_dummy(ds)
        return ds


@register_transform_functor
class SplitHFDatasetToTrainTestValidation(HFDatasetTransform):
    """Split a single 'train' split into train/test[/validation]
    (reference `data_transforms.py:230-256`), with the splits
    ``datasets.Dataset.train_test_split`` makes (``Table.train_test_split``)."""

    def setup(self, test_size, valid_size=None, train_test_split_kwargs=None,
              **kwargs):
        self.test_size = test_size
        # valid_size=0 means "no validation split", same as None
        self.valid_size = valid_size or None
        self.total = test_size + (self.valid_size or 0)
        self.split_kwargs = train_test_split_kwargs or {}
        return self

    def _call(self, data):
        train_dict = data["train"].train_test_split(self.total, **self.split_kwargs)
        out = {"train": train_dict["train"], "test": train_dict["test"]}
        if self.valid_size is not None:
            tv = train_dict["test"].train_test_split(
                self.valid_size / self.total, **self.split_kwargs)
            out["test"], out["validation"] = tv["train"], tv["test"]
        return out


@register_transform_functor
class HFDatasetTokenizeTransform(HFDatasetTransform):
    """Tokenize named fields of every split, prefixing output columns with
    the field name (reference `data_transforms.py:177-212`)."""

    def setup(self, tokenizer_config, tokenize_fields_list,
              rename_col_dict=None, splits_to_process=None, **kwargs):
        from .common import build_tokenizer

        self.tokenizer = build_tokenizer(tokenizer_config,
                                         use_dummy_data=self.use_dummy_data)
        self.tokenize_fields_list = tokenize_fields_list
        self.rename_col_dict = rename_col_dict or {}
        self.splits = splits_to_process or ["train", "test", "validation"]
        self.tokenize_kwargs = dict(tokenizer_config.get(
            "tokenize_kwargs",
            {"padding": "max_length", "truncation": True},
        ))
        self.tokenize_kwargs.pop("batched", None)
        self.tokenize_kwargs.pop("load_from_cache_file", None)
        return self

    def _call(self, data):
        # splits not selected for tokenization pass through unchanged
        results = {k: v for k, v in data.items()}
        for split in self.splits:
            if split not in data:
                continue
            ds = data[split]
            for field in self.tokenize_fields_list:
                tok = self.tokenizer

                def _tok(batch, _f=field):
                    return tok(batch[_f], **self.tokenize_kwargs)

                ds = ds.map(_tok, batched=True)
                ds = ds.rename_columns({
                    "input_ids": f"{field}_input_ids",
                    "attention_mask": f"{field}_attention_mask",
                })
            if self.rename_col_dict:
                ds = ds.rename_columns(self.rename_col_dict)
            results[split] = ds
        return results


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
