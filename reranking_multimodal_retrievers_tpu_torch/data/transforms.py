"""Transform functor base classes.

Parity with the reference functor protocol
(`runway_for_ml/data_module/data_transforms.py:33-170`): a functor is
constructed with ``(use_dummy_data, global_config)``, configured via
``setup(**setup_kwargs)``, then called with its input node's data. Dummy-data
mode is a first-class flag every functor sees (the reference's mechanism for
testing pipelines without full datasets, `src/main.py:85-90`).
"""

from __future__ import annotations

from typing import Any

from .table import Table


class BaseTransform:
    def __init__(self, use_dummy_data: bool = False, global_config=None, name: str = ""):
        self.use_dummy_data = use_dummy_data
        self.global_config = global_config
        self.name = name or type(self).__name__
        self.setup_kwargs = {}

    def setup(self, **kwargs):
        self.setup_kwargs = kwargs
        for k, v in kwargs.items():
            setattr(self, k, v)
        return self

    def __call__(self, data: Any = None) -> Any:
        return self._call(data)

    def _call(self, data):
        raise NotImplementedError


class RowWiseTransform(BaseTransform):
    """Apply ``row_call`` to each row of a mapping-style dataset."""

    def _call(self, data):
        return data.map(self.row_call) if hasattr(data, "map") else [
            self.row_call(row) for row in data
        ]

    def row_call(self, row):
        raise NotImplementedError


class HFDatasetTransform(BaseTransform):
    """Base for transforms over tables (``data/table.py``, the role of HF
    ``datasets`` objects in the JAX package); provides dummy-mode
    truncation (the reference slices to a handful of rows in dummy mode,
    `runway_for_ml/tests/test_data_ops.py:54-60`)."""

    dummy_rows: int = 16

    def truncate_for_dummy(self, ds):
        if not self.use_dummy_data or ds is None:
            return ds
        if isinstance(ds, dict):
            return {k: v.select(range(min(len(v), self.dummy_rows))) for k, v in ds.items()}
        if isinstance(ds, Table):
            return ds.select(range(min(len(ds), self.dummy_rows)))
        return ds
