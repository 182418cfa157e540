"""An in-memory row table: the part of HF ``datasets.Dataset`` that the
data pipeline uses, without ``datasets`` (the card's machine has none).

A :class:`Table` holds named columns of Python values of equal length. It
builds from a dict of columns (``from_dict``), gives rows as dicts
(``table[i]``, iteration) and columns as lists (``table["name"]``), and has
``select``, ``shuffle(seed)`` (the permutation ``datasets`` draws:
``np.random.default_rng(seed).permutation(n)``), ``map``, ``filter``,
``select_columns``, ``rename_columns`` and :func:`concatenate_tables`. It
pickles as it is, which is how the pipeline's disk cache stores it. A split
dict (the ``DatasetDict`` role) is a plain ``dict`` of tables.

A row handed out is a copy: changing it changes no table, as a row read
from an Arrow table does not.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Iterable, Iterator, List, Mapping, Sequence

import numpy as np


class Table:
    def __init__(self, columns: Mapping[str, Sequence[Any]]):
        cols = {k: list(v) for k, v in columns.items()}
        lengths = {len(v) for v in cols.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of unequal length: "
                             f"{ {k: len(v) for k, v in cols.items()} }")
        self._cols: Dict[str, List[Any]] = cols
        self._n = lengths.pop() if lengths else 0

    @classmethod
    def from_dict(cls, columns: Mapping[str, Sequence[Any]]) -> "Table":
        return cls(columns)

    # ---------------------------------------------------------------- access
    @property
    def column_names(self) -> List[str]:
        return list(self._cols)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, key):
        if isinstance(key, str):
            return list(self._cols[key])
        if isinstance(key, (int, np.integer)):
            i = int(key)
            if i < 0:
                i += self._n
            if not 0 <= i < self._n:
                raise IndexError(f"row {key} of a table of {self._n}")
            return {k: copy.deepcopy(v[i]) for k, v in self._cols.items()}
        raise TypeError(f"index a Table by row number or column name, not {type(key)}")

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for i in range(self._n):
            yield self[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, Table) and self._cols == other._cols

    def __repr__(self) -> str:
        return f"Table(num_rows={self._n}, columns={self.column_names})"

    # ------------------------------------------------------------ transforms
    def select(self, indices: Iterable[int]) -> "Table":
        idx = [int(i) for i in indices]
        return Table({k: [v[i] for i in idx] for k, v in self._cols.items()})

    def shuffle(self, seed: int) -> "Table":
        """The rows in the order ``datasets.Dataset.shuffle(seed=seed)``
        gives them."""
        return self.select(np.random.default_rng(seed).permutation(self._n))

    def map(self, fn: Callable[[Dict[str, Any]], Mapping[str, Any]], **_ignored) -> "Table":
        """``fn(row) -> dict`` for every row: the returned keys update the
        row (new keys become columns). Keyword arguments of
        ``datasets.Dataset.map`` that concern its cache are accepted and
        ignored; batched mapping is not supported."""
        if _ignored.get("batched"):
            raise NotImplementedError("Table.map takes one row at a time")
        rows = []
        for row in self:
            out = fn(row)
            rows.append({**row, **(out if out is not None else {})})
        names = list(dict.fromkeys([*self.column_names, *(k for r in rows for k in r)]))
        return Table({k: [r.get(k) for r in rows] for k in names})

    def filter(self, fn: Callable[[Dict[str, Any]], bool], **_ignored) -> "Table":
        return self.select(i for i, row in enumerate(self) if fn(row))

    def select_columns(self, names: Sequence[str]) -> "Table":
        return Table({k: self._cols[k] for k in names})

    def rename_columns(self, mapping: Mapping[str, str]) -> "Table":
        return Table({mapping.get(k, k): v for k, v in self._cols.items()})


def concatenate_tables(tables: Sequence[Table]) -> Table:
    """Rows of every table in order; the tables must have the same columns
    (in any order)."""
    if not tables:
        return Table({})
    names = tables[0].column_names
    for t in tables[1:]:
        if set(t.column_names) != set(names):
            raise ValueError(f"cannot concatenate tables with columns {names} and "
                             f"{t.column_names}")
    return Table({k: [x for t in tables for x in t._cols[k]] for k in names})
