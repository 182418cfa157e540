"""An in-memory row table: the part of HF ``datasets.Dataset`` that the
data pipeline uses, without ``datasets`` (the card's machine has none).

A :class:`Table` holds named columns of Python values of equal length. It
builds from a dict of columns (``from_dict``), gives rows as dicts
(``table[i]``, iteration) and columns as lists (``table["name"]``), and has
``select``, ``shuffle(seed)`` (the permutation ``datasets`` draws:
``np.random.default_rng(seed).permutation(n)``), ``map`` (row by row or
batched), ``filter``, ``select_columns``, ``rename_columns``,
``add_column``, ``remove_columns``, ``unique``, ``train_test_split`` (the
split ``datasets`` makes) and :func:`concatenate_tables`;
:func:`read_csv` stands in for ``datasets.Dataset.from_csv``. It pickles as
it is, which is how the pipeline's disk cache stores it. A split dict (the
``DatasetDict`` role) is a plain ``dict`` of tables; ``data/arrow_io.py``
reads and writes them as ``datasets`` saves them.

A row handed out is a copy: changing it changes no table, as a row read
from an Arrow table does not.
"""

from __future__ import annotations

import copy
import csv
import math
import re
from typing import Any, Callable, Dict, Iterable, Iterator, List, Mapping, Optional, Sequence

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

    def map(self, fn: Callable, batched: bool = False, batch_size: Optional[int] = 1000,
            with_indices: bool = False, remove_columns: Optional[Sequence[str]] = None,
            **_ignored) -> "Table":
        """``datasets.Dataset.map``: ``fn(row[, index]) -> dict`` for every
        row, or with ``batched``, ``fn(batch[, indices]) -> dict`` for every
        ``batch_size`` rows (a dict of column lists; the output may have
        another number of rows). The returned keys update the row or batch
        (new keys become columns) after the columns in ``remove_columns``
        are dropped. Keyword arguments that concern ``datasets``' cache are
        accepted and ignored."""
        drop = {remove_columns} if isinstance(remove_columns, str) else set(remove_columns or ())
        if not batched:
            rows = []
            for i, row in enumerate(self):
                out = fn(row, i) if with_indices else fn(row)
                kept = {k: v for k, v in row.items() if k not in drop}
                rows.append({**kept, **(out if out is not None else {})})
            names = list(dict.fromkeys(
                [*(k for k in self.column_names if k not in drop), *(k for r in rows for k in r)]))
            return Table({k: [r.get(k) for r in rows] for k in names})
        step = batch_size if batch_size and batch_size > 0 else max(self._n, 1)
        parts = []
        for start in range(0, self._n, step):
            idx = list(range(start, min(start + step, self._n)))
            batch = {k: copy.deepcopy(v[start:start + step]) for k, v in self._cols.items()}
            out = fn(batch, idx) if with_indices else fn(batch)
            kept = {k: batch[k] for k in self.column_names if k not in drop and k in batch}
            merged = {**kept, **(dict(out) if out is not None else {})}
            lengths = {len(v) for v in merged.values()}
            if len(lengths) > 1:
                raise ValueError(f"batched map gave columns of unequal length: "
                                 f"{ {k: len(v) for k, v in merged.items()} }")
            parts.append(Table(merged))
        if not parts:
            return Table({k: [] for k in self.column_names if k not in drop})
        return concatenate_tables(parts)

    def filter(self, fn: Callable[[Dict[str, Any]], bool], **_ignored) -> "Table":
        return self.select(i for i, row in enumerate(self) if fn(row))

    def select_columns(self, names: Sequence[str]) -> "Table":
        return Table({k: self._cols[k] for k in names})

    def rename_columns(self, mapping: Mapping[str, str]) -> "Table":
        return Table({mapping.get(k, k): v for k, v in self._cols.items()})

    def add_column(self, name: str, values: Sequence[Any]) -> "Table":
        if name in self._cols:
            raise ValueError(f"column {name!r} is already in the table")
        return Table({**self._cols, name: list(values)})

    def remove_columns(self, names) -> "Table":
        drop = [names] if isinstance(names, str) else list(names)
        missing = [k for k in drop if k not in self._cols]
        if missing:
            raise ValueError(f"columns {missing} are not in the table {self.column_names}")
        return Table({k: v for k, v in self._cols.items() if k not in drop})

    def unique(self, column: str) -> List[Any]:
        """The column's distinct values in order of first appearance."""
        return list(dict.fromkeys(self._cols[column]))

    def train_test_split(self, test_size=None, train_size=None, shuffle: bool = True,
                         seed: Optional[int] = None, generator=None,
                         **_ignored) -> Dict[str, "Table"]:
        """``{"train", "test"}`` as ``datasets.Dataset.train_test_split``
        makes them: ``n_test = ceil(test_size * n)`` for a float size,
        ``n_train = floor(train_size * n)``, the rest for an unset one; the
        test rows are the first ``n_test`` of the permutation drawn by
        ``np.random.default_rng(seed)`` and the train rows the next
        ``n_train`` (a seed of None is drawn from numpy's global state as
        ``datasets`` draws it)."""
        n = self._n
        if n == 0:
            return {"train": self, "test": self}
        if test_size is None and train_size is None:
            test_size = 0.25
        for name, size in (("test_size", test_size), ("train_size", train_size)):
            if (isinstance(size, int) and not 0 < size < n) or (
                    isinstance(size, float) and not 0 < size < 1):
                raise ValueError(f"{name}={size} should be either positive and smaller than "
                                 f"the number of samples {n} or a float in the (0, 1) range")
        n_test = (math.ceil(test_size * n) if isinstance(test_size, float)
                  else test_size if test_size is not None else None)
        n_train = (math.floor(train_size * n) if isinstance(train_size, float)
                   else train_size if train_size is not None else None)
        if n_train is None:
            n_train = n - n_test
        elif n_test is None:
            n_test = n - n_train
        if n_train + n_test > n or n_train == 0:
            raise ValueError(f"train_size={train_size} and test_size={test_size} do not split "
                             f"{n} rows")
        if not shuffle:
            return {"train": self.select(range(n_train)),
                    "test": self.select(range(n_train, n_train + n_test))}
        if generator is None:
            if seed is None:
                _, keys, pos, *_ = np.random.get_state()
                seed = keys[pos] if pos < 624 else keys[0]
                np.random.random()
            generator = np.random.default_rng(seed)
        perm = generator.permutation(n)
        return {"train": self.select(perm[n_test:n_test + n_train]),
                "test": self.select(perm[:n_test])}


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


# the strings pandas reads as missing (``read_csv``'s default ``na_values``)
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
       "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}
_TRUE, _FALSE = {"True", "TRUE", "true"}, {"False", "FALSE", "false"}
_INT = re.compile(r"^\s*[+-]?\d+\s*$")


def _as_float(x: str) -> Optional[float]:
    try:
        return float(x)
    except ValueError:
        return None


def _column_values(raw: List[Optional[str]]) -> List[Any]:
    """One column's strings as ``Dataset.from_csv`` types them (pandas'
    inference, then Arrow): all missing -> None; every present value an
    integer -> int (float if one is missing); every value a number ->
    float; every value True/False -> bool; else str, missing -> None."""
    present = [x for x in raw if x is not None]
    if not present:
        return [None] * len(raw)
    if all(_INT.match(x) for x in present):
        if len(present) == len(raw):
            return [int(x) for x in raw]
        return [None if x is None else float(int(x)) for x in raw]
    floats = [_as_float(x) for x in present]
    if all(f is not None for f in floats):
        return [None if x is None or math.isnan(float(x)) else float(x) for x in raw]
    if all(x in _TRUE or x in _FALSE for x in present):
        return [None if x is None else x in _TRUE for x in raw]
    return list(raw)


def read_csv(path: str, delimiter: str = ",", **_ignored) -> Table:
    """A CSV/TSV file with a header row as ``datasets.Dataset.from_csv``
    reads it: int64, double, bool or string columns as pandas infers them,
    missing fields (pandas' default NA strings) as None."""
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.reader(f, delimiter=delimiter))
    if not rows:
        return Table({})
    header, body = rows[0], rows[1:]
    cols = {}
    for j, name in enumerate(header):
        raw = [r[j] if j < len(r) else "" for r in body]
        cols[name] = _column_values([None if x in _NA else x for x in raw])
    return Table(cols)
