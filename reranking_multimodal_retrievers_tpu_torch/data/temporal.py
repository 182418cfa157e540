"""Arrow's date, time and timestamp values as Python values, for the
parquet and Arrow IPC readers (``parquet_io.py``, ``arrow_io.py``).

Each value is what ``pyarrow``'s ``to_pylist()`` gives (and so what
``datasets`` gives for a row), with one rule where that is a ``pandas``
type, which the card's machine cannot build:

- ``date32``/``date64``: ``datetime.date``.
- ``time32``/``time64``: ``datetime.time``; nanoseconds are truncated to
  microseconds, as ``pyarrow`` truncates them.
- ``timestamp`` in seconds, milliseconds or microseconds:
  ``datetime.datetime``, naive without a time zone, else in the column's
  zone (``zoneinfo.ZoneInfo(name)``, or ``datetime.timezone(offset)`` for
  a ``+HH:MM`` zone).
- ``timestamp[ns]`` (and parquet's INT96, which ``pyarrow`` reads as
  naive ``timestamp[ns]``): where ``pyarrow`` gives a ``pandas.Timestamp``,
  this gives a :class:`Timestamp`, a ``datetime.datetime`` whose fields
  hold the value floored to microseconds and whose ``nanosecond``
  attribute (0-999) holds the rest, as ``pandas.Timestamp.nanosecond``
  does. It compares as a ``datetime``, i.e. without its nanoseconds.
"""

from __future__ import annotations

import datetime as _dt
import re
from typing import Iterable, List, Optional

import numpy as np

_EPOCH = _dt.datetime(1970, 1, 1)
_EPOCH_DATE = _dt.date(1970, 1, 1)
_OFFSET = re.compile(r"^([+-])(\d{2}):?(\d{2})$")
# a unit's ticks a microsecond (negative: microseconds a tick)
_PER_US = {"s": -1_000_000, "ms": -1000, "us": 1, "ns": 1000}
UNITS = ("s", "ms", "us", "ns")  # Arrow's TimeUnit enum order


class Timestamp(_dt.datetime):
    """A ``datetime.datetime`` carrying ``nanosecond`` (0-999) beyond its
    ``microsecond``: the stdlib value given where ``pyarrow`` gives a
    ``pandas.Timestamp``."""

    def __new__(cls, *args, nanosecond: int = 0, **kwargs):
        obj = super().__new__(cls, *args, **kwargs)
        obj.nanosecond = nanosecond
        return obj

    def __repr__(self) -> str:
        return f"{super().__repr__()[:-1]}, nanosecond={self.nanosecond})"

    def __reduce_ex__(self, protocol):  # datetime's own drops the nanoseconds
        return (_timestamp, (_dt.datetime(*self.timetuple()[:6], self.microsecond, self.tzinfo),
                             self.nanosecond))


def _timestamp(value: _dt.datetime, nanosecond: int) -> Timestamp:
    return Timestamp(value.year, value.month, value.day, value.hour, value.minute,
                     value.second, value.microsecond, value.tzinfo, nanosecond=nanosecond)


def zone(name: str) -> _dt.tzinfo:
    """The ``tzinfo`` ``pyarrow`` gives for an Arrow time-zone string."""
    m = _OFFSET.match(name)
    if m:
        minutes = int(m.group(2)) * 60 + int(m.group(3))
        return _dt.timezone(_dt.timedelta(minutes=-minutes if m.group(1) == "-" else minutes))
    try:
        from zoneinfo import ZoneInfo

        return ZoneInfo(name)
    except Exception:  # no time-zone database on this machine
        if name.upper() in ("UTC", "Z", "ETC/UTC"):
            return _dt.timezone.utc
        raise NotImplementedError(f"time zone {name!r}: this machine has no time-zone "
                                  "database (the tzdata package) to read it")


def dates(days: Iterable[int]) -> List[_dt.date]:
    """``date32`` values (days since 1970-01-01)."""
    return [_EPOCH_DATE + _dt.timedelta(days=int(d)) for d in days]


def dates_ms(ms: Iterable[int]) -> List[_dt.date]:
    """``date64`` values (milliseconds since 1970-01-01, whole days)."""
    return [_EPOCH_DATE + _dt.timedelta(days=int(v) // 86_400_000) for v in ms]


def times(values: Iterable[int], unit: str) -> List[_dt.time]:
    """``time32``/``time64`` values in ``unit`` since midnight."""
    out = []
    for v in values:
        us = _to_us(int(v), unit)[0]
        s, us = divmod(us, 1_000_000)
        m, s = divmod(s, 60)
        h, m = divmod(m, 60)
        out.append(_dt.time(h, m, s, us))
    return out


def _to_us(v: int, unit: str):
    """(microseconds floored, nanoseconds beyond them) of ``v`` ticks."""
    per = _PER_US[unit]
    if per < 0:
        return v * -per, 0
    return divmod(v, per) if per > 1 else (v, 0)


def timestamps(values: Iterable[int], unit: str, tz: Optional[str] = None) -> List[_dt.datetime]:
    """``timestamp[unit, tz]`` values (ticks since the Unix epoch, UTC)."""
    tzinfo = zone(tz) if tz else None
    out = []
    for v in values:
        us, ns = _to_us(int(v), unit)
        d = _EPOCH + _dt.timedelta(microseconds=us)
        if tzinfo is not None:
            d = d.replace(tzinfo=_dt.timezone.utc).astimezone(tzinfo)
        out.append(_timestamp(d, ns) if unit == "ns" else d)
    return out


def int96_nanoseconds(raw: np.ndarray) -> np.ndarray:
    """Parquet INT96 timestamps (12 bytes each: nanoseconds of the day as
    a little-endian int64, then the Julian day as an int32) as int64
    nanoseconds since the Unix epoch, as ``pyarrow`` converts them."""
    rec = raw.view(np.dtype([("ns", "<i8"), ("jd", "<i4")]))
    return (rec["jd"].astype(np.int64) - 2_440_588) * 86_400_000_000_000 + rec["ns"]
