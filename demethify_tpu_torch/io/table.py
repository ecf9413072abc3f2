"""Tab-separated tables with a header, read and written as pandas reads
and writes them, without pandas (GPU hosts may not have it).

The preprocessing tools of the JAX package (``preprocessing/intersect.py``,
``feature_selection.py``, ``simulate.py``) go through
``pd.read_csv(path, sep="\\t")`` and ``DataFrame.to_csv(path, sep="\\t")``;
their output text is part of their contract. This module reproduces it:

- **Column types** are inferred per column over every row, before any row
  is dropped, in pandas' order: int64 (every field an integer, none
  missing), float64 (every field a number or missing), bool
  (True/False, none missing), else strings. So an integer column with a
  missing field anywhere is float64 and prints ``1.0``.
- **Missing fields** are pandas' default NA strings (the empty field,
  ``NA``, ``NaN``, ``null``, ...); they print as the empty field.
- **Floats** are parsed as pandas' default C parser parses them
  (``precise_xstrtod``: the first 17 digits accumulated in a double, then
  one multiply or divide by a power of ten), which is not always the
  correctly rounded value; and printed as ``repr`` prints them, as
  pandas does.
- **Duplicate header names** are made unique as pandas makes them
  (``x``, ``x.1``, ...).
- Rows are written by the ``csv`` module with pandas' dialect (tab,
  ``\\n``, minimal quoting), so a lone empty field prints as ``""``.
"""

import csv
import re
from typing import List, Optional, Sequence

import numpy as np

# pandas' default NA strings (``pandas._libs.parsers.STR_NA_VALUES``)
NA_STRINGS = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"])
_TRUE = frozenset(["True", "TRUE", "true"])
_FALSE = frozenset(["False", "FALSE", "false"])
_INF = frozenset(["inf", "+inf", "infinity", "+infinity"])
_INT = re.compile(r"\s*[+-]?\d+\s*\Z")
_NUM = re.compile(r"\s*([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?\s*\Z")
# the powers of ten of the parser's table (correctly rounded literals)
_POW10 = [float(f"1e{k}") for k in range(309)]
_MAX_DIGITS = 17
_INT64_MAX = 2 ** 63 - 1


def parse_float(text: str) -> Optional[float]:
    """``text`` parsed as pandas' default float parser parses it, or None
    where it rejects it (no digits, trailing characters, a result out of
    range)."""
    m = _NUM.match(text)
    if m is None:
        low = text.strip().lower()
        if low in _INF:
            return float("inf")
        if low[:1] == "-" and low[1:] in _INF:
            return float("-inf")
        return None
    sign, whole, frac, exp = m.groups()
    frac = frac or ""
    digits = whole + frac
    if not digits:
        return None
    # the first 17 digits, leading zeros included, accumulate in a double;
    # each further digit of the whole part raises the exponent by one, a
    # further digit of the fraction is dropped
    kept = digits[:_MAX_DIGITS]
    exponent = max(0, len(whole) - _MAX_DIGITS) - (len(kept) - min(
        len(whole), _MAX_DIGITS))
    number = float(int(kept[:15]))         # exact below 2^53
    for ch in kept[15:]:
        number = number * 10.0 + (ord(ch) - 48)
    if sign == "-":
        number = -number
    if exp is not None:
        exponent += int(exp)
    if exponent > 308:
        return None
    if exponent > 0:
        number *= _POW10[exponent]
    elif exponent < -308:
        if exponent < -616:
            number = 0.0
        else:
            number /= _POW10[-308 - exponent]
            number /= _POW10[308]
    else:
        number /= _POW10[-exponent]
    if number in (float("inf"), float("-inf")):
        return None
    return number


def _column(fields: List[str]) -> np.ndarray:
    """One column's fields -> its array, typed as pandas infers it."""
    na = [f in NA_STRINGS for f in fields]
    n_na = sum(na)
    if n_na == 0 and all(_INT.match(f) for f in fields):
        ints = [int(f) for f in fields]
        if all(-_INT64_MAX - 1 <= v <= _INT64_MAX for v in ints):
            return np.array(ints, dtype=np.int64)
    floats = [float("nan") if m else parse_float(f)
              for f, m in zip(fields, na)]
    if all(v is not None for v in floats):
        return np.array(floats, dtype=np.float64)
    if n_na == 0 and all(f in _TRUE or f in _FALSE for f in fields):
        return np.array([f in _TRUE for f in fields], dtype=bool)
    out = np.empty(len(fields), dtype=object)
    out[:] = [float("nan") if m else f for f, m in zip(fields, na)]
    return out


def unique_names(names: Sequence[str]) -> List[str]:
    """Header names made unique as pandas' reader makes them: a repeat of
    ``x`` becomes ``x.1``, ``x.2``, ... (skipping names already taken)."""
    out, counts = [], {}
    for col in names:
        cur = counts.get(col, 0)
        while cur > 0:
            counts[col] = cur + 1
            col = f"{col}.{cur}"
            cur = counts.get(col, 0)
        out.append(col)
        counts[col] = cur + 1
    return out


class Table:
    """Named columns of equal length: int64, float64, bool or object
    (strings, with NaN for a missing field) numpy arrays."""

    def __init__(self, names: Sequence[str], columns: Sequence[np.ndarray]):
        self.names = list(names)
        self.columns = list(columns)

    @property
    def n_rows(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    def take(self, rows) -> "Table":
        """The rows at the integer positions ``rows``, in their order."""
        rows = np.asarray(rows, dtype=np.int64)
        return Table(self.names, [c[rows] for c in self.columns])

    def select(self, lo: int, hi: Optional[int] = None) -> "Table":
        """Columns ``lo:hi`` by position."""
        return Table(self.names[lo:hi], self.columns[lo:hi])

    def na_rows(self) -> np.ndarray:
        """(n_rows,) bool: the rows with a missing field."""
        mask = np.zeros(self.n_rows, dtype=bool)
        for c in self.columns:
            if c.dtype == np.float64:
                mask |= np.isnan(c)
            elif c.dtype == object:
                mask |= np.array([isinstance(v, float) and v != v
                                  for v in c], dtype=bool)
        return mask

    def dropna(self) -> "Table":
        """The rows without a missing field (``DataFrame.dropna()``)."""
        return self.take(np.flatnonzero(~self.na_rows()))

    def values(self, lo: int = 0) -> np.ndarray:
        """Columns ``lo:`` as one float64 (n_rows, k) array."""
        cols = [np.asarray(c, dtype=np.float64) for c in self.columns[lo:]]
        if not cols:
            return np.empty((self.n_rows, 0))
        return np.stack(cols, axis=1)


def read_table(path: str) -> Table:
    """``pd.read_csv(path, sep="\\t")`` without pandas: the header line
    names the columns; blank lines are skipped; a short row is padded
    with missing fields."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f, delimiter="\t") if r]
    if not rows:
        raise ValueError(f"{path}: no header line")
    header = [h if h else f"Unnamed: {i}" for i, h in enumerate(rows[0])]
    names = unique_names(header)
    body = rows[1:]
    n = len(names)
    for r in body:
        if len(r) > n:
            raise ValueError(f"{path}: a row has {len(r)} fields, the "
                             f"header {n}")
    fields = [[r[j] if j < len(r) else "" for r in body] for j in range(n)]
    return Table(names, [_column(col) for col in fields])


def _texts(col: np.ndarray) -> List[str]:
    """One column's fields as ``to_csv`` prints them."""
    if col.dtype == np.float64 or col.dtype == np.float32:
        return ["" if v != v else repr(v) for v in
                col.astype(np.float64).tolist()]
    if col.dtype == object:
        return ["" if isinstance(v, float) and v != v else str(v)
                for v in col.tolist()]
    return [str(v) for v in col.tolist()]


def write_table(path: str, names: Sequence[str],
                columns: Sequence[np.ndarray],
                index: Optional[Sequence[str]] = None) -> str:
    """``DataFrame.to_csv(path, sep="\\t", index=index is not None)``: the
    header, then a row per entry, an index column first (with an empty
    header field) when ``index`` is given. Returns the path."""
    cols = [_texts(np.asarray(c)) for c in columns]
    if index is not None:
        cols.insert(0, [str(v) for v in index])
        names = ["", *names]
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        w.writerow([str(n) for n in names])
        w.writerows(zip(*cols))
    return path
