"""Host-side input readers: bedmethyl (modkit-style) and CSV, without
pandas.

Column conventions are those of ``demethify_tpu/io/readers.py`` (the
reference's ``demethify.py:102-143``):

- bedmethyl (``--bedmethyl``): TSV with header; the reference matrix is
  columns 3+ of the ref BED; per sample ``percent_modified / 100`` and
  ``valid_coverage``, stacked into (n_cpg, n_s) matrices;
- CSV: values are read raw (already in [0, 1]); a single-column sample
  file gets ``valid_coverage = 1``;
- ``--fillna`` replaces NA with 0 in every input.

The native parser (``io/fastbed.py``) reads the files where g++ exists;
otherwise the ``csv`` module does, with the same NA spellings ("", "NA",
"nan", "."). Readers return plain NumPy; the caller moves it to a device.
"""

import csv
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from demethify_tpu_torch.io import fastbed

_NA = {"", "na", "nan", "."}


@dataclass
class Dataset:
    meth_f: np.ndarray                 # (n_cpg, n_s) methylation fractions
    counts: np.ndarray                 # (n_cpg, n_s) coverage weights
    ref: Optional[np.ndarray] = None   # (n_cpg, n_ct) reference profiles
    header: List[str] = field(default_factory=list)  # cell-type names
    sample_names: List[str] = field(default_factory=list)


def _to_float(field_: str) -> float:
    s = field_.strip()
    if s.lower() in _NA:
        return np.nan
    try:
        return float(s)
    except ValueError:
        return np.nan


def _parse_csv_module(path: str, columns: List[str], delim: str):
    with open(path, newline="") as f:
        reader = csv.reader(f, delimiter=delim)
        header = next(reader)
        try:
            idx = [header.index(c) for c in columns]
        except ValueError as e:
            raise KeyError(f"column not found in {path}: {e}") from e
        rows = [[_to_float(r[i]) if i < len(r) else np.nan for i in idx]
                for r in reader if any(x.strip() for x in r)]
    return np.asarray(rows, dtype=np.float64).reshape(len(rows), len(idx))


def parse_columns(path: str, columns: List[str], delim: str,
                  fillna: bool) -> np.ndarray:
    if fastbed.available():
        vals = fastbed.parse_columns(path, columns, delim)
    else:
        vals = _parse_csv_module(path, columns, delim)
    return np.nan_to_num(vals, nan=0.0) if fillna else vals


def read_reference(path: str, delim: str, first_col: int,
                   fillna: bool = False, dtype=np.float64):
    header = fastbed.read_header(path, delim)[first_col:]
    return parse_columns(path, header, delim, fillna).astype(dtype), header


def _check_equal_rows(meth, paths):
    lens = {len(m) for m in meth}
    if len(lens) > 1:
        detail = ", ".join(f"{p.split('/')[-1]}:{len(m)}"
                           for p, m in zip(paths, meth))
        raise ValueError(
            f"Sample files have different CpG row counts ({detail}) — "
            f"intersect them first (demethify-tpu-intersect).")


def read_bedmethyl_samples(paths: List[str], fillna: bool = False,
                           dtype=np.float64):
    meth, counts = [], []
    for bed in paths:
        vals = parse_columns(bed, ["percent_modified", "valid_coverage"],
                             "\t", fillna)
        meth.append(vals[:, 0] / 100.0)
        counts.append(vals[:, 1])
    _check_equal_rows(meth, paths)
    return (np.column_stack(meth).astype(dtype),
            np.column_stack(counts).astype(dtype))


def read_csv_samples(paths: List[str], fillna: bool = False,
                     dtype=np.float64):
    meth, counts = [], []
    for path in paths:
        if len(fastbed.read_header(path, ",")) == 1:
            vals = parse_columns(path, ["percent_modified"], ",", fillna)
            meth.append(vals[:, 0])
            counts.append(np.ones(vals.shape[0]))
        else:
            vals = parse_columns(path, ["percent_modified",
                                        "valid_coverage"], ",", fillna)
            meth.append(vals[:, 0])
            counts.append(vals[:, 1])
    _check_equal_rows(meth, paths)
    return (np.column_stack(meth).astype(dtype),
            np.column_stack(counts).astype(dtype))


def load_dataset(methfreq: List[str], ref: Optional[str] = None,
                 bedmethyl: bool = False, fillna: bool = False,
                 dtype=np.float64) -> Dataset:
    header: List[str] = []
    ref_mat = None
    if bedmethyl:
        if ref:
            ref_mat, header = read_reference(ref, "\t", 3, fillna, dtype)
        meth_f, counts = read_bedmethyl_samples(methfreq, fillna, dtype)
    else:
        if ref:
            ref_mat, header = read_reference(ref, ",", 0, fillna, dtype)
        meth_f, counts = read_csv_samples(methfreq, fillna, dtype)
    if ref_mat is not None and ref_mat.shape[0] != meth_f.shape[0]:
        raise ValueError(
            f"Row mismatch: reference has {ref_mat.shape[0]} CpG rows but "
            f"samples have {meth_f.shape[0]} — intersect the BED files "
            f"first (demethify-tpu-intersect).")
    sample_names = [p.split("/")[-1] for p in methfreq]
    return Dataset(meth_f=meth_f, counts=counts, ref=ref_mat,
                   header=header, sample_names=sample_names)
