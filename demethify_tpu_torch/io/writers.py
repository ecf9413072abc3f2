"""Output writers, without pandas, producing the same text as the JAX
package's pandas writers (``demethify_tpu/io/writers.py``): the same
header, the index label ``Cell types``, csv QUOTE_MINIMAL quoting, and
numbers as numpy's ``astype(str)`` renders them (what pandas' ``to_csv``
prints; NaN as an empty field)."""

import csv
import os
from typing import List, Optional

import numpy as np


def _cells(values: np.ndarray) -> np.ndarray:
    text = np.asarray(values).astype(str)
    text[np.isnan(values)] = ""
    return text


def _write_rows(path: str, header, rows) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows(rows)


def write_proportions(outdir: str, proportions: np.ndarray,
                      header: List[str], sample_names: List[str]) -> str:
    """``celltypes_proportions.csv``: index label "Cell types", one
    column per sample file basename. Returns the path."""
    cells = _cells(np.asarray(proportions))
    path = os.path.join(outdir, "celltypes_proportions.csv")
    _write_rows(path, ["Cell types", *sample_names],
                ([name, *row] for name, row in zip(header, cells.tolist())))
    return path


def write_profile_estimate(outdir: str, u: np.ndarray,
                           unknown_header: List[str], suffix: str = "",
                           row_offset: int = 0) -> str:
    """``methylation_profile_estimate<suffix>.csv``: one column per unknown
    cell type, no index. With a ``suffix`` (a multi-process run's
    ``.partNNNN``, one file per rank's block of rows) the first column is
    ``row``, the global row numbers from ``row_offset`` on, as the JAX
    package's part files have it. Returns the path."""
    path = os.path.join(outdir, f"methylation_profile_estimate{suffix}.csv")
    cells = _cells(np.asarray(u))
    if suffix:
        rows = np.arange(row_offset, row_offset + cells.shape[0])
        _write_rows(path, ["row", *unknown_header],
                    ([str(r), *c] for r, c in zip(rows, cells.tolist())))
    else:
        _write_rows(path, unknown_header, cells.tolist())
    return path


def write_log(outdir: str, total_time: float,
              ic_name: Optional[str] = None,
              ic_n_u: Optional[int] = None) -> str:
    path = os.path.join(outdir, "log.log")
    with open(path, "w+") as f:
        f.write("Total execution time = " + str(total_time) + " s" + "\n")
        if ic_name:
            f.write("Number of unknowns that minimises " + ic_name + " : "
                    + str(ic_n_u))
    return path


def _interval(lo, hi) -> str:
    """A "(lo, hi)" cell as pandas renders a tuple of two floats."""
    return str((float(lo), float(hi)))


def write_ci_proportions(outdir: str, lower: np.ndarray, upper: np.ndarray,
                         cell_types: List[str],
                         sample_names: List[str]) -> str:
    """``confidence_interval_celltypes_proportions.csv``: index label
    "Cell Type", one "(lo, hi)" cell per cell type and sample (reference
    ``bootstrap.py:60-70``). lower/upper: (p, n_s). Returns the path."""
    lower, upper = np.asarray(lower), np.asarray(upper)
    path = os.path.join(outdir,
                        "confidence_interval_celltypes_proportions.csv")
    _write_rows(path, ["Cell Type", *sample_names],
                ([name, *(_interval(lo, hi) for lo, hi in zip(lr, hr))]
                 for name, lr, hr in zip(cell_types, lower, upper)))
    return path


def write_ci_profile(outdir: str, lower: np.ndarray, upper: np.ndarray,
                     unknown_header: List[str]) -> str:
    """``confidence_interval_methylation_estimate.csv`` (reference
    ``bootstrap.py:80-89``): one "(lo, hi)" cell per CpG site and unknown
    cell type, no index. lower/upper: (n_cpg, n_u). Returns the path."""
    lo = np.asarray(lower, np.float64).tolist()
    hi = np.asarray(upper, np.float64).tolist()
    path = os.path.join(outdir,
                        "confidence_interval_methylation_estimate.csv")
    with open(path, "w") as f:
        f.write(",".join(unknown_header) + "\n")
        f.writelines(",".join(f'"({a!r}, {b!r})"' for a, b in zip(lr, hr))
                     + "\n" for lr, hr in zip(lo, hi))
    return path
