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
                           unknown_header: List[str]) -> str:
    """``methylation_profile_estimate.csv``: one column per unknown cell
    type, no index. (The multi-host part files wait for the
    torch.distributed slice.)"""
    path = os.path.join(outdir, "methylation_profile_estimate.csv")
    _write_rows(path, unknown_header, _cells(np.asarray(u)).tolist())
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
