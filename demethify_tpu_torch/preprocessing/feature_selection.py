"""CpG panel feature selection: keep the top-n most informative rows of a
reference BED (``demethify-tpu-torch-select``).

Counterpart of ``demethify_tpu/preprocessing/feature_selection.py``
(reference ``preprocessing/feature_selection.py:7-36``): rows are scored
by their variance across the cell types or by their summed |U| leverage
over the SVD's columns, and the n best are written, in score order.

- Below 200,000 rows the scores are numpy's, in float64, on the host.
- From 200,000 rows on they are computed on ``--device`` (default cuda):
  ``torch.var(correction=1)`` or the port's ``ops/tall_svd.tall_svd``, in
  **float32**. That copies a quirk of the JAX tool, whose device path
  runs ``jnp.asarray`` on the float64 values with x64 off, so it computes
  in float32 too.
- The variance ranking is pandas' ``nlargest(n, keep='first')``: a
  stable descending sort (ties in row order). The SVD ranking is
  ``np.argsort(-scores)``, numpy's default sort, as the JAX tool calls it.

The table is read and written by ``io/table.py`` (pandas' text, without
pandas); rows with a missing field are dropped first.
"""

import argparse
import os

import numpy as np

from demethify_tpu_torch.io.table import read_table, write_table

# panels below this row count are scored on the host, in float64
DEVICE_THRESHOLD_ROWS = 200_000


def scores(values: np.ndarray, n: int, method: str,
           force_device: bool = False, device: str = "cuda") -> np.ndarray:
    """(n_rows,) scores of the rows of ``values`` (n_rows, n_cell_types):
    the row variance (``method`` "var") or the summed |U| of the first n
    columns of the thin SVD (``"svd"``). On the host in float64 below
    DEVICE_THRESHOLD_ROWS rows, else (or with ``force_device``) on
    ``device`` in float32 (returned as float32)."""
    if method not in ("var", "svd"):
        raise ValueError("Invalid method! Choose 'var' or 'svd'.")
    if values.shape[0] < DEVICE_THRESHOLD_ROWS and not force_device:
        if method == "var":
            return values.var(axis=1, ddof=1)
        U, _, _ = np.linalg.svd(values, full_matrices=False)
        return np.abs(U[:, :n]).sum(axis=1)

    import torch

    from demethify_tpu_torch.device import resolve_device
    from demethify_tpu_torch.ops.tall_svd import tall_svd

    x = torch.as_tensor(values, dtype=torch.float32).to(
        resolve_device(device))
    if method == "var":
        out = torch.var(x, dim=1, correction=1)
    else:
        U, _, _ = tall_svd(x)
        out = torch.sum(torch.abs(U[:, :n]), dim=1)
    return out.cpu().numpy()


def rank_rows(s: np.ndarray, n: int, method: str) -> np.ndarray:
    """Positions of the n rows kept, in output order."""
    if method == "var":
        # nlargest(keep='first'): descending, ties in row order, NaN last
        return np.argsort(-s, kind="stable")[:n]
    return np.argsort(-s)[:n]


def feature_select(bedfile: str, n: int, output_folder: str,
                   method: str = "svd", device: str = "cuda") -> str:
    """Write the n best rows of ``bedfile`` to
    ``<output_folder>/<name>_select_ref.bed``. Returns its path."""
    table = read_table(bedfile).dropna()
    values = table.values(3)
    kept = table.take(rank_rows(scores(values, n, method, device=device), n,
                                method))
    os.makedirs(output_folder, exist_ok=True)
    output_file = os.path.join(
        output_folder,
        os.path.basename(bedfile).replace(".bed", "_select_ref.bed"))
    return write_table(output_file, kept.names, kept.columns)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="demethify-tpu-torch-select",
        description="Select top N rows using variance or SVD from a BED "
                    "file.")
    parser.add_argument('--bed', type=str, required=True,
                        help='Path to the input BED file')
    parser.add_argument('--n', type=int, required=True,
                        help='Number of top rows to select')
    parser.add_argument('--out', nargs='?', type=str, default='.',
                        help='Path to output folder')
    parser.add_argument('--method', type=str, choices=["var", "svd"],
                        default="svd")
    parser.add_argument('--device', choices=['cuda', 'cpu'], default='cuda',
                        help='Where panels of 200,000 rows and more are '
                             'scored (float32); smaller ones are scored on '
                             'the host in float64')
    args = parser.parse_args(argv)
    feature_select(args.bed, args.n, args.out, args.method, args.device)
    return 0


if __name__ == "__main__":
    main()
