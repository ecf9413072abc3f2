"""Multi-BED intersection: align CpG rows across reference and sample BEDs
(``demethify-tpu-torch-intersect``).

Counterpart of ``demethify_tpu/preprocessing/intersect.py`` (reference
``preprocessing/intersect_bed.py:18-83``, chained ``bedtools intersect -wa
-wb`` calls): a sorted interval join per chromosome with the same -wa -wb
semantics. Every overlapping (row of A, row of B) pair is kept, in
A-major order, and the joins chain, file by file. Then the joined table
is split back into one ``*_intersect.bed`` per input, under that file's
own header. numpy, without pandas: the tables are read and written by
``io/table.py``, so the files hold the text the JAX tool writes (pandas'
column types, number formats and header renaming).
"""

import argparse
import os
from typing import List

import numpy as np

from demethify_tpu_torch.io.table import Table, read_table, write_table


def _chrom_order(chrom: np.ndarray) -> list:
    """The distinct values of ``chrom`` in their first-appearance order
    (``pd.unique``)."""
    return list(dict.fromkeys(chrom.tolist()))


def _matches(chrom: np.ndarray, c) -> np.ndarray:
    if chrom.dtype == object:
        return np.array([v == c for v in chrom.tolist()], dtype=bool)
    if isinstance(c, str):
        return np.zeros(chrom.shape, dtype=bool)
    return chrom == c


def interval_join(a: Table, b: Table) -> Table:
    """All (row of a, row of b) pairs whose [start, end) intervals overlap
    on the same chromosome (columns 0, 1, 2 of each, by position), a-major
    (bedtools -wa -wb): a's columns then b's, named by position."""
    a_chrom, a_start, a_end = a.columns[:3]
    b_chrom, b_start, b_end = b.columns[:3]
    b_by_chrom = {}
    for c in _chrom_order(b_chrom):
        sel = np.flatnonzero(_matches(b_chrom, c))
        order = sel[np.argsort(b_start[sel], kind="stable")]
        b_by_chrom[c] = (b_start[order], b_end[order], order)

    ai_parts, bi_parts = [], []
    for c in _chrom_order(a_chrom):
        if c not in b_by_chrom:
            continue
        bs, be, b_pos = b_by_chrom[c]
        max_b_end = np.maximum.accumulate(be)
        rows = np.flatnonzero(_matches(a_chrom, c))
        s, e = a_start[rows], a_end[rows]
        lo = np.searchsorted(max_b_end, s, side="right")
        hi = np.searchsorted(bs, e, side="left")
        n = np.maximum(hi - lo, 0)
        if not n.any():
            continue
        # every candidate [lo, hi) of every row, rows in order
        row_of = np.repeat(np.arange(rows.size), n)
        cand = lo[row_of] + (np.arange(row_of.size)
                             - np.repeat(np.cumsum(n) - n, n))
        keep = (bs[cand] < e[row_of]) & (be[cand] > s[row_of])
        ai_parts.append(rows[row_of[keep]])
        bi_parts.append(b_pos[cand[keep]])

    n_cols = len(a.columns) + len(b.columns)
    names = list(range(n_cols))
    if not ai_parts or not sum(p.size for p in ai_parts):
        return Table(names, [np.empty(0) for _ in range(n_cols)])
    ai = np.concatenate(ai_parts)
    bi = np.concatenate(bi_parts)
    order = np.argsort(ai, kind="stable")       # the A file's row order
    ai, bi = ai[order], bi[order]
    return Table(names, [c[ai] for c in a.columns]
                 + [c[bi] for c in b.columns])


def intersect_bed_files(bed_files: List[str],
                        output_folder: str) -> List[str]:
    """Intersect the BED files in turn and write each one's rows of the
    result as ``<name>_intersect.bed`` under ``output_folder``. Returns
    the paths."""
    if len(bed_files) < 2:
        raise ValueError(
            "At least two BED files are required for intersection.")
    for bed_file in bed_files:
        if not os.path.isfile(bed_file):
            raise FileNotFoundError(f"{bed_file} does not exist.")

    tables = [read_table(p) for p in bed_files]
    current = tables[0]
    for nxt in tables[1:]:
        current = interval_join(current, nxt)

    os.makedirs(output_folder, exist_ok=True)
    outputs, start = [], 0
    for bed_file, table in zip(bed_files, tables):
        stop = start + len(table.names)
        out_path = os.path.join(output_folder,
                                os.path.basename(bed_file)[:-4]
                                + "_intersect.bed")
        write_table(out_path, table.names, current.columns[start:stop])
        outputs.append(out_path)
        start = stop

    print("Intersected files created: ", outputs)
    return outputs


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="demethify-tpu-torch-intersect",
        description="Intersect multiple BED files.")
    parser.add_argument('--bed', nargs='+',
                        help="List of BED files to intersect (at least two "
                             "files required).")
    parser.add_argument('--out', nargs='?', type=str, default='.',
                        help='Path to output folder')
    args = parser.parse_args(argv)

    output_folder = os.path.join(os.getcwd(), args.out)
    if not os.path.exists(output_folder):
        print(f'Creating directory {output_folder} to store results')
        os.makedirs(output_folder, exist_ok=True)
    intersect_bed_files(args.bed, output_folder)
    return 0


if __name__ == "__main__":
    main()
