"""The row layout of a row-sharded run.

Counterpart of ``demethify_tpu/parallel/mesh.py``. The JAX package lays
its devices out on a ('replicate', 'cpg') mesh and lets XLA place the
collectives; here each rank is one process with one device, holds one
contiguous block of the CpG rows, and the solvers sum across the ranks
themselves (``parallel/distributed.Axis``). The rows are zero-padded to a
multiple of the rank count, as the JAX package pads them: a padded row
has zero coverage and a zero u, so it adds nothing to any sum over the
CpG axis and its u never moves (every U step's gradient carries its zero
D).
"""

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


def pad_to_multiple(x, multiple: int, axis: int = 0):
    """(x padded with zeros along ``axis`` to a multiple of ``multiple``,
    the original length). x is a numpy array or a tensor."""
    n = x.shape[axis]
    target = math.ceil(n / multiple) * multiple
    if target == n:
        return x, n
    if isinstance(x, torch.Tensor):
        shape = list(x.shape)
        shape[axis] = target - n
        return torch.cat([x, x.new_zeros(shape)], dim=axis), n
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - n)
    return np.pad(x, pad), n


def host_row_block(n_rows: int, n_hosts: int, host_id: int
                   ) -> Tuple[int, int]:
    """Contiguous [start, end) row range of ``host_id`` (balanced: the
    first ``n_rows % n_hosts`` take one extra row)."""
    base, extra = divmod(n_rows, n_hosts)
    start = host_id * base + min(host_id, extra)
    return start, start + base + (1 if host_id < extra else 0)


@dataclass(frozen=True)
class RowBlock:
    """One rank's block of the CpG rows: global rows [start, stop) of the
    ``n_pad`` padded rows (a multiple of the rank count); ``n_rows`` rows
    are data, the rest padding."""

    n_rows: int
    n_pad: int
    start: int
    stop: int

    @property
    def n_data(self) -> int:
        """Rows of this block that are data, not padding."""
        return max(0, min(self.stop, self.n_rows) - self.start)

    def take(self, x, axis: int = 0):
        """This rank's rows of the global ``x`` (a numpy array or a
        tensor, its rows along ``axis``, padded or not)."""
        x, _ = pad_to_multiple(x, self.n_pad // (self.stop - self.start),
                               axis)
        return x[(slice(None),) * axis + (slice(self.start, self.stop),)]


def row_block(n_rows: int, n_ranks: int, rank: int) -> RowBlock:
    """Rank ``rank``'s block when ``n_rows`` rows are padded to a multiple
    of ``n_ranks`` and split into equal contiguous blocks."""
    n_pad = math.ceil(n_rows / n_ranks) * n_ranks
    start, stop = host_row_block(n_pad, n_ranks, rank)
    return RowBlock(n_rows, n_pad, start, stop)
