"""Solve statistics, the cost-trace writer and the termination-resolution
warning (counterpart of the same names in ``demethify_tpu/utils.py``)."""

import os
import time
from typing import Optional

import numpy as np
import torch


class SolveStats:
    """Throughput accounting for a solver run, in site-iterations/s."""

    def __init__(self, n_cpg: int, n_samples: int):
        self.n_cpg = n_cpg
        self.n_samples = n_samples
        self._t0 = time.time()
        self.elapsed = None
        self.outer_iters = 0

    def finish(self, outer_iters: int):
        self.elapsed = time.time() - self._t0
        self.outer_iters = int(outer_iters)
        return self

    @property
    def site_iters_per_s(self) -> float:
        if not self.elapsed:
            return 0.0
        return self.n_cpg * max(self.outer_iters, 1) / self.elapsed

    def summary(self) -> str:
        return (f"solver: {self.outer_iters} outer iterations in "
                f"{self.elapsed:.3f}s = "
                f"{self.site_iters_per_s/1e6:.1f}M site-iters/s "
                f"(wall time incl. kernel build and init; see PERF.md for "
                f"device throughput)")


def write_cost_trace(outdir: str, trace, name: str = "cost_trajectory.csv"):
    """Write a NaN-padded cost trajectory as ``iteration,cost`` rows."""
    if isinstance(trace, torch.Tensor):
        trace = trace.detach().cpu().numpy()
    tr = np.asarray(trace, dtype=np.float64)
    tr = tr[~np.isnan(tr)]
    path = os.path.join(outdir, name)
    with open(path, "w") as f:
        f.write("iteration,cost\n")
        for i, c in enumerate(tr):
            f.write(f"{i},{c}\n")
    return path


def termination_resolution_warning(tol: float, cost_scale: float,
                                   compute_dtype) -> Optional[str]:
    """A warning when the absolute test ``|cf - cf_prev| < tol`` is below
    one ulp of the cost (``cost_scale``, e.g. sum(D * Y^2)) in the compute
    dtype, else None."""
    if cost_scale <= 0.0 or tol <= 0.0:
        return None
    finfo = torch.finfo(compute_dtype)
    floor = cost_scale * float(finfo.eps)
    if tol >= floor:
        return None
    name = str(compute_dtype).replace("torch.", "")
    return (f"Warning: --termination {tol:g} is below the "
            f"{name} resolution of the cost "
            f"(~{floor:.3g} at cost magnitude {cost_scale:.3g}); the "
            f"|delta cost| test can only fire on an exact cost plateau "
            f"and the run will likely iterate to the n_iter1 cap. "
            f"Pass --reltol to interpret "
            f"--termination as a fraction of the initial cost, or "
            f"--dtype float64.")
