"""Solve statistics, the cost-trace writer, the termination-resolution
warning, the device trace (``--profile``) and the NaN check
(``--debugnans``): counterparts of the same names in
``demethify_tpu/utils.py``.

``--debugnans`` is a switch of this module (``enable_nan_debugging``), as
``jax_debug_nans`` is a switch of JAX; the CLI sets it from its flag at
the start of every run. JAX checks every jitted computation; the port
checks what a solve hands on. With the switch on, each outer iteration's
host read of the iterative solvers also reads the sums of u, alpha and
the cost, finite exactly when every entry is (``host_read``,
``loop_test``), and raises ``FloatingPointError`` at the first iteration
where they are not, naming the solver, the iteration and the array. The
supervised solve, the inits, each bootstrap replicate and the
model-selection criteria check their outputs once (``check_finite``).
The cost trace is not checked: its NaN padding is not a NaN of the
solution (JAX's ``--debugnans --trace`` raises on that padding at every
run that stops early; the port does not carry that over). With the
switch off nothing of this runs, and every loop launches what it
launches without it.
"""

import contextlib
import math
import os
import time
from typing import Optional

import numpy as np
import torch


_NAN_DEBUG = False


def enable_nan_debugging(on: bool = True) -> None:
    """Turn the ``--debugnans`` checks on (or off)."""
    global _NAN_DEBUG
    _NAN_DEBUG = bool(on)


def nan_debugging() -> bool:
    return _NAN_DEBUG


def _raise_non_finite(solver: str, k: int, named: dict):
    bad = [name for name, x in named.items()
           if x is not None and not bool(torch.isfinite(
               torch.as_tensor(x)).all())]
    where = "at its start" if k == 0 else f"after outer iteration {k}"
    raise FloatingPointError(f"--debugnans: {solver}: non-finite "
                             f"{', '.join(bad) or 'value'} {where}")


def host_read(x: torch.Tensor, solver: str, k: int, **named) -> list:
    """``x`` copied to the host as a flat list of Python numbers, with the
    sum of each of the ``named`` arrays in the same copy: the
    ``--debugnans`` form of an iterative solver's one host read per outer
    iteration. A sum is finite exactly when every entry is (the solver
    state is far from overflowing a sum: u in [0, 1], alpha on the
    simplex), so one reduction an array stands for the flag. Raises
    FloatingPointError naming ``solver``, the iteration ``k`` (0: the
    start) and the array when one is not."""
    dtype = x.dtype if x.dtype.is_floating_point else torch.float64
    host = torch.cat([x.reshape(-1).to(dtype)]
                     + [v.sum(dtype=dtype).reshape(1)
                        for v in named.values() if v is not None]).tolist()
    n = x.numel()
    if not all(math.isfinite(v) for v in host[n:]):
        _raise_non_finite(solver, k, named)
    return host[:n]


def loop_test(test: torch.Tensor, solver: str, k: int, **named) -> bool:
    """``bool(test)``, the plain solvers' loop test and their host read;
    with ``--debugnans`` on, through ``host_read``."""
    if not _NAN_DEBUG:
        return bool(test)
    return bool(host_read(test, solver, k, **named)[0])


def loop_end(solver: str, k: int, **named) -> None:
    """With ``--debugnans`` on, the check of the state a plain solver's
    loop ends with after ``k`` iterations (its loop test is not made
    after the n_iter1-th iteration)."""
    if _NAN_DEBUG:
        host_read(torch.ones(()), solver, k, **named)


def check_finite(what: str, nan_only: bool = False, **named) -> None:
    """With ``--debugnans`` on, FloatingPointError when an array of
    ``named`` (tensors, numpy arrays or floats; None skipped) holds a
    non-finite value (``nan_only``: a NaN, as ``jax_debug_nans`` tests
    it; a criterion may be infinite), naming ``what`` and the array."""
    if not _NAN_DEBUG:
        return
    for name, x in named.items():
        if x is None:
            continue
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x, dtype=np.float64))
        bad = torch.isnan(x) if nan_only else ~torch.isfinite(x)
        if bool(bad.any()):
            raise FloatingPointError(f"--debugnans: {what}: "
                                     f"{'NaN' if nan_only else 'non-finite'}"
                                     f" {name}")


@contextlib.contextmanager
def device_profile(outdir: Optional[str], name: str = "trace.json"):
    """A ``torch.profiler`` trace (the CPU, and the card when there is
    one) around a block, written as Chrome-trace JSON to
    ``outdir/name`` when the block ends (view in Perfetto or
    chrome://tracing). Does nothing when ``outdir`` is None. Yields the
    profiler (None when off)."""
    if not outdir:
        yield None
        return
    os.makedirs(outdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(outdir, name))


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
