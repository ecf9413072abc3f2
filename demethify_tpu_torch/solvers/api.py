"""High-level deconvolution: init + solve + restarts.

Counterpart of ``demethify_tpu/solvers/api.py`` for the reference-based
and partial-reference modes. Routing: tensors on ``cuda`` use the kernel
solver (``solvers/fused.py``), tensors on ``cpu`` the plain one
(``solvers/partial_ref.py``); there is no other route. Restarts run as a
sequential loop with one generator each; the batched multi-member kernel
(K4-K6) is ROADMAP port queue item 3. The restart with the lowest cost
wins (first minimum; a NaN cost never wins).
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from demethify_tpu_torch.ops import fista
from demethify_tpu_torch.ops.cost import weighted_cost
from demethify_tpu_torch.ops.nnls import wls_intercept_batch
from demethify_tpu_torch.solvers.fused import partial_ref_solve_fused
from demethify_tpu_torch.solvers.init import init_partial
from demethify_tpu_torch.solvers.partial_ref import partial_ref_solve


@dataclass
class DeconvolutionResult:
    """u: (n_cpg, n_u) unknown profiles (None for supervised);
    proportions: (p, n_s); cost: final weighted cost; n_iter: outer
    iterations of the winning restart; trace: optional cost history."""

    u: Optional[torch.Tensor]
    proportions: torch.Tensor
    cost: float
    n_iter: int
    trace: Optional[torch.Tensor] = None


def restart_generators(seed: int, n_restarts: int, device):
    """One independent generator per restart, seeded from
    ``numpy.random.SeedSequence(seed)``."""
    gens = []
    for child in np.random.SeedSequence(seed).spawn(n_restarts):
        g = torch.Generator(device=device)
        g.manual_seed(int(child.generate_state(1, np.uint64)[0] >> 1))
        gens.append(g)
    return gens


def _select_best(results):
    """First minimum of the restarts' costs; NaN counts as +inf."""
    costs = [float(r[2]["cost"]) for r in results]
    costs = [np.inf if np.isnan(c) else c for c in costs]
    return results[int(np.argmin(costs))]


def supervised_deconv(y, d, R) -> DeconvolutionResult:
    """Reference-based mode: per-sample weighted NNLS with intercept on
    methylated counts (target d*y, weights d), batched over samples."""
    proportions = wls_intercept_batch(d * y, d, R)
    cost = weighted_cost(y, R, proportions, d)
    return DeconvolutionResult(u=None, proportions=proportions,
                               cost=float(cost), n_iter=0)


def partial_reference_deconv(y, d, R_trunc, n_u: int, *,
                             init: str = "uniform_",
                             seed: int = 1,
                             n_restarts: int = 1,
                             n_iter1: int = 10000, n_iter2: int = 20,
                             tol: float = 1e-2,
                             tol_relative: bool = False,
                             record_trace: bool = False,
                             init_provided=None) -> DeconvolutionResult:
    """Partial-reference mode (``--ref --nbunknown k``). ``init_provided``
    = (u0, alpha0) skips the random init (and makes restarts moot)."""
    if y.device.type == "cuda":
        def solve(u0, a0):
            return partial_ref_solve_fused(
                u0, a0, y, d, R_trunc, n_u, n_iter1=n_iter1,
                n_iter2=n_iter2, tol=tol, tol_relative=tol_relative,
                record_trace=record_trace)
    else:
        gram_u = fista.use_gram_u(n_u, y.shape[1], n_iter2)

        def solve(u0, a0):
            return partial_ref_solve(
                u0, a0, y, d, R_trunc, n_u, n_iter1=n_iter1,
                n_iter2=n_iter2, tol=tol, use_gram_u=gram_u,
                tol_relative=tol_relative, record_trace=record_trace)

    if init_provided is not None:
        results = [solve(*init_provided)]
    else:
        results = [solve(*init_partial(g, init, y, d, R_trunc, n_u))
                   for g in restart_generators(seed, n_restarts, y.device)]
    u, alpha, info = _select_best(results)
    return DeconvolutionResult(u=u, proportions=alpha,
                               cost=float(info["cost"]),
                               n_iter=int(info["n_iter"]),
                               trace=info["trace"])
