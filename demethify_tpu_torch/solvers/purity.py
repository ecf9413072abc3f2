"""Purity-constrained partial-reference deconvolution, plain PyTorch.

Counterpart of ``demethify_tpu/solvers/purity.py`` (reference
``mdwbssmf_deconv_p``, ``deconvolution.py:305-337``): the U update of the
partial-reference solve, then ``n_iter2`` (default 500) Frank-Wolfe steps
on alpha over the per-sample purity-scaled simplexes, on the per-sample
Grams (``ops/frank_wolfe.frank_wolfe_gram``); the termination cost falls
out of the same Grams. This is the CPU path and the oracle the kernel
solver (``solvers/fused.purity_solve_fused``) is held against on the GPU.
``row_weights`` is the bootstrap's row-multiplicity form, as in
``partial_ref.py``.
"""

import torch

from demethify_tpu_torch.ops import fista
from demethify_tpu_torch.ops.cost import weighted_cost, weighted_cost_gram
from demethify_tpu_torch.ops.frank_wolfe import frank_wolfe_gram
from demethify_tpu_torch.ops.gram import (
    accum_dtype,
    coverage_max2,
    known_block_grams,
    sample_grams_incremental,
    site_curvature,
    u_constant_term,
)
from demethify_tpu_torch.utils import loop_end, loop_test


def purity_solve(u, alpha, y, d, R_trunc, purity, n_u: int,
                 n_iter1: int = 100, n_iter2: int = 500, tol: float = 1e-2,
                 use_gram_u: bool = True, record_trace: bool = False,
                 tol_relative: bool = False, row_weights=None):
    """u (n_cpg, n_u); alpha (p, n_s) stacked [known; unknown]; purity
    (n_s,) the known-block mass of each sample, already flipped to
    1 - p/100 (reference ``demethify.py:77``); row_weights (n_cpg,) or
    None. Returns (u, alpha, info) as ``partial_ref_solve`` does."""
    dtype = accum_dtype(y)
    u = u.to(dtype)
    alpha = alpha.to(dtype)
    if accum_dtype(purity) == purity.dtype:
        # a 16-bit purity stays so, as in the JAX solver: its
        # Frank-Wolfe step rounds 1 - purity to the storage dtype
        purity = purity.to(dtype)
    dmax2 = coverage_max2(d, row_weights, dtype)
    R0 = torch.cat([R_trunc.to(dtype), u], dim=1)
    l_w = torch.sum(alpha[-n_u:] ** 2) * dmax2
    cf = weighted_cost(y, R0, alpha, d, row_weights)
    tol = tol * cf if tol_relative else tol
    G_tt, b_t, ydy = known_block_grams(R_trunc, d, y, row_weights)

    trace = torch.full((n_iter1 if record_trace else 0,), float("nan"),
                       dtype=dtype, device=y.device)
    u_prev = u
    a1 = torch.ones((), dtype=dtype, device=y.device)
    l_w_prev = l_w
    cf_prev = torch.full((), float("inf"), dtype=dtype, device=y.device)
    k = 0
    while k < n_iter1 and loop_test(torch.abs(cf - cf_prev) >= tol,
                                     "purity_solve", k, u=u,
                                     alpha=alpha, cost=cf):
        a1_block, a2_block = alpha[:-n_u], alpha[-n_u:]
        if use_gram_u:
            C = u_constant_term(y, d, R_trunc, a1_block, a2_block)
            M = site_curvature(d, a2_block)
            u, u_prev, a1, l_w_prev = fista.fista_u_gram(
                u, u_prev, a1, l_w_prev, l_w, C, M, n_iter2)
        else:
            u, u_prev, a1, l_w_prev = fista.fista_u_direct(
                u, u_prev, a1, l_w_prev, l_w, y, d, R_trunc, a1_block,
                a2_block, n_iter2)

        G, b = sample_grams_incremental(G_tt, b_t, R_trunc, u, d, y,
                                        row_weights)
        alpha1, alpha2 = frank_wolfe_gram(a1_block, a2_block, G, b, purity,
                                          n_iter2)
        alpha = torch.cat([alpha1, alpha2], dim=0)
        l_w = torch.sum(alpha2 * alpha2) * dmax2
        cf_prev, cf = cf, weighted_cost_gram(G, b, ydy, alpha)
        if record_trace:
            trace[k] = cf
        k += 1
    loop_end("purity_solve", k, u=u, alpha=alpha, cost=cf)
    return u, alpha, {"cost": cf, "n_iter": k, "trace": trace}
