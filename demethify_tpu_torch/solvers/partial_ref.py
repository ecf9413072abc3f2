"""Partial-reference deconvolution: FISTA block-coordinate descent, plain
PyTorch.

Counterpart of ``demethify_tpu/solvers/partial_ref.py`` (reference
``mdwbssmf_deconv``). Per outer iteration: C/M from one pass over (Y, D),
the U FISTA loop on (C, M), the u-involved Gram blocks, the alpha FISTA
loop on (G, b), and the cost by the Gram identity; stop when
``|cf - cf_prev| < tol``. This is the CPU path and the oracle the kernel
solver (``solvers/fused.py``) is held against on the GPU.

``row_mask`` ((p,) bool) restricts alpha to the rows it keeps, as the JAX
solver's (``solvers/partial_ref.py:43-58``): with the other u columns and
alpha rows starting at zero, the masked solve stays the lower-rank solve
on the kept rows (the model-selection sweep's padded solve).

``row_weights`` ((n_cpg,) nonnegative, the bootstrap's row multiplicities)
solves the problem in which row i appears w_i times, without gathered
copies: the U update is row-separable and stays raw (rows with w = 0 still
move), while every cross-row reduction takes the weights -- the Grams and
the cost, ||Rt||^2 and sum u^2 in the Lipschitz constants, and the max
coverage, taken over the rows with w > 0 only.

bfloat16 storage (y, d, R_trunc bf16; u, alpha and every sum float32) as
the JAX XLA solver runs it: R_trunc stays bf16, so the products that
solver forms in bf16 stay rounded -- the unweighted ||Rt||^2 is a bf16
sum of bf16 squares, the Grams' d y and the residual of C are bf16
(``ops/gram.py``) -- and everything else runs in float32.
"""

import torch

from demethify_tpu_torch.ops import fista
from demethify_tpu_torch.ops.cost import weighted_cost, weighted_cost_gram
from demethify_tpu_torch.ops.gram import (
    accum_dtype,
    coverage_max2,
    known_block_grams,
    row_sum_sq,
    sample_grams_incremental,
    site_curvature,
    u_constant_term,
)
from demethify_tpu_torch.utils import loop_end, loop_test


def partial_ref_solve(u, alpha, y, d, R_trunc, n_u: int,
                      n_iter1: int = 10000, n_iter2: int = 20,
                      tol: float = 1e-2, use_gram_u: bool = True,
                      record_trace: bool = False,
                      tol_relative: bool = False, row_mask=None,
                      row_weights=None):
    """u (n_cpg, n_u), alpha (p, n_s), y, d (n_cpg, n_s), R_trunc
    (n_cpg, n_ct), row_mask (p,) bool or None, row_weights (n_cpg,) or
    None. Returns (u, alpha, info)
    with info = {'cost': 0-d tensor, 'n_iter': int, 'trace': (n_iter1,)
    NaN-padded cost history when record_trace, else empty}."""
    dtype = accum_dtype(y)
    u = u.to(dtype)
    alpha = alpha.to(dtype)
    R0 = torch.cat([R_trunc.to(dtype), u], dim=1)
    dmax2 = coverage_max2(d, row_weights, dtype)
    u_sq = row_sum_sq(row_weights, dtype)
    rt_sq = u_sq(R_trunc)
    l_h = ((rt_sq + u_sq(u)) if row_weights is not None
           else torch.sum(R0 * R0)) * dmax2
    l_w = torch.sum(alpha[-n_u:] ** 2) * dmax2
    cf = weighted_cost(y, R0, alpha, d, row_weights)
    tol = tol * cf if tol_relative else tol
    G_tt, b_t, ydy = known_block_grams(R_trunc, d, y, row_weights)

    trace = torch.full((n_iter1 if record_trace else 0,), float("nan"),
                       dtype=dtype, device=y.device)
    one = torch.ones((), dtype=dtype, device=y.device)
    u_prev, alpha_prev = u, alpha
    a1, a2 = one, one
    l_w_prev, l_h_prev = l_w, l_h
    cf_prev = torch.full((), float("inf"), dtype=dtype, device=y.device)
    if row_mask is not None:
        row_mask = torch.as_tensor(row_mask, device=y.device).to(torch.bool)
    k = 0
    # the test runs in the working dtype, as the JAX while_loop's does
    while k < n_iter1 and loop_test(torch.abs(cf - cf_prev) >= tol,
                                     "partial_ref_solve", k, u=u,
                                     alpha=alpha, cost=cf):
        a1_block, a2_block = alpha[:-n_u], alpha[-n_u:]
        if use_gram_u:
            C = u_constant_term(y, d, R_trunc, a1_block, a2_block)
            M = site_curvature(d, a2_block)
            u, u_prev, a1, l_w_prev = fista.fista_u_gram(
                u, u_prev, a1, l_w_prev, l_w, C, M, n_iter2)
        else:
            u, u_prev, a1, l_w_prev = fista.fista_u_direct(
                u, u_prev, a1, l_w_prev, l_w, y, d, R_trunc,
                a1_block, a2_block, n_iter2)

        G, b = sample_grams_incremental(G_tt, b_t, R_trunc, u, d, y,
                                        row_weights)
        l_h = (rt_sq + u_sq(u)) * dmax2
        alpha, alpha_prev, a2, l_h_prev = fista.fista_alpha_gram(
            alpha, alpha_prev, a2, l_h_prev, l_h, G, b, n_iter2, row_mask)
        l_w = torch.sum(alpha[-n_u:] ** 2) * dmax2
        cf_prev, cf = cf, weighted_cost_gram(G, b, ydy, alpha)
        if record_trace:
            trace[k] = cf
        k += 1
    loop_end("partial_ref_solve", k, u=u, alpha=alpha, cost=cf)
    return u, alpha, {"cost": cf, "n_iter": k, "trace": trace}
