"""Partial-reference deconvolution: FISTA block-coordinate descent, plain
PyTorch.

Counterpart of ``demethify_tpu/solvers/partial_ref.py`` (reference
``mdwbssmf_deconv``). Per outer iteration: C/M from one pass over (Y, D),
the U FISTA loop on (C, M), the u-involved Gram blocks, the alpha FISTA
loop on (G, b), and the cost by the Gram identity; stop when
``|cf - cf_prev| < tol``. This is the CPU path and the oracle the kernel
solver (``solvers/fused.py``) is held against on the GPU. ``row_mask``
and ``row_weights`` wait for the sweep and bootstrap slices.
"""

import torch

from demethify_tpu_torch.ops import fista
from demethify_tpu_torch.ops.cost import weighted_cost, weighted_cost_gram
from demethify_tpu_torch.ops.gram import (
    accum_dtype,
    known_block_grams,
    sample_grams_incremental,
    site_curvature,
    u_constant_term,
)


def partial_ref_solve(u, alpha, y, d, R_trunc, n_u: int,
                      n_iter1: int = 10000, n_iter2: int = 20,
                      tol: float = 1e-2, use_gram_u: bool = True,
                      record_trace: bool = False,
                      tol_relative: bool = False):
    """u (n_cpg, n_u), alpha (p, n_s), y, d (n_cpg, n_s), R_trunc
    (n_cpg, n_ct). Returns (u, alpha, info) with info = {'cost': 0-d
    tensor, 'n_iter': int, 'trace': (n_iter1,) NaN-padded cost history
    when record_trace, else empty}."""
    dtype = accum_dtype(y)
    u = u.to(dtype)
    alpha = alpha.to(dtype)
    R_trunc = R_trunc.to(dtype)
    R0 = torch.cat([R_trunc, u], dim=1)
    dmax2 = torch.max(d).to(dtype) ** 2
    rt_sq = torch.sum(R_trunc * R_trunc)
    l_h = torch.sum(R0 * R0) * dmax2
    l_w = torch.sum(alpha[-n_u:] ** 2) * dmax2
    cf = weighted_cost(y, R0, alpha, d)
    tol = tol * cf if tol_relative else tol
    G_tt, b_t, ydy = known_block_grams(R_trunc, d, y)

    trace = torch.full((n_iter1 if record_trace else 0,), float("nan"),
                       dtype=dtype, device=y.device)
    one = torch.ones((), dtype=dtype, device=y.device)
    u_prev, alpha_prev = u, alpha
    a1, a2 = one, one
    l_w_prev, l_h_prev = l_w, l_h
    cf_prev = torch.full((), float("inf"), dtype=dtype, device=y.device)
    k = 0
    # the test runs in the working dtype, as the JAX while_loop's does
    while k < n_iter1 and bool(torch.abs(cf - cf_prev) >= tol):
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

        G, b = sample_grams_incremental(G_tt, b_t, R_trunc, u, d, y)
        l_h = (rt_sq + torch.sum(u * u)) * dmax2
        alpha, alpha_prev, a2, l_h_prev = fista.fista_alpha_gram(
            alpha, alpha_prev, a2, l_h_prev, l_h, G, b, n_iter2)
        l_w = torch.sum(alpha[-n_u:] ** 2) * dmax2
        cf_prev, cf = cf, weighted_cost_gram(G, b, ydy, alpha)
        if record_trace:
            trace[k] = cf
        k += 1
    return u, alpha, {"cost": cf, "n_iter": k, "trace": trace}
