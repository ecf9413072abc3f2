"""Unsupervised weighted NMF (no reference profiles, R = U), plain
PyTorch.

Counterpart of ``demethify_tpu/solvers/unsupervised.py`` (reference
``unsupervised_deconv``, ``deconvolution.py:107-184``), with the
reference's quirk that the inner-U gradient is taken at the previous
iterate u, not at the extrapolated u_t (``deconvolution.py:163``), kept
for trajectory parity: the ``lagged`` form of ``ops/fista``'s U loops.
The same Gram-form dataflow as ``partial_ref.py``, with the whole factor
as the unknown block. This is the CPU path and the oracle the kernel
solver (``solvers/fused.unsupervised_solve_fused``) is held against on
the GPU. ``row_weights`` is the bootstrap's row-multiplicity form, as in
``partial_ref.py``. ``row_mask`` ((n_u,) bool) restricts alpha to the rows
it keeps, as the JAX solver's does: with the other u columns and alpha
rows starting at zero, the masked solve is the lower-rank solve on the
kept rows (the JAX package's padded sweep; the port's sweep solves each
rank at its own width instead).
"""

import torch

from demethify_tpu_torch.ops import fista
from demethify_tpu_torch.ops.cost import weighted_cost, weighted_cost_gram
from demethify_tpu_torch.ops.gram import (
    accum_dtype,
    coverage_max2,
    row_sum_sq,
    sample_grams,
    site_curvature,
)
from demethify_tpu_torch.utils import loop_end, loop_test


def unsupervised_solve(u, alpha, y, d, n_u: int, n_iter1: int = 10000,
                       n_iter2: int = 20, tol: float = 1e-2,
                       use_gram_u: bool = True, record_trace: bool = False,
                       tol_relative: bool = False, row_mask=None,
                       row_weights=None):
    """u (n_cpg, n_u), alpha (n_u, n_s), y, d (n_cpg, n_s), row_mask
    (n_u,) bool or None, row_weights (n_cpg,) or None. Returns (u, alpha,
    info) as ``partial_ref_solve`` does."""
    dtype = accum_dtype(y)
    u = u.to(dtype)
    alpha = alpha.to(dtype)
    dmax2 = coverage_max2(d, row_weights, dtype)
    u_sq = row_sum_sq(row_weights, dtype)
    l_w = torch.sum(alpha * alpha) * dmax2      # alpha is the unknown block
    l_h = u_sq(u) * dmax2
    cf = weighted_cost(y, u, alpha, d, row_weights)
    tol = tol * cf if tol_relative else tol

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
    while k < n_iter1 and loop_test(torch.abs(cf - cf_prev) >= tol,
                                     "unsupervised_solve", k, u=u,
                                     alpha=alpha, cost=cf):
        if use_gram_u:
            C = (d.to(dtype) * y.to(dtype)) @ alpha.T
            M = site_curvature(d, alpha)
            u, u_prev, a1, l_w_prev = fista.fista_u_gram(
                u, u_prev, a1, l_w_prev, l_w, C, M, n_iter2, lagged=True)
        else:
            u, u_prev, a1, l_w_prev = fista.fista_u_direct(
                u, u_prev, a1, l_w_prev, l_w, y, d, None, None, alpha,
                n_iter2, lagged=True)

        G, b, ydy = sample_grams(u, d, y, row_weights)
        l_h = u_sq(u) * dmax2
        alpha, alpha_prev, a2, l_h_prev = fista.fista_alpha_gram(
            alpha, alpha_prev, a2, l_h_prev, l_h, G, b, n_iter2, row_mask)
        l_w = torch.sum(alpha * alpha) * dmax2
        cf_prev, cf = cf, weighted_cost_gram(G, b, ydy, alpha)
        if record_trace:
            trace[k] = cf
        k += 1
    loop_end("unsupervised_solve", k, u=u, alpha=alpha, cost=cf)
    return u, alpha, {"cost": cf, "n_iter": k, "trace": trace}
