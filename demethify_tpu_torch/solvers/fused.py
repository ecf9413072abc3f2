"""The kernel solvers: one pass over the CpG axis per outer iteration.

Counterparts of ``partial_ref_solve_fused``, ``unsupervised_solve_fused``
and ``purity_solve_fused`` of ``demethify_tpu/solvers/fused.py`` (same
arguments and results, minus the TPU knobs ``axis_name``,
``bf16_compute``, ``packed_io`` and ``tile``). The big arrays live
transposed, (rows, n_cpg), which is internal to this module. Each outer
iteration launches K1 (``ops/cuda_kernels.u_phase_grams``: the whole U
FISTA loop plus the new-u Gram blocks) and then one single-block kernel
on the Grams: K2 (``ops/cuda_small.alpha_phase_full``: the alpha FISTA
loop) in the partial-reference and unsupervised solves, K3
(``ops/cuda_small.fw_phase_full``: the Frank-Wolfe loop) in the purity
solve; each also writes l_w and the Gram-identity cost. Loop-invariant
known-block Grams are computed once before the loop.

The solver's scalars stay on the device (``cuda_kernels.N_SCAL`` slots);
the only host read per outer iteration is the cost, for the reference's
termination test ``|cf - cf_prev| >= tol``, made in the working dtype as
the JAX while_loop makes it.
"""

import numpy as np
import torch

from demethify_tpu_torch.ops.cuda_kernels import (
    A_ALPHA,
    A_U,
    COST,
    DMAX2,
    L_H_PREV,
    L_W,
    L_W_PREV,
    N_SCAL,
    RT_SQ,
    u_phase_grams,
)
from demethify_tpu_torch.ops.cuda_small import alpha_phase_full, fw_phase_full
from demethify_tpu_torch.ops.gram import accum_dtype, known_block_grams


def _transposed(u, y, d, R_trunc, dtype):
    """ydt (2 n_s, N) = [Y.T; D.T], rtt (n_ct, N) = Rt.T (None without a
    known block), uut (2 n_u, N) = [u.T; u.T], and dmax^2."""
    ydt = torch.cat([y.T, d.T], dim=0).to(dtype).contiguous()
    rtt = None if R_trunc is None else R_trunc.T.to(dtype).contiguous()
    ut = u.T.to(dtype)
    uut = torch.cat([ut, ut], dim=0).contiguous()
    dmax2 = torch.max(ydt[y.shape[1]:]) ** 2
    return ydt, rtt, uut, dmax2


def _cost_t(ydt, rt_full, alpha):
    n_s = alpha.shape[1]
    resid = ydt[:n_s] - alpha.T @ rt_full
    return torch.sum(ydt[n_s:] * resid * resid)


def _scalars(dtype, device, **slots):
    scal = torch.zeros(N_SCAL, dtype=dtype, device=device)
    names = {"a_u": A_U, "l_w": L_W, "l_w_prev": L_W_PREV,
             "a_alpha": A_ALPHA, "l_h_prev": L_H_PREV, "cost": COST,
             "rt_sq": RT_SQ, "dmax2": DMAX2}
    for name, value in slots.items():
        scal[names[name]] = value
    return scal


def _outer_loop(one_iteration, scal, n_iter1, tol, tol_relative,
                record_trace):
    """Calls ``one_iteration()`` until ``|cf - cf_prev| < tol`` or n_iter1
    calls; reads scal[COST] once per call. Returns (n_iter, trace)."""
    dtype = scal.dtype
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    cf = np_dtype(scal[COST].item())
    tol = np_dtype(tol) * cf if tol_relative else np_dtype(tol)
    cf_prev = np_dtype(np.inf)
    costs = []
    while len(costs) < n_iter1 and abs(cf - cf_prev) >= tol:
        one_iteration()
        cf_prev, cf = cf, np_dtype(scal[COST].item())   # the host read
        costs.append(cf)
    trace = torch.full((n_iter1 if record_trace else 0,), float("nan"),
                       dtype=dtype, device=scal.device)
    if record_trace and costs:
        trace[:len(costs)] = torch.as_tensor(np.asarray(costs, np_dtype),
                                             device=scal.device)
    return len(costs), trace


def partial_ref_solve_fused(u, alpha, y, d, R_trunc, n_u: int,
                            n_iter1: int = 10000, n_iter2: int = 20,
                            tol: float = 1e-2, record_trace: bool = False,
                            tol_relative: bool = False):
    """Same trajectory as ``solvers/partial_ref.partial_ref_solve``.

    u (n_cpg, n_u), alpha (p, n_s), y, d (n_cpg, n_s), R_trunc
    (n_cpg, n_ct), all on one device. Returns (u, alpha, info) with
    info = {'cost': 0-d tensor, 'n_iter': int, 'trace': (n_iter1,)
    NaN-padded cost history when record_trace, else empty}.
    """
    dtype = accum_dtype(y)
    alpha = alpha.to(dtype).contiguous().clone()
    ydt, rtt, uut, dmax2 = _transposed(u, y, d, R_trunc, dtype)
    rt0 = torch.cat([rtt, uut[:n_u]], dim=0)
    l_w0 = torch.sum(alpha[-n_u:] ** 2) * dmax2
    G_tt, b_t, ydy = (x.contiguous() for x in
                      known_block_grams(R_trunc.to(dtype), d.to(dtype),
                                        y.to(dtype)))
    rt_sq = torch.sum(rtt * rtt)
    scal = _scalars(dtype, y.device, a_u=1.0, a_alpha=1.0, l_w=l_w0,
                    l_w_prev=l_w0, l_h_prev=torch.sum(rt0 * rt0) * dmax2,
                    cost=_cost_t(ydt, rt0, alpha), rt_sq=rt_sq, dmax2=dmax2)
    alpha_prev = alpha.clone()

    def one_iteration():
        gu, b_u, usq = u_phase_grams(ydt, rtt, alpha[:-n_u], alpha[-n_u:],
                                     uut, scal, n_iter2)
        alpha_phase_full(G_tt, b_t, gu, b_u, usq, ydy, alpha, alpha_prev,
                         scal, n_iter2, n_u)

    k, trace = _outer_loop(one_iteration, scal, n_iter1, tol, tol_relative,
                           record_trace)
    return uut[:n_u].T.contiguous(), alpha, {
        "cost": scal[COST].clone(), "n_iter": k, "trace": trace}


def unsupervised_solve_fused(u, alpha, y, d, n_u: int, n_iter1: int = 10000,
                             n_iter2: int = 20, tol: float = 1e-2,
                             record_trace: bool = False,
                             tol_relative: bool = False):
    """Same trajectory as ``solvers/unsupervised.unsupervised_solve``
    (R = U, the lagged u-gradient): K1 without a known block, lagged,
    then K2 without a known block (||Rt||^2 = 0). u (n_cpg, n_u), alpha
    (n_u, n_s). Returns (u, alpha, info) as
    ``partial_ref_solve_fused``."""
    dtype = accum_dtype(y)
    n_s = y.shape[1]
    alpha = alpha.to(dtype).contiguous().clone()
    ydt, _, uut, dmax2 = _transposed(u, y, d, None, dtype)
    ut = uut[:n_u]
    l_w0 = torch.sum(alpha * alpha) * dmax2
    ydy = torch.sum(ydt[n_s:] * ydt[:n_s] * ydt[:n_s], dim=1).contiguous()
    G_tt = ydt.new_empty((n_s, 0, 0))
    b_t = ydt.new_empty((0, n_s))
    scal = _scalars(dtype, y.device, a_u=1.0, a_alpha=1.0, l_w=l_w0,
                    l_w_prev=l_w0, l_h_prev=torch.sum(ut * ut) * dmax2,
                    cost=_cost_t(ydt, ut, alpha), dmax2=dmax2)
    alpha_prev = alpha.clone()

    def one_iteration():
        gu, b_u, usq = u_phase_grams(ydt, None, None, alpha, uut, scal,
                                     n_iter2, lagged=True)
        alpha_phase_full(G_tt, b_t, gu, b_u, usq, ydy, alpha, alpha_prev,
                         scal, n_iter2, n_u)

    k, trace = _outer_loop(one_iteration, scal, n_iter1, tol, tol_relative,
                           record_trace)
    return uut[:n_u].T.contiguous(), alpha, {
        "cost": scal[COST].clone(), "n_iter": k, "trace": trace}


def purity_solve_fused(u, alpha, y, d, R_trunc, purity, n_u: int,
                       n_iter1: int = 100, n_iter2: int = 500,
                       tol: float = 1e-2, record_trace: bool = False,
                       tol_relative: bool = False):
    """Same trajectory as ``solvers/purity.purity_solve``: K1 (n_iter2
    steps, default 500) then K3, the whole Frank-Wolfe loop. purity (n_s,)
    is the flipped known-block mass 1 - p/100. Returns (u, alpha, info) as
    ``partial_ref_solve_fused``."""
    dtype = accum_dtype(y)
    alpha = alpha.to(dtype).contiguous().clone()
    purity = purity.to(device=y.device, dtype=dtype).contiguous()
    ydt, rtt, uut, dmax2 = _transposed(u, y, d, R_trunc, dtype)
    rt0 = torch.cat([rtt, uut[:n_u]], dim=0)
    l_w0 = torch.sum(alpha[-n_u:] ** 2) * dmax2
    G_tt, b_t, ydy = (x.contiguous() for x in
                      known_block_grams(R_trunc.to(dtype), d.to(dtype),
                                        y.to(dtype)))
    scal = _scalars(dtype, y.device, a_u=1.0, l_w=l_w0, l_w_prev=l_w0,
                    cost=_cost_t(ydt, rt0, alpha), dmax2=dmax2)

    def one_iteration():
        gu, b_u, _ = u_phase_grams(ydt, rtt, alpha[:-n_u], alpha[-n_u:],
                                   uut, scal, n_iter2)
        fw_phase_full(G_tt, b_t, gu, b_u, ydy, alpha, purity, scal, n_iter2,
                      n_u)

    k, trace = _outer_loop(one_iteration, scal, n_iter1, tol, tol_relative,
                           record_trace)
    return uut[:n_u].T.contiguous(), alpha, {
        "cost": scal[COST].clone(), "n_iter": k, "trace": trace}
