"""The kernel solver: one pass over the CpG axis per outer iteration.

Counterpart of ``demethify_tpu/solvers/fused.py::partial_ref_solve_fused``
(same arguments and result, minus the TPU knobs ``axis_name``,
``bf16_compute``, ``packed_io`` and ``tile``). The big arrays live
transposed, (rows, n_cpg), which is internal to this module. Each outer
iteration launches K1 (``ops/cuda_kernels.u_phase_grams``: the whole U
FISTA loop plus the new-u Gram blocks) and then K2
(``ops/cuda_small.alpha_phase_full``: Gram assembly, the alpha FISTA
loop, l_w and the Gram-identity cost). The loop-invariant known-block
Grams are computed once before the loop.

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
from demethify_tpu_torch.ops.cuda_small import alpha_phase_full
from demethify_tpu_torch.ops.gram import accum_dtype, known_block_grams


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
    dev = y.device
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    alpha = alpha.to(dtype).contiguous().clone()
    ydt = torch.cat([y.T, d.T], dim=0).to(dtype).contiguous()
    rtt = R_trunc.T.to(dtype).contiguous()
    ut = u.T.to(dtype)
    uut = torch.cat([ut, ut], dim=0).contiguous()
    yt, dt = ydt[:y.shape[1]], ydt[y.shape[1]:]

    dmax2 = torch.max(dt) ** 2
    rt0 = torch.cat([rtt, ut], dim=0)
    l_w0 = torch.sum(alpha[-n_u:] ** 2) * dmax2
    l_h0 = torch.sum(rt0 * rt0) * dmax2
    resid = yt - alpha.T @ rt0
    cf0 = torch.sum(dt * resid * resid)
    G_tt, b_t, ydy = (x.contiguous() for x in
                      known_block_grams(R_trunc.to(dtype), d.to(dtype),
                                        y.to(dtype)))
    rt_sq = torch.sum(rtt * rtt)

    scal = torch.zeros(N_SCAL, dtype=dtype, device=dev)
    scal[A_U] = 1.0
    scal[A_ALPHA] = 1.0
    scal[L_W] = l_w0
    scal[L_W_PREV] = l_w0
    scal[L_H_PREV] = l_h0
    scal[COST] = cf0
    scal[RT_SQ] = rt_sq
    scal[DMAX2] = dmax2
    alpha_prev = alpha.clone()

    cf = np_dtype(cf0.item())
    tol = np_dtype(tol) * cf if tol_relative else np_dtype(tol)
    cf_prev = np_dtype(np.inf)
    costs = []
    k = 0
    while k < n_iter1 and abs(cf - cf_prev) >= tol:
        gu, b_u, usq = u_phase_grams(ydt, rtt, alpha[:-n_u], alpha[-n_u:],
                                     uut, scal, n_iter2)
        alpha_phase_full(G_tt, b_t, gu, b_u, usq, ydy, alpha, alpha_prev,
                         scal, n_iter2, n_u)
        cf_prev, cf = cf, np_dtype(scal[COST].item())   # the host read
        costs.append(cf)
        k += 1

    trace = torch.full((n_iter1 if record_trace else 0,), float("nan"),
                       dtype=dtype, device=dev)
    if record_trace and costs:
        trace[:k] = torch.as_tensor(np.asarray(costs, np_dtype), device=dev)
    u_out = uut[:n_u].T.contiguous()
    return u_out, alpha, {"cost": scal[COST].clone(), "n_iter": k,
                          "trace": trace}
