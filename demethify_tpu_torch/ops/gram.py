"""Gram-form precomputations (counterpart of ``demethify_tpu/ops/gram.py``).

  alpha-gradient:  R'(d_s * (y_s - R a_s)) = b_s - G_s a_s
      G_s = R' diag(d_s) R,  b_s = R'(d_s * y_s)
  u-gradient row i:  (d_i * (y_i - Rt a1 - u_i a2)) a2' = C_i - M_i u_i
      C = (D * (Y - Rt a1)) a2',  M_i = a2 diag(d_i) a2'

These are plain einsums outside any kernel, as they are XLA einsums in the
JAX package. ``row_weights`` ((n_cpg,), the bootstrap's row-multiplicity
form) scales every row of the CpG-axis contractions; ``weighted_known_grams``
gives B members' weighted known blocks at once, as matrix products against
the (B, n_cpg) weight rows.
"""

import torch


def accum_dtype(x: torch.Tensor) -> torch.dtype:
    """Accumulation dtype for reductions over the CpG axis: 16-bit storage
    accumulates in float32; float32/float64 stay as they are."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return torch.float32
    return x.dtype


def _weighted(d, row_weights):
    return d if row_weights is None else d * row_weights.to(d.dtype)[:, None]


def coverage_max2(d, row_weights, dtype) -> torch.Tensor:
    """max(D)^2, the Lipschitz constants' coverage factor; with
    ``row_weights`` the max runs over the rows with w > 0 only (a resample
    can drop the max-coverage row)."""
    if row_weights is None:
        return torch.max(d).to(dtype) ** 2
    rowmax = torch.max(d, dim=1).values
    return torch.max(torch.where(row_weights > 0, rowmax,
                                 torch.zeros_like(rowmax))).to(dtype) ** 2


def row_sum_sq(row_weights, dtype):
    """x (n_cpg, k) -> sum(x^2), each row weighted by ``row_weights``
    when given (the ||Rt||^2 and sum u^2 of the Lipschitz constants)."""
    if row_weights is None:
        return lambda x: torch.sum(x * x)
    w = row_weights.to(dtype)[:, None]
    return lambda x: torch.sum(w * x * x)


def sample_grams(R, d, y, row_weights=None):
    """(G (n_s, p, p), b (p, n_s), ydy (n_s,)) in one pass over (Y, D, R),
    each row weighted by ``row_weights`` when given."""
    acc = accum_dtype(y)
    R, d, y = R.to(acc), d.to(acc), y.to(acc)
    dw = _weighted(d, row_weights)
    G = torch.einsum("ip,is,iq->spq", R, dw, R)
    b = torch.einsum("ip,is->ps", R, dw * y)
    ydy = torch.sum(dw * y * y, dim=0)
    return G, b, ydy


def known_block_grams(R_trunc, d, y, row_weights=None):
    """Loop-invariant blocks of R = [Rt | U]: G_tt (n_s, n_ct, n_ct),
    b_t (n_ct, n_s) and ydy (n_s,), computed once before the outer loop."""
    return sample_grams(R_trunc, d, y, row_weights)


def weighted_known_grams(R_trunc, d, y, w_b):
    """B members' weighted known blocks at once: w_b (B, n_cpg) ->
    G_tt (B, n_s, n_ct, n_ct), b_t (B, n_ct, n_s), ydy (B, n_s), each
    member's equal to ``known_block_grams(R_trunc, d, y, w_b[b])``.

    Matrix products of the weight rows against per-sample site products,
    one sample at a time: the largest temporary is (n_cpg, n_ct^2), never
    (B, n_cpg, ...)."""
    acc = accum_dtype(y)
    R, d, y, w_b = (x.to(acc) for x in (R_trunc, d, y, w_b))
    n_b, n_s, n_ct = w_b.shape[0], d.shape[1], R.shape[1]
    rr = (R[:, :, None] * R[:, None, :]).reshape(R.shape[0], n_ct * n_ct)
    G = w_b.new_empty((n_b, n_s, n_ct, n_ct))
    b = w_b.new_empty((n_b, n_ct, n_s))
    dy = d * y
    for s in range(n_s):
        G[:, s] = (w_b @ (d[:, s:s + 1] * rr)).view(n_b, n_ct, n_ct)
        b[:, :, s] = w_b @ (R * dy[:, s:s + 1])
    return G, b, w_b @ (dy * y)


def sample_grams_incremental(G_tt, b_t, R_trunc, u, d, y, row_weights=None):
    """Per-iteration assembly: only the u-involved blocks (G_tu, G_uu, b_u)
    are recomputed, each row weighted by ``row_weights`` when given.
    Equals sample_grams([Rt | u], d, y, row_weights)[:2]."""
    acc = accum_dtype(y)
    R_trunc, u, d, y = (x.to(acc) for x in (R_trunc, u, d, y))
    dw = _weighted(d, row_weights)
    G_tu = torch.einsum("ip,is,iu->spu", R_trunc, dw, u)
    G_uu = torch.einsum("iu,is,iv->suv", u, dw, u)
    b_u = torch.einsum("iu,is->us", u, dw * y)
    top = torch.cat([G_tt, G_tu], dim=2)
    bottom = torch.cat([G_tu.transpose(1, 2), G_uu], dim=2)
    G = torch.cat([top, bottom], dim=1)
    b = torch.cat([b_t, b_u], dim=0)
    return G, b


def site_curvature(d, a2):
    """M_i = a2 diag(d_i) a2': d (n_cpg, n_s), a2 (n_u, n_s) -> (n_cpg,
    n_u, n_u)."""
    return torch.einsum("us,is,vs->iuv", a2, d.to(accum_dtype(d)), a2)


def u_constant_term(y, d, R_trunc, a1, a2):
    """C = (D * (Y - R_trunc a1)) a2' (n_cpg, n_u); R_trunc=None gives the
    Y-only form (no known block)."""
    acc = accum_dtype(y)
    y, d = y.to(acc), d.to(acc)
    resid = y if R_trunc is None else y - R_trunc.to(acc) @ a1
    return (d * resid) @ a2.T
