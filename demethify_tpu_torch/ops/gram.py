"""Gram-form precomputations (counterpart of ``demethify_tpu/ops/gram.py``).

  alpha-gradient:  R'(d_s * (y_s - R a_s)) = b_s - G_s a_s
      G_s = R' diag(d_s) R,  b_s = R'(d_s * y_s)
  u-gradient row i:  (d_i * (y_i - Rt a1 - u_i a2)) a2' = C_i - M_i u_i
      C = (D * (Y - Rt a1)) a2',  M_i = a2 diag(d_i) a2'

These are plain einsums outside any kernel, as they are XLA einsums in the
JAX package. Row weights (the bootstrap's form) wait for the bootstrap
slice.
"""

import torch


def accum_dtype(x: torch.Tensor) -> torch.dtype:
    """Accumulation dtype for reductions over the CpG axis: 16-bit storage
    accumulates in float32; float32/float64 stay as they are."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return torch.float32
    return x.dtype


def sample_grams(R, d, y):
    """(G (n_s, p, p), b (p, n_s), ydy (n_s,)) in one pass over (Y, D, R)."""
    acc = accum_dtype(y)
    R, d, y = R.to(acc), d.to(acc), y.to(acc)
    G = torch.einsum("ip,is,iq->spq", R, d, R)
    b = torch.einsum("ip,is->ps", R, d * y)
    ydy = torch.sum(d * y * y, dim=0)
    return G, b, ydy


def known_block_grams(R_trunc, d, y):
    """Loop-invariant blocks of R = [Rt | U]: G_tt (n_s, n_ct, n_ct),
    b_t (n_ct, n_s) and ydy (n_s,), computed once before the outer loop."""
    return sample_grams(R_trunc, d, y)


def sample_grams_incremental(G_tt, b_t, R_trunc, u, d, y):
    """Per-iteration assembly: only the u-involved blocks (G_tu, G_uu, b_u)
    are recomputed. Equals sample_grams([Rt | u], d, y)[:2]."""
    acc = accum_dtype(y)
    R_trunc, u, d, y = (x.to(acc) for x in (R_trunc, u, d, y))
    G_tu = torch.einsum("ip,is,iu->spu", R_trunc, d, u)
    G_uu = torch.einsum("iu,is,iv->suv", u, d, u)
    b_u = torch.einsum("iu,is->us", u, d * y)
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
