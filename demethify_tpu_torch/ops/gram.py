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

Every CpG-axis reduction takes its inputs in row chunks of CHUNK_ROWS,
each upcast on its own to the accumulation dtype (bf16 -> float32 is
exact), so no copy of the whole Y, D or R is made and no (n_cpg, ...)
temporary outlives its chunk; under float32 and float64 the upcast is a
view, and an array of up to CHUNK_ROWS rows is one chunk. Each chunk
costs the host about 60 operator calls in a solve's set-up, so chunks
are large (256k rows: four at 1M sites), while a chunk's temporaries
stay a few (rows, n_s) and (rows, p^2) arrays; the (rows, p^2) pair
products take fewer rows a chunk where they would pass GRAM_PAIR_BYTES
(``pair_chunk_rows``: above p = 45 in float64, 64 in float32). Under bfloat16
storage every sum runs in float32, and products of bf16 values round
where the JAX package's solvers, as XLA compiles them, round: a product
that feeds a float32 sum is exact (d y in b, the Grams' d), ydy takes d y
rounded to bf16 times y, ``u_constant_term`` rounds the known part and the
residual, and the unweighted ||Rt||^2 rounds its float32 sum
(``row_sum_sq``).
"""

import torch

from demethify_tpu_torch.device import state_dtype

CHUNK_ROWS = 1 << 18
# bytes of the (rows, p^2) pair products of one chunk of the Gram sums
GRAM_PAIR_BYTES = 1 << 32


def accum_dtype(x: torch.Tensor) -> torch.dtype:
    """Accumulation dtype for reductions over the CpG axis: 16-bit storage
    accumulates in float32; float32/float64 stay as they are."""
    return state_dtype(x.dtype)


def row_chunks(n: int, chunk: int = CHUNK_ROWS):
    """[lo, hi) bounds of the row chunks the CpG-axis sums take."""
    return [(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]


def pair_chunk_rows(p: int, dtype: torch.dtype) -> int:
    """Rows per chunk of the Gram sums' (rows, p^2) pair products in
    ``dtype``: CHUNK_ROWS, or as many as GRAM_PAIR_BYTES hold."""
    per_row = p * p * torch.finfo(dtype).bits // 8
    return max(1, min(CHUNK_ROWS, GRAM_PAIR_BYTES // max(per_row, 1)))


def coverage_max(d, row_weights=None) -> torch.Tensor:
    """max(D) in d's dtype; with ``row_weights`` over the rows with w > 0
    only (a resample can drop the max-coverage row)."""
    if row_weights is None:
        return torch.max(d)
    rowmax = torch.max(d, dim=1).values
    return torch.max(torch.where(row_weights > 0, rowmax,
                                 torch.zeros_like(rowmax)))


def coverage_max2(d, row_weights, dtype) -> torch.Tensor:
    """max(D)^2, the Lipschitz constants' coverage factor, squared in
    ``dtype`` (the plain solvers; the JAX XLA solvers cast, then square)."""
    return coverage_max(d, row_weights).to(dtype) ** 2


def row_sum_sq(row_weights, dtype):
    """x (n_cpg, k) -> sum(x^2) in ``dtype``, each row weighted by
    ``row_weights`` when given (the ||Rt||^2 and sum u^2 of the Lipschitz
    constants). Unweighted, a 16-bit x gives what the JAX XLA solvers'
    ``jnp.sum(R * R)`` compiles to: the squares summed in float32, the
    sum rounded once to the storage dtype."""
    if row_weights is None:
        def sq(x):
            total = sum(torch.sum(xc * xc) for xc in
                        (x[lo:hi].to(dtype) for lo, hi in
                         row_chunks(x.shape[0])))
            return total.to(x.dtype).to(dtype)
        return sq
    w = row_weights.to(dtype)[:, None]
    return lambda x: torch.sum(w * x * x)


def storage_dy(d, y, acc):
    """(d y, d y y) in ``acc``, as the JAX package's compiled programs
    form them under 16-bit storage: d y exact (the product of two bf16
    values is exact in float32), and d y y from d y rounded to the
    storage dtype, times y in float32. Under float32 and float64 plainly
    d y and (d y) y."""
    dc, yc = d.to(acc), y.to(acc)
    return dc * yc, (d * y).to(acc) * yc


def sample_grams(R, d, y, row_weights=None):
    """(G (n_s, p, p), b (p, n_s), ydy (n_s,)) in one pass over (Y, D, R),
    each row weighted by ``row_weights`` when given."""
    acc = accum_dtype(y)
    n_s, p = d.shape[1], R.shape[1]
    G = torch.zeros((n_s, p, p), dtype=acc, device=y.device)
    b = torch.zeros((p, n_s), dtype=acc, device=y.device)
    ydy = torch.zeros((n_s,), dtype=acc, device=y.device)
    for lo, hi in row_chunks(y.shape[0], pair_chunk_rows(p, acc)):
        Rc, dc = R[lo:hi].to(acc), d[lo:hi].to(acc)
        dy, dyy = storage_dy(d[lo:hi], y[lo:hi], acc)
        if row_weights is not None:
            w = row_weights[lo:hi].to(acc)[:, None]
            dc, dy, dyy = dc * w, dy * w, dyy * w
        rr = (Rc[:, :, None] * Rc[:, None, :]).reshape(hi - lo, p * p)
        G += (dc.T @ rr).view(n_s, p, p)
        b += Rc.T @ dy
        ydy += torch.sum(dyy, dim=0)
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
    one sample at a time: the largest temporary is (rows, n_ct^2) of one
    row chunk, never (B, n_cpg, ...)."""
    acc = accum_dtype(y)
    n_b, n_s, n_ct = w_b.shape[0], d.shape[1], R_trunc.shape[1]
    w_b = w_b.to(acc)
    G = w_b.new_zeros((n_b, n_s, n_ct, n_ct))
    b = w_b.new_zeros((n_b, n_ct, n_s))
    ydy = w_b.new_zeros((n_b, n_s))
    for lo, hi in row_chunks(y.shape[0], pair_chunk_rows(n_ct, acc)):
        R, dc, w = R_trunc[lo:hi].to(acc), d[lo:hi].to(acc), w_b[:, lo:hi]
        dy, dyy = storage_dy(d[lo:hi], y[lo:hi], acc)
        rr = (R[:, :, None] * R[:, None, :]).reshape(hi - lo, n_ct * n_ct)
        for s in range(n_s):
            G[:, s] += (w @ (dc[:, s:s + 1] * rr)).view(n_b, n_ct, n_ct)
            b[:, :, s] += w @ (R * dy[:, s:s + 1])
        ydy += w @ dyy
    return G, b, ydy


def sample_grams_incremental(G_tt, b_t, R_trunc, u, d, y, row_weights=None):
    """Per-iteration assembly: only the u-involved blocks (G_tu, G_uu, b_u)
    are recomputed, each row weighted by ``row_weights`` when given.
    Equals sample_grams([Rt | u], d, y, row_weights)[:2]."""
    acc = accum_dtype(y)
    n_s, n_ct, n_u = d.shape[1], R_trunc.shape[1], u.shape[1]
    G_tu = torch.zeros((n_s, n_ct, n_u), dtype=acc, device=y.device)
    G_uu = torch.zeros((n_s, n_u, n_u), dtype=acc, device=y.device)
    b_u = torch.zeros((n_u, n_s), dtype=acc, device=y.device)
    for lo, hi in row_chunks(y.shape[0]):
        R, uc, dc = R_trunc[lo:hi].to(acc), u[lo:hi].to(acc), d[lo:hi].to(acc)
        dy = dc * y[lo:hi].to(acc)
        if row_weights is not None:
            w = row_weights[lo:hi].to(acc)[:, None]
            dc, dy = dc * w, dy * w
        G_tu += torch.einsum("ip,is,iu->spu", R, dc, uc)
        G_uu += torch.einsum("iu,is,iv->suv", uc, dc, uc)
        b_u += torch.einsum("iu,is->us", uc, dy)
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
    Y-only form (no known block). Under 16-bit storage the known part
    R_trunc a1 and the residual are rounded to the storage dtype, and d
    times the residual is exact in float32, as the JAX package's
    ``u_constant_term`` compiles inside its solvers' loops."""
    acc = accum_dtype(y)
    resid = y if R_trunc is None else y - (R_trunc.to(acc) @ a1).to(y.dtype)
    return (d.to(acc) * resid.to(acc)) @ a2.T
