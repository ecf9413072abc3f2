"""Weighted NNLS with intercept: the reference-based solver.

Counterpart of ``demethify_tpu/ops/nnls.py`` (the reference's
``wls_intercept`` = sklearn ``LinearRegression(positive=True)`` with sample
weights, coefficients normalised to the simplex with a 1e-10 sum floor).
The NNLS runs on the (p, p) normal equations with monotone FISTA plus an
exact least-squares polish on the detected support. Samples are an
explicit leading batch dimension where the JAX package vmaps.

Row-sharded (``axis``, the JAX package's GSPMD sums over the rows): the
weighted sums run in two passes, the weight, ``w@X`` and ``w@y`` sums
first, then the centred Grams, each pass summed over the ranks in one
collective; the NNLS runs on the axis's rank 0 and its coefficients are
broadcast. A padded row carries a zero weight and adds nothing.
"""

import torch

from demethify_tpu_torch.ops.gram import accum_dtype
from demethify_tpu_torch.parallel.distributed import LOCAL


def _power_iteration_sqnorm(G, n_iter: int = 50):
    """Largest eigenvalue of each PSD G (B, p, p), by power iteration."""
    p = G.shape[-1]
    v = torch.full(G.shape[:-1], 1.0 / p ** 0.5, dtype=G.dtype,
                   device=G.device)
    for _ in range(n_iter):
        w = torch.einsum("bpq,bq->bp", G, v)
        v = w / torch.clamp_min(torch.linalg.vector_norm(w, dim=-1,
                                                         keepdim=True), 1e-30)
    return torch.clamp_min(torch.einsum("bp,bpq,bq->b", v, G, v), 1e-30)


def nnls_gram(G, c, n_iter: int = 600):
    """min_{x >= 0} 0.5 x'Gx - c'x for a batch: G (B, p, p), c (B, p) ->
    x (B, p)."""
    B, p = c.shape
    L = (_power_iteration_sqnorm(G) * 1.0001)[:, None]
    x = torch.zeros_like(c)
    z = x
    t = torch.ones((), dtype=G.dtype, device=G.device)
    for _ in range(n_iter):
        x_new = torch.clamp_min(
            z - (torch.einsum("bpq,bq->bp", G, z) - c) / L, 0.0)
        t_new = (1.0 + torch.sqrt(1.0 + 4.0 * t * t)) / 2.0
        z = x_new + ((t - 1.0) / t_new) * (x_new - x)
        x, t = x_new, t_new

    # KKT polish: exact LS solve restricted to the detected support
    support = x > 1e-9
    both = support[:, :, None] & support[:, None, :]
    eye = torch.eye(p, dtype=G.dtype, device=G.device)
    G_m = (torch.where(both, G, torch.zeros_like(G))
           + torch.diag_embed((~support).to(G.dtype)))
    c_m = torch.where(support, c, torch.zeros_like(c))
    x_polish = torch.linalg.solve(G_m + 1e-12 * eye, c_m)
    ok = (torch.where(support, x_polish >= 0.0, x_polish == 0.0).all(dim=1)
          & torch.isfinite(x_polish).all(dim=1))
    polished = torch.where(support, x_polish, torch.zeros_like(x_polish))
    return torch.where(ok[:, None], polished, x)


def wls_intercept_batch(Y, W, X, n_iter: int = 600, axis=LOCAL):
    """All samples at once: Y, W (n_cpg, n_s); X (n_cpg, p) -> (p, n_s)
    simplex-normalised nonnegative coefficients (intercept discarded).
    Runs in X's accumulation dtype (float32 for bf16 storage, as the JAX
    package's ``wls_intercept``), one sample column upcast at a time.
    With ``axis`` the rows are this rank's and the sums are over the
    ranks."""
    acc = accum_dtype(X)
    X = X.to(acc)
    n_s = Y.shape[1]
    cols = range(n_s)                  # n_s is small; keeps memory O(n p)

    def column(s):
        return Y[:, s].to(acc), W[:, s].to(acc)

    firsts = []
    for s in cols:
        y, w = column(s)
        firsts.append(torch.cat([torch.sum(w)[None], w @ X, (w @ y)[None]]))
    firsts = axis.sum_(torch.stack(firsts))
    Gs, cs = [], []
    for s in cols:
        y, w = column(s)
        wsum = torch.clamp_min(firsts[s, 0], 1e-30)
        x_off = firsts[s, 1:-1] / wsum
        y_off = firsts[s, -1] / wsum
        Xc = X - x_off[None, :]
        yc = y - y_off
        Gs.append(Xc.T @ (w[:, None] * Xc))
        cs.append(Xc.T @ (w * yc))
    G, c = axis.sums(torch.stack(Gs), torch.stack(cs))
    coef, = axis.on_root(lambda: (nnls_gram(G, c, n_iter=n_iter),),
                         torch.empty_like(c))
    coef = coef / torch.clamp_min(coef.sum(dim=1, keepdim=True), 1e-10)
    return coef.T
