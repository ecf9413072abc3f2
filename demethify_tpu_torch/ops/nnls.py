"""Weighted NNLS with intercept: the reference-based solver.

Counterpart of ``demethify_tpu/ops/nnls.py`` (the reference's
``wls_intercept`` = sklearn ``LinearRegression(positive=True)`` with sample
weights, coefficients normalised to the simplex with a 1e-10 sum floor).
The NNLS runs on the (p, p) normal equations with monotone FISTA plus an
exact least-squares polish on the detected support. Samples are an
explicit leading batch dimension where the JAX package vmaps.
"""

import torch


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


def wls_intercept_batch(Y, W, X, n_iter: int = 600):
    """All samples at once: Y, W (n_cpg, n_s); X (n_cpg, p) -> (p, n_s)
    simplex-normalised nonnegative coefficients (intercept discarded)."""
    n_s = Y.shape[1]
    Gs, cs = [], []
    for s in range(n_s):               # n_s is small; keeps memory O(n p)
        y, w = Y[:, s], W[:, s]
        wsum = torch.clamp_min(torch.sum(w), 1e-30)
        x_off = (w @ X) / wsum
        y_off = (w @ y) / wsum
        Xc = X - x_off[None, :]
        yc = y - y_off
        Gs.append(Xc.T @ (w[:, None] * Xc))
        cs.append(Xc.T @ (w * yc))
    coef = nnls_gram(torch.stack(Gs), torch.stack(cs), n_iter=n_iter)
    coef = coef / torch.clamp_min(coef.sum(dim=1, keepdim=True), 1e-10)
    return coef.T
