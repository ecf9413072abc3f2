"""Weighted Frobenius cost ``||sqrt(D) * (Y - R @ alpha)||^2``.

Counterpart of ``demethify_tpu/ops/cost.py``: ``weighted_cost`` is the
direct pass over (Y, D); ``weighted_cost_gram`` the Gram identity
``cost_s = y'Dy_s - 2 b_s.a_s + a_s' G_s a_s`` on precomputed per-sample
Grams.
"""

import torch


def weighted_cost(y, R, alpha, d, row_weights=None) -> torch.Tensor:
    """sum(d * (y - R @ alpha)**2), a 0-d tensor; ``row_weights``
    ((n_cpg,), the bootstrap's row multiplicities) scales each row."""
    resid = y - R @ alpha
    sq = d * resid * resid
    if row_weights is not None:
        sq = row_weights.to(sq.dtype)[:, None] * sq
    return torch.sum(sq)


def weighted_cost_gram(G, b, ydy, alpha) -> torch.Tensor:
    """Sigma_s (ydy_s - 2 b_s.a_s + a_s' G_s a_s).

    G: (n_s, p, p), b: (p, n_s), ydy: (n_s,), alpha: (p, n_s).
    """
    quad = torch.einsum("spq,ps,qs->s", G, alpha, alpha)
    lin = torch.sum(b * alpha, dim=0)
    return torch.sum(ydy - 2.0 * lin + quad)
