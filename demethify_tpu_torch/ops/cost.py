"""Weighted Frobenius cost ``||sqrt(D) * (Y - R @ alpha)||^2``.

Counterpart of ``demethify_tpu/ops/cost.py``: ``weighted_cost`` is the
direct pass over (Y, D); ``weighted_cost_gram`` the Gram identity
``cost_s = y'Dy_s - 2 b_s.a_s + a_s' G_s a_s`` on precomputed per-sample
Grams. Row weights (the bootstrap's form) wait for the bootstrap slice.
"""

import torch


def weighted_cost(y, R, alpha, d) -> torch.Tensor:
    """sum(d * (y - R @ alpha)**2), a 0-d tensor."""
    resid = y - R @ alpha
    return torch.sum(d * resid * resid)


def weighted_cost_gram(G, b, ydy, alpha) -> torch.Tensor:
    """Sigma_s (ydy_s - 2 b_s.a_s + a_s' G_s a_s).

    G: (n_s, p, p), b: (p, n_s), ydy: (n_s,), alpha: (p, n_s).
    """
    quad = torch.einsum("spq,ps,qs->s", G, alpha, alpha)
    lin = torch.sum(b * alpha, dim=0)
    return torch.sum(ydy - 2.0 * lin + quad)
