"""Weighted Frobenius cost ``||sqrt(D) * (Y - R @ alpha)||^2``.

Counterpart of ``demethify_tpu/ops/cost.py``: ``weighted_cost`` is the
direct pass over (Y, D); ``weighted_cost_gram`` the Gram identity
``cost_s = y'Dy_s - 2 b_s.a_s + a_s' G_s a_s`` on precomputed per-sample
Grams.

Under bfloat16 storage the whole cost runs in float32, as the JAX
package's ``weighted_cost`` does. The rows are taken a chunk at a time
(``ops.gram.row_chunks``), each upcast on its own, so no float32 copy of
the whole Y, D or R is made and no (n_cpg, n_s) residual outlives its
chunk.
"""

import torch

from demethify_tpu_torch.ops.gram import accum_dtype, row_chunks


def weighted_cost(y, R, alpha, d, row_weights=None) -> torch.Tensor:
    """sum(d * (y - R @ alpha)**2), a 0-d tensor; ``row_weights``
    ((n_cpg,), the bootstrap's row multiplicities) scales each row."""
    acc = accum_dtype(y)
    total = torch.zeros((), dtype=acc, device=y.device)
    for lo, hi in row_chunks(y.shape[0]):
        resid = y[lo:hi].to(acc) - R[lo:hi].to(acc) @ alpha
        sq = d[lo:hi].to(acc) * resid * resid
        if row_weights is not None:
            sq = row_weights[lo:hi].to(acc)[:, None] * sq
        total += torch.sum(sq)
    return total


def weighted_cost_gram(G, b, ydy, alpha) -> torch.Tensor:
    """Sigma_s (ydy_s - 2 b_s.a_s + a_s' G_s a_s).

    G: (n_s, p, p), b: (p, n_s), ydy: (n_s,), alpha: (p, n_s).
    """
    quad = torch.einsum("spq,ps,qs->s", G, alpha, alpha)
    lin = torch.sum(b * alpha, dim=0)
    return torch.sum(ydy - 2.0 * lin + quad)
