"""Thin SVD of a tall matrix through its small Gram matrix.

Counterpart of ``demethify_tpu/ops/tall_svd.py``. The matrices here have
a handful of columns (n_samples or the rank) and up to millions of rows,
so the exact factorisation takes one pass over the rows and an m x m
eigendecomposition:

    G = V' V                (m x m, ``torch.matmul`` on V's device)
    G = W diag(s^2) W'      (``torch.linalg.eigh``: LAPACK on the CPU,
                             cuSOLVER on the card)
    U = V W diag(1/s)

Used by NNDSVD (``ops/nndsvd.py``), the dual NN-ICA (``ops/nnica.py``)
and minka's device spectrum (``selection/minka.py``).

Row-sharded (``axis``, the JAX package's psum over the 'cpg' mesh axis):
V is this rank's rows, G is summed over the ranks, the eigendecomposition
and the sign rule run on the axis's rank 0 and W and s are broadcast, so
every rank holds the same bits; U = V W / s stays row-local. A padded
row of V must be zero (its row of U then is).
"""

import torch

from demethify_tpu_torch.parallel.distributed import LOCAL


def _sign_rule(W):
    """+1 or -1 per column of W: the sign of the column's entry of
    largest magnitude, the first such index on a tie."""
    idx = torch.argmax(torch.abs(W), dim=0)
    lead = W.gather(0, idx[None, :])[0]
    return torch.where(lead < 0, -1.0, 1.0).to(W.dtype)


def tall_svd(V, axis=LOCAL):
    """Thin SVD of V (n x m, n >> m): (U (n, m), s (m,), Wt (m, m)) with
    U diag(s) Wt == V and the singular values descending; with ``axis``,
    V and U are this rank's rows.

    Eigenvector signs: LAPACK, cuSOLVER and the JAX package's eigh each
    follow their own convention, so the port fixes its own. Each column of
    W has its largest-magnitude entry positive (the first such index on a
    tie), and U's columns follow W's. The card and the CPU then give the
    same factors up to rounding, and ``U diag(s) Wt == V`` holds as
    before. The JAX function's U and W may differ from these by the sign
    of a column; its s is the same.

    Exact up to the conditioning of V'V: singular values below about
    sqrt(eps) s_max lose their relative accuracy, which the init and
    rank-selection uses tolerate. Zero singular values get zero columns
    of U.
    """
    G = axis.sum_(V.T @ V)

    def factor():
        evals, W = torch.linalg.eigh(G)              # ascending
        evals = torch.flip(evals, (0,))
        W = torch.flip(W, (1,))
        return W * _sign_rule(W)[None, :], evals

    W, evals = axis.on_root(factor, torch.empty_like(G),
                            G.new_empty(G.shape[0]))
    s = torch.sqrt(torch.clamp_min(evals, 0.0))
    inv_s = torch.where(s > 0, 1.0 / torch.clamp_min(s, 1e-300),
                        torch.zeros_like(s))
    U = (V @ W) * inv_s[None, :]
    return U, s, W.T


def tall_svd_singular_values(V, axis=LOCAL):
    """The singular values of V (n x m), descending: one Gram pass, no U
    (``axis`` as for ``tall_svd``)."""
    G = axis.sum_(V.T @ V)
    evals, = axis.on_root(lambda: (torch.linalg.eigvalsh(G),),
                          G.new_empty(G.shape[0]))
    return torch.sqrt(torch.clamp_min(torch.flip(evals, (0,)), 0.0))
