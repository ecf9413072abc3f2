"""NNDSVD initialisation (Boutsidis-Gallopoulos) and its constrained form.

Counterpart of ``demethify_tpu/ops/nndsvd.py`` (reference
``nndsvd_initialize`` / ``constrained_nndsvd``,
``demethify/init_func.py:17-88``). The per-component choice of the
positive or negative part runs on all components at once. Tall inputs
(rows >= 16 x columns) take the Gram-eigh SVD (``ops/tall_svd.py``), the
others ``torch.linalg.svd``.

With flag 0 the result does not depend on the singular vectors' signs:
the first component takes absolute values and every other keeps the
larger of its positive and negative parts, which a sign flip swaps.

Row-sharded (``shard``, ``parallel/distributed.Shard``: V and W are this
rank's rows): the negativity test, U's column norms and flag 2's mean
are summed over the ranks, the tall/dense branch is chosen on the global
row count, the dense branch (under 16 rows a column) gathers its rows
and factors them on the axis's rank 0, and flag 2's fill of W is drawn
whole on every rank (the one-rank numbers). The constrained form zeroes
the padded rows of its clipped residual.
"""

import torch

from demethify_tpu_torch.ops.nnls import wls_intercept_batch
from demethify_tpu_torch.ops.tall_svd import tall_svd
from demethify_tpu_torch.parallel.distributed import LOCAL, Shard, axis_of

_TALL_RATIO = 16


def _parts(x):
    return torch.clamp_min(x, 0.0), torch.clamp_min(-x, 0.0)


def _norm(x, axis=LOCAL):
    return torch.sqrt(axis.sum_(torch.sum(x * x, dim=0)))


def _svd(V, shard):
    """(U, S, Vt) of V: the Gram-eigh SVD of tall V (over the rows of
    ``shard``), else the dense SVD of the gathered rows on the axis's
    rank 0, U cut back to this rank's rows."""
    axis = shard.axis
    if shard.n_rows >= _TALL_RATIO * V.shape[1]:
        return tall_svd(V, axis)
    full = shard.gather(V)
    k = min(full.shape)
    U, S, Vt = axis.on_root(
        lambda: torch.linalg.svd(full, full_matrices=False),
        full.new_empty(full.shape[0], k), full.new_empty(k),
        full.new_empty(k, full.shape[1]))
    return shard.rows_of(U), S, Vt


def nndsvd_initialize(V, rank: int, flag: int = 0, generator=None,
                      shard=None):
    """Nonnegative double-SVD init of V (m, n) -> (W (m, rank), H (rank,
    n)); raises ValueError where V has a negative entry. ``flag`` 0 leaves
    the small entries at zero; 2 fills them with mean(V) x U(0, 1) / 100
    drawn from ``generator`` (W's draws, then H's). ``shard``: V and W are
    this rank's rows of a row-sharded V (padded rows zero)."""
    if flag not in (0, 2):
        raise ValueError(f"NNDSVD flag {flag} is not supported (0 or 2)")
    sh = Shard.whole(V.shape[0]) if shard is None else shard
    axis = sh.axis
    if bool(axis.max_(torch.any(V < 0).to(V.dtype)) > 0):
        # the reference's check (the JAX package leaves it out); the inits
        # pass data in [0, 1] or a residual clipped at 1e-8
        raise ValueError("The input matrix contains negative elements !")
    U, S, Vt = _svd(V, sh)
    E = Vt.T

    W = torch.sqrt(S[0]) * torch.abs(U[:, :1])
    H = torch.sqrt(S[0]) * torch.abs(E[:, :1]).T
    if rank > 1:
        up, un = _parts(U[:, 1:rank])
        vp, vn = _parts(E[:, 1:rank])
        n_up, n_un = _norm(up, axis), _norm(un, axis)
        n_vp, n_vn = _norm(vp), _norm(vn)
        s = S[1:rank]
        termp = n_up * n_vp
        termn = n_un * n_vn
        use_pos = termp >= termn
        scale_p = torch.sqrt(s * termp)
        scale_n = torch.sqrt(s * termn)
        w = torch.where(use_pos, scale_p / torch.clamp_min(n_up, 1e-30) * up,
                        scale_n / torch.clamp_min(n_un, 1e-30) * un)
        h = torch.where(use_pos, scale_p / torch.clamp_min(n_vp, 1e-30) * vp,
                        scale_n / torch.clamp_min(n_vn, 1e-30) * vn)
        W = torch.cat([W, w], dim=1)
        H = torch.cat([H, h.T], dim=0)

    W = torch.where(W < 1e-11, 0.0, W)
    H = torch.where(H < 1e-11, 0.0, H)
    if flag == 2:
        if generator is None:
            raise ValueError("flag 2 NNDSVD needs a torch.Generator")
        avg = (torch.mean(V) if axis.size == 1 else
               axis.sum_(torch.sum(V)) / (sh.n_rows * V.shape[1]))

        def fill(shape, dtype):
            return avg * torch.rand(shape, generator=generator, dtype=dtype,
                                    device=V.device) / 100.0
        # W's fill drawn whole (a padded row's is zero, as its W)
        W = torch.where(W == 0.0, sh.rows_of(fill((sh.n_rows, W.shape[1]),
                                                  W.dtype)), W)
        H = torch.where(H == 0.0, fill(H.shape, H.dtype), H)
    return W, H


def constrained_nndsvd(Y, W1, counts, rank: int, flag: int = 0,
                       generator=None, shard=None):
    """The known block fitted per sample by the weighted NNLS, then NNDSVD
    of the clipped residual max(Y - W1 H1, 1e-8). Returns
    (W = [W1 | clip(W2, 0, 1)], H = [H1; H2]). ``shard``: Y, W1, counts
    and W are this rank's rows (the residual's padded rows zeroed)."""
    H1 = wls_intercept_batch(Y, counts, W1, axis=axis_of(shard))
    Y_residual = torch.clamp_min(Y - W1 @ H1, 1e-8)
    if shard is not None:
        Y_residual = shard.data_rows(Y_residual)
    W2, H2 = nndsvd_initialize(Y_residual, rank=rank, flag=flag,
                               generator=generator, shard=shard)
    W = torch.cat([W1, torch.clamp(W2, 0.0, 1.0)], dim=1)
    return W, torch.cat([H1, H2], dim=0)
