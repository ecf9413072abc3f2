"""Nonnegative ICA initialisation (torque-driven Givens rotation search).

Counterpart of ``demethify_tpu/ops/nnica.py`` (reference ``run_nn_ica`` /
``constrained_nn_ica``, ``demethify/init_func.py:91-168``): whiten the
rows by the symmetric inverse square root of their covariance, then
repeatedly take the pair of rows with the largest torque
``G_ij = y+_i . y-_j - y-_i . y+_j`` and rotate it by the angle that
minimises the negativity loss ``1/(2 n_s) ||min(Y, 0)||_F^2``. As in the
JAX package: the torque is two matrix products, the angle search a
256-point grid then 40 golden-section steps, and a rotation touches the
two rows it turns.

The search stops when the largest torque falls below ``t_tol`` or after
``i_max`` torques. The loop reads that test on the host, one read per
step; ``chip_smoke.py`` times it against a fixed trip of ``i_max`` steps
with the test kept on the device (the same result: once the torque is
below ``t_tol`` nothing rotates again).

``run_nn_ica`` whitens the (n_cpg x n_cpg) row covariance, so it is for
panels of thousands of rows; ``run_nn_ica_dual`` runs the same search on
the coefficients S = B'X in the column space B of X (``ops/tall_svd.py``)
and maps the components back through B. The dual form depends on the
signs of B's columns (a flipped column flips a row of S, and the
negativity loss is not symmetric under that), so its result follows the
port's sign rule (``tall_svd``), not the JAX package's.

Row-sharded (``shard``, ``parallel/distributed.Shard``: X and the
profiles are this rank's rows): the dual form sums B'X over the ranks,
runs the whitening and the rotation search on the axis's rank 0 and
broadcasts the rotation's columns and H, and maps back through the
rank's rows of B; the primal form (at most ICA_DUAL_THRESHOLD rows by
the init's rule) gathers the rows and runs whole on rank 0. The
constrained form zeroes the padded rows of its clipped residual.
"""

import math

import torch

from demethify_tpu_torch.ops.nnls import wls_intercept_batch
from demethify_tpu_torch.ops.tall_svd import tall_svd
from demethify_tpu_torch.parallel.distributed import axis_of


def _rotate_rows(phi, yi, yj):
    c, s = torch.cos(phi), torch.sin(phi)
    return c * yi + s * yj, -s * yi + c * yj


def _pair_loss(phi, yi, yj):
    """Negativity loss of rows (yi, yj) turned by each angle of ``phi``
    (any shape; the loss has phi's shape)."""
    ri, rj = _rotate_rows(phi[..., None], yi, yj)
    ni = torch.clamp_max(ri, 0.0)
    nj = torch.clamp_max(rj, 0.0)
    return ((torch.sum(ni * ni, dim=-1) + torch.sum(nj * nj, dim=-1))
            / (2.0 * yi.shape[0]))


def _best_angle(yi, yj, n_grid: int = 256, n_refine: int = 40):
    """The angle (0-d tensor) minimising the pair loss: the first minimum
    of an n_grid-point grid over [0, 2 pi), then ``n_refine``
    golden-section steps within one grid step of it."""
    width = 2.0 * math.pi / n_grid
    grid = torch.arange(n_grid, dtype=yi.dtype, device=yi.device) * width
    k = torch.argmin(_pair_loss(grid, yi, yj))
    lo, hi = grid[k] - width, grid[k] + width
    invphi = (math.sqrt(5.0) - 1.0) / 2.0
    for _ in range(n_refine):
        m1 = hi - invphi * (hi - lo)
        m2 = lo + invphi * (hi - lo)
        f = _pair_loss(torch.stack([m1, m2]), yi, yj)
        left = f[0] < f[1]
        lo, hi = torch.where(left, lo, m1), torch.where(left, m2, hi)
    return (lo + hi) / 2.0


def whiten(X, epsilon: float = 1e-8):
    """Symmetric inverse-square-root whitening of the row covariance,
    its eigenvalues clamped at ``epsilon``."""
    Xc = X - torch.mean(X, dim=1, keepdim=True)
    C = Xc @ Xc.T / (X.shape[1] - 1)
    D, E = torch.linalg.eigh(C)
    D = torch.clamp_min(D, epsilon)
    V = (E * (1.0 / torch.sqrt(D))[None, :]) @ E.T
    return V @ X


def torque(Y):
    """(largest |torque| over the pairs i < j, its flat index i n + j in
    row-major order, the first on a tie), both 0-d tensors on Y's
    device."""
    Yp = torch.clamp_min(Y, 0.0)
    Yn = torch.clamp_min(-Y, 0.0)
    G = torch.abs(torch.triu(Yp @ Yn.T - Yn @ Yp.T, diagonal=1)).flatten()
    flat = torch.argmax(G)
    return G[flat], flat


def rotate_pair(W, Y, i, j):
    """Turns rows i and j of Y, and of the accumulated rotation W, in
    place by the best angle for Y's pair."""
    phi = _best_angle(Y[i], Y[j])
    ri, rj = _rotate_rows(phi, Y[i], Y[j])
    Y[i], Y[j] = ri, rj
    wi, wj = _rotate_rows(phi, W[i], W[j])
    W[i], W[j] = wi, wj


def _rotation_search(Z, t_tol: float, i_max: int):
    """The accumulated rotation W (n x n) of the greedy pairwise descent on
    the whitened rows Z (reference ``init_func.py:128-162``)."""
    n = Z.shape[0]
    W = torch.eye(n, dtype=Z.dtype, device=Z.device)
    Y = Z.clone()
    for _ in range(i_max):
        t_max, flat = torque(Y)
        t_max, flat = torch.stack([t_max.to(torch.float64),
                                   flat.to(torch.float64)]).tolist()
        if not t_max >= t_tol:
            break
        i, j = divmod(int(flat), n)
        rotate_pair(W, Y, i, j)
    return W


def run_nn_ica(X, rank: int, t_tol: float = 1e-1, i_max: int = 1000,
               shard=None):
    """(clip(W[:, :rank], 0, 1), H[:rank]) of the search on the whitened
    rows of X, with H = max(W Z, 0), as the reference returns them.
    ``shard``: X and the profiles are this rank's rows; the rows are
    gathered and the whole search runs on the axis's rank 0."""
    if shard is not None and shard.axis.size > 1:
        full = shard.gather(X)
        prof, H = shard.axis.on_root(
            lambda: run_nn_ica(full, rank, t_tol, i_max),
            full.new_empty(full.shape[0], rank),
            full.new_empty(rank, full.shape[1]))
        return shard.rows_of(prof), H
    Z = whiten(X)
    W = _rotation_search(Z, t_tol, i_max)
    H = torch.clamp_min(W @ Z, 0.0)
    return torch.clamp(W[:, :rank], 0.0, 1.0), H[:rank]


def run_nn_ica_dual(X, rank: int, t_tol: float = 1e-1, i_max: int = 1000,
                    shard=None):
    """Genome-scale NN-ICA: the search on S = B'X (k x n_s), B the
    column-space basis of X (n_cpg x k, k = n_s, from ``tall_svd``), the
    components mapped back through B and clipped to [0, 1]. Returns
    (profiles (n_cpg, rank), H (rank, n_s)). Two passes over X plus
    O(n_s^3) work. ``shard``: X, B and the profiles are this rank's rows
    (a padded row of X zero)."""
    axis = axis_of(shard)
    B = tall_svd(X, axis)[0]
    S = axis.sum_(B.T @ X)

    def search():
        Z = whiten(S)
        W = _rotation_search(Z, t_tol, i_max)
        H = torch.clamp_min(W @ Z, 0.0)
        return W[:, :rank], H[:rank]

    W_r, H = axis.on_root(search, S.new_empty(S.shape[0], rank),
                          S.new_empty(rank, S.shape[1]))
    return torch.clamp(B @ W_r, 0.0, 1.0), H


def constrained_nn_ica(Y, W1, counts, rank: int, t_tol: float = 1e-1,
                       i_max: int = 1000, dual: bool = False, shard=None):
    """The known block fitted by the weighted NNLS, then NN-ICA (``dual``:
    its column-space form) of the clipped residual max(Y - W1 H1, 1e-8).
    Returns (W = [W1 | W2], H = [H1; H2]). ``shard``: Y, W1, counts and W
    are this rank's rows (the residual's padded rows zeroed)."""
    H1 = wls_intercept_batch(Y, counts, W1, axis=axis_of(shard))
    Y_residual = torch.clamp_min(Y - W1 @ H1, 1e-8)
    if shard is not None:
        Y_residual = shard.data_rows(Y_residual)
    ica = run_nn_ica_dual if dual else run_nn_ica
    W2, H2 = ica(Y_residual, rank=rank, t_tol=t_tol, i_max=i_max,
                 shard=shard)
    return torch.cat([W1, W2], dim=1), torch.cat([H1, H2], dim=0)
