"""Minka's Laplace-evidence rank selection on the (residual) spectrum.

Counterpart of ``demethify_tpu/selection/minka.py`` (reference
``select_rank_minka`` / ``get_log_lik_partial``, ``demethify/ic.py:92-163``).
As in the JAX package the sweep's follow-up solve works (the reference's
call at ``ic.py:189`` raises a TypeError), and the pairwise evidence term
is a masked outer difference.

Two spectra, by the residual's row count: up to _HOST_SVD_MAX_ROWS rows the
exact ``np.linalg.svd`` on the host, as the reference takes it; above, the
Gram-eigh singular values on the data's device (``ops/tall_svd.py``),
clamped to zero below 2 sqrt(eps) s_max, the Gram's noise floor, so that
the evidence's cutoff for an exactly rank-deficient spectrum still fires.

Row-sharded (``shard``): the residual is this rank's rows (the known
block's WLS summed over the ranks), and the branch follows the JAX
package's rule by layout. Rows over processes (``--multihost``: its
global array is not fully addressable) take the Gram spectrum, summed
over the ranks, at any row count; the workers of one process (``--shard``
alone) take the exact spectrum of the gathered residual up to
_HOST_SVD_MAX_ROWS rows, as one process does.
"""

from typing import Optional, Tuple

import numpy as np
import torch
from scipy.special import gammaln

from demethify_tpu_torch.ops.gram import accum_dtype
from demethify_tpu_torch.ops.nnls import wls_intercept_batch
from demethify_tpu_torch.ops.tall_svd import tall_svd_singular_values
from demethify_tpu_torch.parallel.distributed import axis_of

_HOST_SVD_MAX_ROWS = 65536


def get_log_lik_partial(cov_evals: np.ndarray, rank: int,
                        shape: Tuple[int, int]) -> float:
    n_samples, n_features = shape
    if not 1 <= rank <= n_features - 1:
        raise ValueError("The tested rank should be in [1, n_features - 1]")

    eps = 1e-15
    if cov_evals[rank - 1] < eps:
        return -np.inf

    i = np.arange(1, rank + 1)
    pu = (-rank * np.log(2.0)
          + np.sum(gammaln((n_features - i + 1) / 2.0)
                   - np.log(np.pi) * (n_features - i + 1) / 2.0))

    pl = -np.sum(np.log(cov_evals[:rank])) * n_samples / 2.0

    v = max(eps, np.sum(cov_evals[rank:]) / (n_features - rank))
    pv = -np.log(v) * n_samples * (n_features - rank) / 2.0

    m = n_features * rank - rank * (rank + 1.0) / 2.0
    pp = np.log(2.0 * np.pi) * (m + rank) / 2.0

    spectrum = cov_evals.copy()
    spectrum[rank:n_features] = v
    n_ev = len(cov_evals)
    ii, jj = np.meshgrid(np.arange(rank), np.arange(n_ev), indexing="ij")
    mask = jj > ii
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = (np.log((cov_evals[ii] - cov_evals[jj])
                        * (1.0 / spectrum[jj] - 1.0 / spectrum[ii]))
                 + np.log(n_samples))
    pa = float(np.sum(np.where(mask, terms, 0.0)))

    return (pu + pl + pv + pp - pa / 2.0
            - rank * np.log(n_samples) / 2.0)


def select_rank_minka(Y: torch.Tensor, counts: torch.Tensor,
                      W1: Optional[torch.Tensor] = None, shard=None):
    """Y, counts (n_cpg, n_s) and the known profiles W1 (n_cpg, n_ct) or
    None, on one device (with ``shard``, this rank's rows). Returns
    (rank_est, {'log_liks': {rank: ll}, 'cov_evals': ...}): the residual
    Y - W1 H1 of the known block's weighted NNLS fit, its spectrum, and
    the rank of largest evidence."""
    n_samples = Y.shape[1]
    n_features = Y.shape[0] if shard is None else shard.n_rows
    axis = axis_of(shard)
    acc = accum_dtype(Y)
    residual = Y.to(acc)
    if W1 is not None:
        H1 = wls_intercept_batch(Y, counts, W1, axis=axis)
        residual = residual - W1.to(acc) @ H1
    if n_features <= _HOST_SVD_MAX_ROWS and axis.one_process:
        if shard is not None:
            residual = shard.gather(residual)
        svals = axis.broadcast_object(
            np.linalg.svd(residual.cpu().numpy(), compute_uv=False)
            if axis.rank == 0 else None)
    else:
        svals = tall_svd_singular_values(residual, axis).cpu().numpy()
        floor = np.sqrt(np.finfo(svals.dtype).eps)
        svals = np.where(svals < 2.0 * floor * svals.max(initial=0.0),
                         0.0, svals)
    svals = svals[:min(n_features, n_samples)]
    cov_evals = svals ** 2 / n_samples

    ranks = np.arange(1, len(svals))
    log_liks = np.array([
        get_log_lik_partial(cov_evals, int(r), (n_samples, n_features))
        for r in ranks
    ])
    rank_est = int(ranks[int(np.argmax(log_liks))])
    return rank_est, {"log_liks": dict(zip(ranks.tolist(),
                                           log_liks.tolist())),
                      "cov_evals": cov_evals}
