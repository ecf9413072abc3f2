"""Model selection: the number of unknown cell types (``--ic``, ``--icmax``).

Counterpart of ``demethify_tpu/selection/sweep.py::evaluate_best_ic``
(reference ``evaluate_best_ic``, ``demethify/ic.py:169-218``) and of the
semantics of its batched sweeps (``selection/batched_sweep.py``): every
rank n_u = 1..n_u_max is solved, the criterion (AIC, BIC, CCC, BCV or
minka) computed, and the first minimum kept.

The JAX package pads every rank to n_u_max under alpha row masks so that
XLA compiles its solver once. The port's kernels take their shapes at run
time, so each rank is solved at its own width through the entry points
of ``solvers/api.py`` (on the card K1 with K2, or the plain solvers past
the kernels' plans); a masked padded solve is the lower-rank solve, so
the two agree to rounding. Per criterion:

- AIC, BIC: one solve per rank; the criterion takes the solver's final
  cost (as ``batched_sweep.evaluate_ic_batched``).
- CCC: ``n_restarts`` solves per rank (``api.solve_members``: on the card
  the rank's restarts together through K4 and K5 in the gram form); the
  cluster consensus of their alpha; the LAST restart's factors kept. With
  a deterministic init (SVD, ICA at n_u <= n_samples) the restarts are
  one solve repeated, as the JAX package's serial path has them.
- BCV: ``n_restarts`` folds whose train masks every rank shares
  (``selection/bcv.py``); data-independent random inits are drawn once
  per rank for all folds, the others (``uniform`` with a reference, SVD,
  ICA) per fold on the masked data.
- minka: the rank from the spectrum (``selection/minka.py``), then one
  solve at it.

The JAX package's solves for minka and for CCC with an SVD or ICA init
ignore ``tol_relative``; so do the port's. Random draws: each member
(rank, restart or fold) draws from its own generator
(``member_generator``) on the data's device; the folds' masks from
theirs on the CPU, so that a sweep on the card and one on the CPU share
them (with SVD or ICA inits the two then solve the same problems).
``inits(rank, j)``
and ``masks`` inject them instead (the tests feed the JAX package's
draws); a deterministic init is computed whatever ``inits`` says.
"""

from typing import Optional

import numpy as np
import torch

from demethify_tpu_torch.parallel.distributed import LOCAL, Axis, Shard
from demethify_tpu_torch.selection.bcv import (
    bicross_validation,
    train_masks,
)
from demethify_tpu_torch.selection.ccc import compute_ccc
from demethify_tpu_torch.selection.criteria import compute_aic, compute_bic
from demethify_tpu_torch.selection.minka import select_rank_minka
from demethify_tpu_torch.solvers.api import (
    checked_init,
    partial_reference_deconv,
    solve_members,
    unsupervised_deconv,
)
from demethify_tpu_torch.solvers.init import (
    DETERMINISTIC,
    init_partial,
    init_unsupervised,
    is_deterministic,
)
from demethify_tpu_torch.utils import check_finite


IC_CHOICES = ("AIC", "BIC", "CCC", "BCV", "minka")
# the first spawn keys of the members' and the folds' seed sequences
_MEMBERS, _FOLDS = 192837465, 564738291


def _generator(seed, key, device):
    child = np.random.SeedSequence(seed, spawn_key=key)
    g = torch.Generator(device=device)
    g.manual_seed(int(child.generate_state(1, np.uint64)[0] >> 1))
    return g


def member_generator(seed: int, rank: int, j: int, device):
    """The generator of the sweep member (rank, j): j is the restart (CCC)
    or the fold (BCV), 0 for a single solve."""
    return _generator(seed, (_MEMBERS, rank, j), device)


def _pick(values, ic):
    """Index of the kept rank, as the JAX package's sweeps choose it:
    AIC/BIC the first minimum of the finite values; BCV ``np.argmin``;
    CCC the first value that no later one beats strictly."""
    v = np.asarray(values, dtype=np.float64)
    if ic == "BCV":
        return int(np.argmin(v))
    if ic == "CCC":
        best = 0
        for i in range(1, len(v)):
            if v[i] < v[best]:
                best = i
        return best
    return int(np.argmin(np.where(np.isfinite(v), v, np.inf)))


def evaluate_best_ic(y, d, ref, init_option: str, ic: str, *,
                     seed: int = 1, iter1: int, iter2: int, tol: float,
                     tol_relative: bool = False, n_restarts: int = 5,
                     n_u_max: int = 25, inits=None, masks=None,
                     axis: Axis = LOCAL, shard: Optional[Shard] = None):
    """y, d (n_cpg, n_s) and ref (n_cpg, n_ct), or None for the
    unsupervised sweep, on one device. Returns (best_u (n_cpg, n_u),
    best_alpha (n_ct + n_u, n_s), best_n_u, list_ic): for minka the
    negated log-evidence of ranks 1..n_s - 1, else the criterion of ranks
    1..n_u_max. ``inits(rank, j)`` -> (u0, alpha0) replaces member
    (rank, j)'s random init; ``masks`` (n_restarts train masks) replace
    BCV's fold draws. With ``axis`` of N processes the ranks are
    partitioned over them, as the JAX package's
    ``_evaluate_best_ic_multihost`` does: process p solves ranks p + 1,
    p + 1 + N, ...; the criteria are gathered; every process solves the
    winner again. Each member draws from its own generator, so the result
    is the one-process sweep's. minka solves one rank on every process.

    ``shard`` (``parallel/distributed.Shard``, the 2-D layout's rows of
    one process): y, d, ref are this worker's block of the rows, every
    solve is row-sharded over ``shard.axis`` (CCC's restarts through
    ``solve_members``, together on the card), the inits are made on the
    worker's rows (BCV's on its rows of the fold's train mask), minka's
    residual and spectrum are summed over the axis (``select_rank_minka``'s
    rule), BCV's PRESS is summed over the axis, the criteria count the
    unpadded rows, and best_u is this worker's block of the rows (padding
    included)."""
    if ic not in IC_CHOICES:
        raise ValueError(f"--ic must be one of {IC_CHOICES}, got {ic!r}")
    n_cpg, n_s = y.shape
    if shard is not None:
        n_cpg = shard.block.n_rows
    n_ct = 0 if ref is None else ref.shape[1]
    kw = dict(n_iter1=iter1, n_iter2=iter2, tol=tol,
              tol_relative=tol_relative)

    @checked_init
    def init(rank, j, yy=None, dd=None):
        """Member (rank, j)'s init on (yy, dd), default (y, d): this
        worker's rows with ``shard``."""
        yy = y if yy is None else yy
        dd = d if dd is None else dd
        if inits is not None and not is_deterministic(init_option, rank,
                                                      n_s):
            u0, a0 = (torch.as_tensor(x, device=yy.device)
                      for x in inits(rank, j))
            return (u0 if shard is None else shard.rows_of(u0)), a0
        g = member_generator(seed, rank, j, yy.device)
        if ref is None:
            return init_unsupervised(g, init_option, yy, dd, rank,
                                     shard=shard)
        return init_partial(g, init_option, yy, dd, ref, rank, shard=shard)

    def deconv(yy, dd, rank, u0a0, **over):
        args = dict(kw, init_provided=u0a0, shard=shard, **over)
        if ref is None:
            return unsupervised_deconv(yy, dd, rank, **args)
        return partial_reference_deconv(yy, dd, ref, rank, **args)

    if ic == "minka":
        best_n_u, info = select_rank_minka(y, d, ref, shard=shard)
        res = deconv(y, d, best_n_u, init(best_n_u, 0), tol_relative=False)
        return (res.u, res.proportions, best_n_u,
                [-v for v in info["log_liks"].values()])

    if ic == "BCV":
        full_masks = masks if masks is not None else train_masks(
            (n_cpg, n_s), [_generator(seed, (_FOLDS, f), "cpu")
                           for f in range(n_restarts)])
        full_masks = [torch.as_tensor(m) for m in full_masks]
        # a worker's rows of a train mask: its padded rows count as train
        # rows, so that no held-out element is padding
        fold_masks = [(m if shard is None else ~shard.block.take(~m)).to(
            y.device) for m in full_masks]
        per_fold = (init_option in DETERMINISTIC
                    or (init_option == "uniform" and ref is not None))

    # a deterministic init sends the JAX package's whole CCC sweep down
    # its serial path, whose solves take an absolute tolerance
    ccc_kw = (dict(kw, tol_relative=False)
              if init_option in DETERMINISTIC else kw)

    def member(rank):
        """(criterion, u, alpha) of one rank of the sweep."""
        if ic in ("AIC", "BIC"):
            res = deconv(y, d, rank, init(rank, 0))
            fn = compute_bic if ic == "BIC" else compute_aic
            val = fn(res.cost, rank, n_cpg, n_ct, n_s)
            u, alpha = res.u, res.proportions
        elif ic == "CCC":
            if is_deterministic(init_option, rank, n_s):
                runs = [deconv(y, d, rank, init(rank, 0),
                               tol_relative=False)] * n_restarts
            else:
                runs = solve_members(
                    y, d, ref, rank,
                    [init(rank, j) for j in range(n_restarts)],
                    axis=None if shard is None else shard.axis, **ccc_kw)
            val = -compute_ccc([r.proportions.cpu().numpy() for r in runs])
            u, alpha = runs[-1].u, runs[-1].proportions
        else:                                               # BCV
            shared = None if per_fold else init(rank, 0)
            val, u, alpha = bicross_validation(
                y, d, ref, rank, fold_masks,
                lambda f, yt, dt, r=rank, s=shared: (
                    s if s is not None else init(r, f, yt, dt)),
                deconv, LOCAL if shard is None else shard.axis)
        check_finite(f"--ic {ic} at {rank} unknowns", nan_only=True,
                     criterion=float(val))
        return float(val), u, alpha

    if axis.size > 1:
        # ranks in strides over the processes (higher ranks cost more),
        # the criteria gathered, the winner solved again on every process
        mine = {rank: member(rank)[0] for rank in
                range(1 + axis.rank, n_u_max + 1, axis.size)}
        merged = {}
        for part in axis.all_gather_object(mine):
            merged.update(part)
        list_ic = [merged[rank] for rank in range(1, n_u_max + 1)]
        best_n_u = _pick(list_ic, ic) + 1
        _, u, alpha = member(best_n_u)
        return u, alpha, best_n_u, list_ic
    list_ic, best = [], None
    for rank in range(1, n_u_max + 1):
        val, u, alpha = member(rank)
        list_ic.append(val)
        if _pick(list_ic, ic) == rank - 1:
            best = (u, alpha, rank)
    return best[0], best[1], best[2], list_ic
