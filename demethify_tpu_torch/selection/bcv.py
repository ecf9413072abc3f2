"""Owen-Perry bi-cross-validation of one rank.

Counterpart of ``demethify_tpu/selection/bcv.py`` (reference
``bicross_validation``, ``demethify/ic.py:58-89``) in the form the JAX
package's batched sweep runs it (``batched_sweep.batched_bcv_sweep``):
each fold keeps an element with probability ``fraction`` (the train
mask), solves on the masked data and scores the PRESS on the held-out
elements. Returns the TOTAL PRESS over the folds, as the reference does
(``ic.py:89``), and the factors of the fold with the least error. A fold
with no held-out element is skipped.

The train masks and the inits come from the caller (``selection/sweep.py``
shares the masks across ranks, as the JAX sweep does): torch cannot draw
``jax.random``'s numbers, so a run held to the JAX package takes its
masks and inits.
"""

import numpy as np
import torch

from demethify_tpu_torch.ops.gram import accum_dtype
from demethify_tpu_torch.parallel.distributed import LOCAL, Axis

FRACTION = 0.3


def train_masks(shape, generators, fraction: float = FRACTION):
    """One (n_cpg, n_s) bool train mask per generator (one per fold),
    U(0, 1) < ``fraction``, on the generator's device."""
    return [torch.rand(shape, generator=g, device=g.device) < fraction
            for g in generators]


def bicross_validation(y, d, ref, n_u: int, masks, init_fn, deconv,
                       axis: Axis = LOCAL):
    """(total PRESS, best u, best alpha) of rank ``n_u`` over the folds of
    ``masks`` (train masks, on y's device). ``init_fn(fold, y_tr, d_tr)``
    gives the fold's (u0, alpha0); ``deconv(y_tr, d_tr, n_u, init)`` solves
    and returns a ``DeconvolutionResult``. With ``axis`` (a row-sharded
    sweep: y, d, ref and the masks are this rank's rows) the held-out
    counts and errors are summed over its ranks."""
    acc = accum_dtype(y)
    total = 0.0
    best = None
    for fold, train in enumerate(masks):
        test = ~train
        n_test = float(axis.sum_(torch.sum(test)))
        if n_test == 0:
            continue
        y_tr, d_tr = y * train, d * train
        res = deconv(y_tr, d_tr, n_u, init_fn(fold, y_tr, d_tr))
        R = res.u if ref is None else torch.cat([ref.to(acc), res.u], dim=1)
        err = float(axis.sum_(torch.sum(
            ((y.to(acc) - R @ res.proportions) * test) ** 2))) / n_test
        total += err
        if best is None or err < best[0]:
            best = (err, res.u, res.proportions)
    if best is None:
        return np.inf, None, None
    return total, best[1], best[2]
