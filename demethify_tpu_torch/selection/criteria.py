"""Corrected AIC and BIC.

Counterpart of ``demethify_tpu/selection/criteria.py`` (reference
``compute_bic`` / ``compute_aic``, ``demethify/ic.py:11-22``), with the
parameter count k = n_u n_cpg + (n_ct + n_u - 1) n_samples and
l = n_samples n_cpg. Host arithmetic on the solver's final cost.
"""

import numpy as np

# The weighted cost is >= 0, but its float32 Gram-identity value can dip
# just below zero at a near-perfect fit; clamped so that log() stays
# defined (the rank then scores as an extreme over-fit, as a tiny
# positive cost does in the reference).
_COST_FLOOR = 1e-30


def _kl(n_u: int, n_cpg: int, n_ct: int, n_samples: int):
    l = n_samples * n_cpg
    k = n_u * n_cpg + (n_ct + n_u - 1) * n_samples
    return k, l


def compute_bic(cost: float, n_u: int, n_cpg: int, n_ct: int,
                n_samples: int) -> float:
    cost = max(float(cost), _COST_FLOOR)
    k, l = _kl(n_u, n_cpg, n_ct, n_samples)
    return (2 * np.log(cost) * k * np.log(l)
            + (k * np.log(l) * (k + 1)) / (l - k - 1))


def compute_aic(cost: float, n_u: int, n_cpg: int, n_ct: int,
                n_samples: int) -> float:
    cost = max(float(cost), _COST_FLOOR)
    k, l = _kl(n_u, n_cpg, n_ct, n_samples)
    return l * np.log(cost / l) + 2 * k + (2 * k * (k + 1)) / (l - k - 1)
