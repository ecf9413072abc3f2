"""Brunet's cophenetic correlation coefficient over restart runs.

Counterpart of ``demethify_tpu/selection/ccc.py`` (reference
``compute_consensus_matrix`` / ``compute_ccc``, ``demethify/ic.py:24-45``):
each run's cluster assignment is the argmax of its alpha columns, the
consensus is the mean co-assignment matrix (n_samples x n_samples), and
scipy's average linkage and cophenet give the coefficient. Host numpy on
the runs' alpha, which are a few (p, n_samples) arrays.
"""

import logging
from typing import Sequence

import numpy as np
from scipy.cluster.hierarchy import cophenet, linkage
from scipy.spatial.distance import pdist

# the consensus and scipy's hierarchy are O(n_samples^2) host work: fine at
# the tens of samples this criterion is for, a cliff far beyond
_SIZE_WARN_SAMPLES = 4096


def compute_consensus_matrix(alpha_runs: Sequence[np.ndarray]) -> np.ndarray:
    n_s = np.asarray(alpha_runs[0]).shape[1]
    if n_s > _SIZE_WARN_SAMPLES:
        logging.getLogger("demethify").warning(
            "CCC consensus over %d samples builds O(n_samples^2) host "
            "matrices (%.1f GB each in float64); consider AIC/BIC for "
            "sample counts this large.", n_s, n_s * n_s * 8 / 1e9)
    acc = None
    for alpha in alpha_runs:
        assign = np.argmax(np.asarray(alpha), axis=0)
        co = (assign[:, None] == assign[None, :]).astype(np.float64)
        acc = co if acc is None else acc + co
    return acc / len(alpha_runs)


def compute_ccc(alpha_runs: Sequence[np.ndarray]) -> float:
    consensus = compute_consensus_matrix(alpha_runs)
    dist = pdist(consensus, metric="euclidean")
    ccc, _ = cophenet(linkage(dist, method="average"), dist)
    return float(ccc)
