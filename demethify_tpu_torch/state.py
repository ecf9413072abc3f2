"""The state carried across the two packages: the factor pair (u, alpha)
and the data (Y, D, R).

``from_numpy`` takes the JAX package's arrays in its layout (the
``init_provided`` contract of its ``solvers/api.py`` and the argument order
of ``partial_ref_solve_fused``) and returns the port's tensors;
``to_numpy`` goes back. Reading the JAX package's orbax checkpoints is
ROADMAP port queue item 5.
"""

import numpy as np
import torch


def from_numpy(u, alpha, y, d, R_trunc, *, device, dtype):
    """(u (n_cpg, n_u), alpha (p, n_s), y, d (n_cpg, n_s), R_trunc
    (n_cpg, n_ct)) as numpy arrays -> the same tuple of contiguous
    tensors on ``device`` in ``dtype``. ``u`` and ``alpha`` may be None."""
    def conv(x):
        if x is None:
            return None
        return torch.as_tensor(np.ascontiguousarray(x)).to(
            device=device, dtype=dtype)
    return tuple(conv(x) for x in (u, alpha, y, d, R_trunc))


def to_numpy(*tensors):
    """Tensors (any device) -> numpy arrays, in order; None stays None."""
    return tuple(None if t is None else t.detach().cpu().numpy()
                 for t in tensors)
