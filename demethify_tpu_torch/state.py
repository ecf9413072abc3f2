"""The state carried across the two packages: the factor pair (u, alpha)
and the data (Y, D, R).

``from_numpy`` takes the JAX package's arrays in its layout (the
``init_provided`` contract of its ``solvers/api.py`` and the argument order
of ``partial_ref_solve_fused``) and returns the port's tensors;
``from_numpy_batch`` does the same for B restart members' stacked initial
factors (the argument order of ``partial_ref_solve_fused_multi``);
``purity_from_numpy`` does the same for the purity vector of the purity
mode; ``to_numpy`` goes back. ``restore_factors`` reads a ``--savestate``
checkpoint (``checkpoint.py``; a JAX-package checkpoint converts to it)
onto a run's row layout.
"""

import numpy as np
import torch

from demethify_tpu_torch.checkpoint import load_factors
from demethify_tpu_torch.device import state_dtype


def from_numpy(u, alpha, y, d, R_trunc, *, device, dtype):
    """(u (n_cpg, n_u), alpha (p, n_s), y, d (n_cpg, n_s), R_trunc
    (n_cpg, n_ct)) as numpy arrays -> the same tuple of contiguous
    tensors on ``device``: the data y, d, R_trunc in the storage dtype
    ``dtype``, the factors u, alpha in its state dtype (float32 for
    bfloat16 storage). ``u`` and ``alpha`` may be None. The numpy arrays
    are moved to the device first and cast there."""
    def conv(x, dt):
        if x is None:
            return None
        return torch.as_tensor(np.ascontiguousarray(x)).to(device).to(dt)
    state = state_dtype(dtype)
    return (conv(u, state), conv(alpha, state),
            *(conv(x, dtype) for x in (y, d, R_trunc)))


def from_numpy_batch(u_b, alpha_b, y, d, R_trunc, *, device, dtype):
    """(u_b (B, n_cpg, n_u), alpha_b (B, p, n_s), y, d (n_cpg, n_s),
    R_trunc (n_cpg, n_ct) or None) as numpy arrays -> the same tuple of
    contiguous tensors on ``device``, dtypes as ``from_numpy``: the stacked
    initial factors of a batch of restart members and the data they
    share."""
    u_b, alpha_b = np.asarray(u_b), np.asarray(alpha_b)
    n_cpg, n_s = np.shape(y)
    if (u_b.ndim != 3 or alpha_b.ndim != 3 or u_b.shape[0] != alpha_b.shape[0]
            or u_b.shape[1] != n_cpg or alpha_b.shape[2] != n_s):
        raise ValueError(f"from_numpy_batch: u_b {u_b.shape} and alpha_b "
                         f"{alpha_b.shape} are not (B, {n_cpg}, n_u) and "
                         f"(B, p, {n_s})")
    return from_numpy(u_b, alpha_b, y, d, R_trunc, device=device,
                      dtype=dtype)


def purity_from_numpy(purity, *, device, dtype):
    """The JAX package's purity vector (n_s,) -> a contiguous tensor on
    ``device`` in ``dtype``, the data's storage dtype: the JAX API casts
    purity to ``y.dtype`` (``solvers/api.py:230``), so under bfloat16
    storage the known-block mass is a bf16 value. It is the known-block
    mass of each sample, already flipped to 1 - p/100 from the
    percentages the CLI takes, as ``purity_solve`` of both packages
    expects it."""
    purity = np.ascontiguousarray(purity)
    if purity.ndim != 1:
        raise ValueError(f"purity must be one value per sample, got shape "
                         f"{purity.shape}")
    return torch.as_tensor(purity).to(device=device, dtype=dtype)


def to_numpy(*tensors):
    """Tensors (any device) -> numpy arrays, in order; None stays None."""
    return tuple(None if t is None else t.detach().cpu().numpy()
                 for t in tensors)


def restore_factors(path, block, *, device, dtype):
    """``--initstate``: the checkpoint at ``path`` -> (u0, alpha0) on this
    run's rows, ``block`` (``parallel/mesh.RowBlock``; one process: the
    whole of them), on ``device`` in the storage dtype ``dtype``, as the
    JAX CLI casts them (``demethify_tpu/cli.py:422-441``). Its row rule
    too: a checkpoint with fewer rows than the run's padded rows is padded
    with zero rows, one with more is refused (ValueError with the JAX
    CLI's message)."""
    state = load_factors(path, rows=(block.start, block.stop))
    if "u" not in state:
        raise ValueError(f"--initstate {path} holds no unknown profiles "
                         f"(a reference-based run's checkpoint)")
    if state["n_rows"] > block.n_pad:
        raise ValueError(f"--initstate factor rows ({state['n_rows']}) do "
                         f"not match the input CpG rows ({block.n_pad}).")
    u = np.zeros((block.stop - block.start, state["u"].shape[1]),
                 state["u"].dtype)
    u[:state["u"].shape[0]] = state["u"]
    return (torch.as_tensor(u).to(device).to(dtype),
            torch.as_tensor(state["alpha"]).to(device).to(dtype))
