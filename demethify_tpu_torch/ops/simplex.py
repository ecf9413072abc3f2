"""Column-wise Euclidean projection onto the probability simplex.

Counterpart of ``demethify_tpu/ops/simplex.py`` (the reference's
``projection_simplex_sort_2d``). The JAX package avoids a sort primitive
because the TPU's costs ~1 ms a call; ``torch.sort`` is cheap on the GPU
and exact on the CPU, so the port sorts. Only sorted VALUES enter the
threshold, so tie order cannot change the result.

rho is the LAST sorted index j with ``u_j - (cumsum_j - z)/(j+1) > 0``,
as in the reference's scan (``ops/simplex.py:54-56`` of the JAX package).

``project_columns_to_simplex_masked`` (the JAX package's function of the
same name, ``ops/simplex.py:65``) projects only the rows a mask keeps:
the others are set to -1e30 first, so they sort last, never meet the
threshold and come out exactly 0, and the kept rows get the projection
of the shorter vector.
"""

import torch


def project_columns_to_simplex(v: torch.Tensor, z: float = 1.0):
    """Project each column of ``v`` (p, n) onto {x >= 0, sum(x) = z}."""
    p = v.shape[0]
    u = torch.sort(v, dim=0, descending=True).values
    pi = torch.cumsum(u, dim=0) - z                          # cumsum - z
    j1 = torch.arange(1, p + 1, dtype=v.dtype, device=v.device)[:, None]
    cond = (u - pi / j1) > 0
    rows = torch.arange(p, device=v.device)[:, None]
    # last index where cond holds; j = 0 always holds for z > 0
    rho = torch.where(cond, rows, torch.full_like(rows, -1)).amax(dim=0)
    rho = rho.clamp_min(0)
    theta = pi.gather(0, rho[None, :])[0] / (rho + 1).to(v.dtype)
    return torch.clamp_min(v - theta[None, :], 0.0)


MASK_NEG = -1e30


def project_columns_to_simplex_masked(v: torch.Tensor, row_mask,
                                      z: float = 1.0):
    """Project each column of ``v`` (p, n) onto the simplex over the rows
    where ``row_mask`` (bool, (p,) or (p, n) for a mask per column) is
    True; the other rows come out exactly 0."""
    keep = row_mask[:, None] if row_mask.dim() == 1 else row_mask
    v_m = torch.where(keep, v, torch.full((), MASK_NEG, dtype=v.dtype,
                                          device=v.device))
    return project_columns_to_simplex(v_m, z)
