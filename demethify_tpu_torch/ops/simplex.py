"""Column-wise Euclidean projection onto the probability simplex.

Counterpart of ``demethify_tpu/ops/simplex.py`` (the reference's
``projection_simplex_sort_2d``). The JAX package avoids a sort primitive
because the TPU's costs ~1 ms a call; ``torch.sort`` is cheap on the GPU
and exact on the CPU, so the port sorts. Only sorted VALUES enter the
threshold, so tie order cannot change the result.

rho is the LAST sorted index j with ``u_j - (cumsum_j - z)/(j+1) > 0``,
as in the reference's scan (``ops/simplex.py:54-56`` of the JAX package).
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
