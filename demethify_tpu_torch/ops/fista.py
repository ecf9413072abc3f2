"""FISTA (extrapolated projected-gradient) inner loops.

Counterpart of ``demethify_tpu/ops/fista.py``; reference semantics are
``update_u`` / ``update_alpha``: Nesterov sequence
``a1 <- (1 + sqrt(1 + 4 a0^2))/2``, momentum
``beta = min((a0-1)/a1, 0.9999 sqrt(L_prev/L))``, a gradient step with a
fixed Lipschitz estimate, then clip to [0, 1] (U) or simplex projection
(alpha). The scalars (a, L_prev, L) are 0-d tensors on the data's device.
"""

import torch

from demethify_tpu_torch.ops.simplex import (
    project_columns_to_simplex,
    project_columns_to_simplex_masked,
)


def nesterov_step(a0):
    return (1.0 + torch.sqrt(1.0 + 4.0 * a0 * a0)) / 2.0


def momentum(a0, a1, l_prev, l_cur):
    return torch.minimum((a0 - 1.0) / a1, 0.9999 * torch.sqrt(l_prev / l_cur))


def fista_u_gram(u, u_prev, a, l_w_prev, l_w, C, M, n_steps: int,
                 lagged: bool = False):
    """n_steps FISTA steps on U in Gram form.

    u, u_prev, C: (n_cpg, n_u); M: (n_cpg, n_u, n_u). The gradient
    (D * (Y - Rt a1 - u_t a2)) a2' equals C - M u_t row by row. ``lagged``
    takes it at the old u instead (the reference's unsupervised quirk,
    ``deconvolution.py:163``). Returns (u, u_prev, a, l_w_prev).
    """
    for _ in range(n_steps):
        a1 = nesterov_step(a)
        beta = momentum(a, a1, l_w_prev, l_w)
        u_t = u + beta * (u - u_prev)
        grad = C - torch.einsum("iuv,iv->iu", M, u if lagged else u_t)
        u, u_prev = torch.clamp(u_t + grad / l_w, 0.0, 1.0), u
        a, l_w_prev = a1, l_w
    return u, u_prev, a, l_w_prev


def fista_u_direct(u, u_prev, a, l_w_prev, l_w, y, d, R_trunc, a1_block,
                   a2_block, n_steps: int, lagged: bool = False):
    """Reference-dataflow U loop; R_trunc=None means no known block,
    ``lagged`` as for ``fista_u_gram``."""
    y_eff = (y if R_trunc is None
             else y - R_trunc.to(a1_block.dtype) @ a1_block)
    for _ in range(n_steps):
        a1 = nesterov_step(a)
        beta = momentum(a, a1, l_w_prev, l_w)
        u_t = u + beta * (u - u_prev)
        at = u if lagged else u_t
        grad = (d * (y_eff - at @ a2_block)) @ a2_block.T
        u, u_prev = torch.clamp(u_t + grad / l_w, 0.0, 1.0), u
        a, l_w_prev = a1, l_w
    return u, u_prev, a, l_w_prev


def fista_alpha_gram(alpha, alpha_prev, a, l_h_prev, l_h, G, b,
                     n_steps: int, row_mask=None):
    """n_steps FISTA steps on alpha (p, n_s) in Gram form, G (n_s, p, p),
    b (p, n_s). ``row_mask`` (bool, (p,), or (p, n_s) for a mask per
    column) restricts the simplex projection to its rows (the padded
    model-selection solve); None = all rows. Returns (alpha, alpha_prev,
    a, l_h_prev)."""
    if row_mask is None:
        project = project_columns_to_simplex
    else:
        def project(v):
            return project_columns_to_simplex_masked(v, row_mask)
    for _ in range(n_steps):
        a2 = nesterov_step(a)
        beta = momentum(a, a2, l_h_prev, l_h)
        a_t = alpha + beta * (alpha - alpha_prev)
        grad = b - torch.einsum("spq,qs->ps", G, a_t)
        alpha, alpha_prev = project(a_t + grad / l_h), alpha
        a, l_h_prev = a2, l_h
    return alpha, alpha_prev, a, l_h_prev


def use_gram_u(n_u: int, n_s: int, n_iter2: int) -> bool:
    """Gram-form U saves traffic when the (n_cpg, n_u, n_u) curvature is
    smaller than the Y/D traffic it avoids (~2 n_iter2 n_s)."""
    return n_u * n_u <= 2 * n_iter2 * n_s
