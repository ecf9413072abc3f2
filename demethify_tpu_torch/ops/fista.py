"""FISTA (extrapolated projected-gradient) inner loops.

Counterpart of ``demethify_tpu/ops/fista.py``; reference semantics are
``update_u`` / ``update_alpha``: Nesterov sequence
``a1 <- (1 + sqrt(1 + 4 a0^2))/2``, momentum
``beta = min((a0-1)/a1, 0.9999 sqrt(L_prev/L))``, a gradient step with a
fixed Lipschitz estimate, then clip to [0, 1] (U) or simplex projection
(alpha). The scalars (a, L_prev, L) are 0-d tensors on the data's device.
"""

import torch

from demethify_tpu_torch.ops.simplex import project_columns_to_simplex


def nesterov_step(a0):
    return (1.0 + torch.sqrt(1.0 + 4.0 * a0 * a0)) / 2.0


def momentum(a0, a1, l_prev, l_cur):
    return torch.minimum((a0 - 1.0) / a1, 0.9999 * torch.sqrt(l_prev / l_cur))


def fista_u_gram(u, u_prev, a, l_w_prev, l_w, C, M, n_steps: int):
    """n_steps FISTA steps on U in Gram form.

    u, u_prev, C: (n_cpg, n_u); M: (n_cpg, n_u, n_u). The gradient
    (D * (Y - Rt a1 - u_t a2)) a2' equals C - M u_t row by row.
    Returns (u, u_prev, a, l_w_prev).
    """
    for _ in range(n_steps):
        a1 = nesterov_step(a)
        beta = momentum(a, a1, l_w_prev, l_w)
        u_t = u + beta * (u - u_prev)
        grad = C - torch.einsum("iuv,iv->iu", M, u_t)
        u, u_prev = torch.clamp(u_t + grad / l_w, 0.0, 1.0), u
        a, l_w_prev = a1, l_w
    return u, u_prev, a, l_w_prev


def fista_u_direct(u, u_prev, a, l_w_prev, l_w, y, d, R_trunc, a1_block,
                   a2_block, n_steps: int):
    """Reference-dataflow U loop; R_trunc=None means no known block."""
    y_eff = y if R_trunc is None else y - R_trunc @ a1_block
    for _ in range(n_steps):
        a1 = nesterov_step(a)
        beta = momentum(a, a1, l_w_prev, l_w)
        u_t = u + beta * (u - u_prev)
        grad = (d * (y_eff - u_t @ a2_block)) @ a2_block.T
        u, u_prev = torch.clamp(u_t + grad / l_w, 0.0, 1.0), u
        a, l_w_prev = a1, l_w
    return u, u_prev, a, l_w_prev


def fista_alpha_gram(alpha, alpha_prev, a, l_h_prev, l_h, G, b,
                     n_steps: int):
    """n_steps FISTA steps on alpha (p, n_s) in Gram form, G (n_s, p, p),
    b (p, n_s). Returns (alpha, alpha_prev, a, l_h_prev). The masked
    projection of the model-selection sweep waits for that slice."""
    for _ in range(n_steps):
        a2 = nesterov_step(a)
        beta = momentum(a, a2, l_h_prev, l_h)
        a_t = alpha + beta * (alpha - alpha_prev)
        grad = b - torch.einsum("spq,qs->ps", G, a_t)
        alpha, alpha_prev = project_columns_to_simplex(a_t + grad / l_h), alpha
        a, l_h_prev = a2, l_h
    return alpha, alpha_prev, a, l_h_prev


def use_gram_u(n_u: int, n_s: int, n_iter2: int) -> bool:
    """Gram-form U saves traffic when the (n_cpg, n_u, n_u) curvature is
    smaller than the Y/D traffic it avoids (~2 n_iter2 n_s)."""
    return n_u * n_u <= 2 * n_iter2 * n_s
