"""Frank-Wolfe solver for the purity-constrained alpha subproblem.

Counterpart of ``demethify_tpu/ops/frank_wolfe.py`` (reference
``frank_wolfe_nmf`` + ``argmin_vertex_in_simplex``). Each sample's
proportions split into a known block alpha1 (mass purity_s) and an
unknown block alpha2 (mass 1 - purity_s); each step moves toward the
vertex ``purity_s e_argmin`` of the scaled simplexes with step 2/(k+2).
Ties go to the first row (``torch.argmin``, as ``jnp.argmin``).

Gram form: with G = R' diag(d_s) R and b = R'(d_s y_s) over the stacked
R = [W1 | W2], the block gradients are slices of ``G a - b``, so the FW
steps touch O(p^2 n_s) data only.
"""

import torch


def _lmo_columns(grad, mass):
    """Per-column vertex mass_s e_{argmin_col grad}; grad (k, n_s)."""
    vert = torch.zeros_like(grad)
    vert.scatter_(0, torch.argmin(grad, dim=0, keepdim=True),
                  torch.ones_like(grad[:1]))
    return vert * mass[None, :]


def _gammas(max_iter: int, like):
    """The step sizes 2 / (k + 2), computed in the working dtype."""
    k = torch.arange(max_iter, dtype=like.dtype, device=like.device)
    return 2.0 / (k + 2.0)


def _step(alpha, grad, p1, purity, gamma):
    s = torch.cat([_lmo_columns(grad[:p1], purity),
                   _lmo_columns(grad[p1:], 1.0 - purity)], dim=0)
    return (1.0 - gamma) * alpha + gamma * s


def frank_wolfe_gram(alpha1, alpha2, G, b, purity, max_iter: int):
    """max_iter FW steps on alpha = [alpha1; alpha2]: alpha1 (p1, n_s),
    alpha2 (n_u, n_s), G (n_s, p, p), b (p, n_s) of the stacked R, purity
    (n_s,). Returns (alpha1, alpha2)."""
    p1 = alpha1.shape[0]
    alpha = torch.cat([alpha1, alpha2], dim=0)
    for gamma in _gammas(max_iter, alpha):
        grad = torch.einsum("spq,qs->ps", G, alpha) - b     # = -(b - G a)
        alpha = _step(alpha, grad, p1, purity, gamma)
    return alpha[:p1], alpha[p1:]


def frank_wolfe_direct(W1, W2, y, alpha1, alpha2, purity, max_iter: int, d):
    """Reference-dataflow FW loop (one pass over (Y, D) per step), the
    oracle form of ``frank_wolfe_gram``."""
    p1 = alpha1.shape[0]
    alpha = torch.cat([alpha1, alpha2], dim=0)
    W = torch.cat([W1, W2], dim=1)
    for gamma in _gammas(max_iter, alpha):
        grad = -(W.T @ (d * (y - W @ alpha)))
        alpha = _step(alpha, grad, p1, purity, gamma)
    return alpha[:p1], alpha[p1:]
