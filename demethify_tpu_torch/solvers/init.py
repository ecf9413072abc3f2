"""Initialisation for the partial-reference solve.

Counterpart of ``demethify_tpu/solvers/init.py::init_partial`` (reference
``init_BSSMF_md``): the options uniform, uniform_ and beta, the fallback
rule (n_u > n_samples forces uniform_) and the zero-guard on the first
unknown alpha row. Every draw takes an explicit ``torch.Generator``.

torch cannot reproduce ``jax.random`` draws, so the distributions are
matched instead: Dirichlet(1, ..., 1) columns are column-normalised
Exp(1) draws, and Beta(1/2, 1/2) is ``sin(pi U / 2)^2`` with U uniform
(the arcsine law). Runs that must match the JAX package exactly pass the
same initial factors to both (``init_provided``).
"""

import math

import torch

from demethify_tpu_torch.ops.nnls import wls_intercept_batch

INIT_OPTIONS = ("uniform", "uniform_", "beta", "SVD", "ICA")


def _rand_u(gen, n_cpg, n_u, like):
    return torch.rand((n_cpg, n_u), generator=gen, dtype=like.dtype,
                      device=like.device)


def _rand_beta_half(gen, n_cpg, n_u, like):
    x = _rand_u(gen, n_cpg, n_u, like)
    return torch.sin(0.5 * math.pi * x) ** 2


def _rand_dirichlet_ones(gen, p, n_s, like):
    e = torch.empty((p, n_s), dtype=like.dtype, device=like.device)
    e.exponential_(generator=gen)
    return e / e.sum(dim=0, keepdim=True)


def zero_guard(alpha, n_u: int):
    """Reference ``deconvolution.py:74-76``: if any entry of the FIRST
    unknown row is exactly zero, set that whole row to 1e-10 and scale the
    known block by (1 - 1e-10). Runs on the device, without a host sync."""
    first = alpha[-n_u]
    trigger = torch.any(first == 0.0)
    fixed = torch.where(trigger, torch.full_like(first, 1e-10), first)
    scale = torch.where(trigger, alpha.new_tensor(1.0 - 1e-10),
                        alpha.new_tensor(1.0))
    known = alpha[:-n_u] * scale
    return torch.cat([known, fixed[None, :], alpha[alpha.shape[0] - n_u + 1:]],
                     dim=0)


def init_partial(gen: torch.Generator, init_option: str, y, d, R_trunc,
                 n_u: int):
    """-> (u (n_cpg, n_u), alpha (n_ct + n_u, n_s)) on y's device and dtype."""
    n_cpg, n_s = y.shape
    p = R_trunc.shape[1] + n_u
    if init_option in ("SVD", "ICA"):
        raise NotImplementedError(
            f"--init {init_option} is ROADMAP port queue item 4 "
            f"(the SVD/ICA inits)")
    if init_option not in INIT_OPTIONS:
        raise ValueError(f"Unknown init option: {init_option!r}")
    if init_option != "uniform_" and n_u > n_s:
        init_option = "uniform_"

    if init_option == "uniform":
        u = _rand_u(gen, n_cpg, n_u, y)
        alpha = wls_intercept_batch(y, d, torch.cat([R_trunc, u], dim=1))
    elif init_option == "uniform_":
        u = _rand_u(gen, n_cpg, n_u, y)
        alpha = _rand_dirichlet_ones(gen, p, n_s, y)
    else:                                                    # beta
        u = _rand_beta_half(gen, n_cpg, n_u, y)
        alpha = _rand_dirichlet_ones(gen, p, n_s, y)
    return u, zero_guard(alpha, n_u)
