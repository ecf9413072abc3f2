"""Initialisation for the iterative solves.

Counterpart of ``demethify_tpu/solvers/init.py``: ``init_partial``
(reference ``init_BSSMF_md``), ``init_purity`` (``init_BSSMF_md_p``) and
``init_unsupervised`` (the inlined options of ``unsupervised_deconv``).
The options uniform, uniform_, beta, SVD and ICA; the fallback rule (n_u >
n_samples forces uniform_, before anything else); the zero-guard on the
first unknown alpha row in the partial-reference init only. Every draw
takes an explicit ``torch.Generator``. ``row_weights`` (the bootstrap's
row multiplicities) weights the 'uniform' option's WLS coverage, which is
the WLS on the resampled rows; the other options draw without looking at
the data, or (SVD, ICA) factor it unweighted.

torch cannot reproduce ``jax.random`` draws, so the distributions are
matched instead: Dirichlet(1, ..., 1) columns are column-normalised
Exp(1) draws, and Beta(1/2, 1/2) is ``sin(pi U / 2)^2`` with U uniform
(the arcsine law). Runs that must match the JAX package exactly pass the
same initial factors to both (``init_provided``).

The draws come back in ``y.dtype``, as the JAX package's do: under
bfloat16 storage u0 and alpha0 are bf16 values (the solvers then carry
them in float32). Uniform u is drawn in bf16 directly; the Beta and
Dirichlet draws are formed in float32 and rounded once, as the JAX
package's ``.astype(dtype)`` rounds them.

Row-sharded (``shard``, ``parallel/distributed.Shard``: y, d, R_trunc
and the returned u are this rank's rows): u's draws are made whole on
every rank from the one generator and cut to the rank's rows, the
Dirichlet alpha drawn on every rank alike, so the draws are the one-rank
draws bit for bit; the 'uniform' option's WLS and the SVD and ICA
factorings sum over the ranks (``ops/nnls.py``, ``ops/nndsvd.py``,
``ops/nnica.py``), and the dual-ICA switch reads the global row count.
The transient is the whole (n_cpg, n_u) draw on each rank.

SVD and ICA are deterministic: the constrained NNDSVD and NN-ICA of the
known-block residual (``ops/nndsvd.py``, ``ops/nnica.py``; NNDSVD and NN-ICA
of the data without a reference), the alpha columns projected onto the
simplex. Above ICA_DUAL_THRESHOLD rows ICA takes its column-space form.
They factor in the state dtype and return their factors in it: under
bf16 storage the JAX package's partial-reference and purity inits upcast
the bf16 data the same way and return float32 factors (its unsupervised
SVD/ICA inits raise there, as ``jnp.linalg.eigh`` takes no bf16; the
port factors those in float32 too).
"""

import math

import torch

from demethify_tpu_torch.device import state_dtype
from demethify_tpu_torch.ops.nndsvd import (
    constrained_nndsvd,
    nndsvd_initialize,
)
from demethify_tpu_torch.ops.nnica import (
    constrained_nn_ica,
    run_nn_ica,
    run_nn_ica_dual,
)
from demethify_tpu_torch.ops.nnls import wls_intercept_batch
from demethify_tpu_torch.ops.simplex import project_columns_to_simplex
from demethify_tpu_torch.parallel.distributed import Shard

INIT_OPTIONS = ("uniform", "uniform_", "beta", "SVD", "ICA")
DETERMINISTIC = ("SVD", "ICA")
# above this many CpG rows ICA runs in its column-space (dual) form: the
# primal form whitens an (n_cpg x n_cpg) covariance
ICA_DUAL_THRESHOLD = 4096


def _rand_u(gen, shard, n_u, like):
    """This rank's rows of a uniform (n_rows, n_u) draw."""
    return shard.rows_of(torch.rand((shard.n_rows, n_u), generator=gen,
                                    dtype=like.dtype, device=like.device))


def _rand_beta_half(gen, shard, n_u, like):
    """This rank's rows of a Beta(1/2, 1/2) (n_rows, n_u) draw."""
    x = torch.rand((shard.n_rows, n_u), generator=gen,
                   dtype=state_dtype(like.dtype), device=like.device)
    return shard.rows_of((torch.sin(0.5 * math.pi * x) ** 2).to(like.dtype))


def _rand_dirichlet_ones(gen, p, n_s, like):
    e = torch.empty((p, n_s), dtype=state_dtype(like.dtype),
                    device=like.device)
    e.exponential_(generator=gen)
    return (e / e.sum(dim=0, keepdim=True)).to(like.dtype)


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


def _resolve_option(init_option: str, n_u: int, n_s: int) -> str:
    """The reference's fallback (n_u > n_samples forces uniform_), then
    the options this slice has."""
    if init_option != "uniform_" and n_u > n_s:
        return "uniform_"
    if init_option not in INIT_OPTIONS:
        raise ValueError(f"Unknown init option: {init_option!r}")
    return init_option


def is_deterministic(init_option: str, n_u: int, n_s: int) -> bool:
    """True when the init draws nothing: SVD and ICA, unless n_u >
    n_samples sends them to the random uniform_ fallback."""
    return init_option in DETERMINISTIC and n_u <= n_s


def _factored(init_option, y, d, R_trunc, n_u, shard=None):
    """(W, H) of the constrained NNDSVD or NN-ICA in the state dtype."""
    dt = state_dtype(y.dtype)
    y, d, R_trunc = (x.to(dt) for x in (y, d, R_trunc))
    if init_option == "ICA":
        return constrained_nn_ica(y, R_trunc, d, rank=n_u, t_tol=1e-1,
                                  dual=_n_rows(y, shard) > ICA_DUAL_THRESHOLD,
                                  shard=shard)
    return constrained_nndsvd(y, R_trunc, d, rank=n_u, flag=0, shard=shard)


def _n_rows(y, shard):
    """The global row count (y's rows without ``shard``)."""
    return y.shape[0] if shard is None else shard.n_rows


def _draw(gen, init_option, y, d, R_trunc, n_u, row_weights=None,
          shard=None):
    """u and alpha of the random options (uniform, uniform_, beta); R_trunc
    (n_cpg, n_ct) or None for no known block."""
    n_s = y.shape[1]
    p = n_u if R_trunc is None else R_trunc.shape[1] + n_u
    sh = Shard.whole(y.shape[0]) if shard is None else shard
    if init_option == "uniform":
        u = _rand_u(gen, sh, n_u, y)
        # the JAX package's weight rows are in y.dtype: w d is rounded
        # to bf16 under bf16 storage
        dw = (d if row_weights is None
              else d * row_weights.to(d.dtype)[:, None])
        alpha = wls_intercept_batch(y, dw, torch.cat([R_trunc, u], dim=1),
                                    axis=sh.axis)
    elif init_option == "uniform_":
        u = _rand_u(gen, sh, n_u, y)
        alpha = _rand_dirichlet_ones(gen, p, n_s, y)
    else:                                                    # beta
        u = _rand_beta_half(gen, sh, n_u, y)
        alpha = _rand_dirichlet_ones(gen, p, n_s, y)
    return u, alpha


def init_partial(gen: torch.Generator, init_option: str, y, d, R_trunc,
                 n_u: int, row_weights=None, shard=None):
    """-> (u (n_cpg, n_u), alpha (n_ct + n_u, n_s)) on y's device, in
    y's dtype (SVD, ICA: the state dtype). ``shard``: the rows are this
    rank's."""
    option = _resolve_option(init_option, n_u, y.shape[1])
    if option in DETERMINISTIC:
        W, alpha = _factored(option, y, d, R_trunc, n_u, shard)
        u, alpha = W[:, R_trunc.shape[1]:], project_columns_to_simplex(alpha)
    else:
        u, alpha = _draw(gen, option, y, d, R_trunc, n_u, row_weights,
                         shard)
    return u, zero_guard(alpha, n_u)


def init_purity(gen: torch.Generator, init_option: str, y, d, R_trunc,
                n_u: int, row_weights=None, purity=None, shard=None):
    """Purity-constrained init (reference ``deconvolution.py:228-267``)
    -> (u (n_cpg, n_u), alpha (n_ct + n_u, n_s)). The uniform, uniform_
    and beta options draw as ``init_partial`` does, without its
    zero-guard. SVD and ICA (which need ``purity``, the (n_s,) flipped
    known-block mass) scale the projected known block by the purity, and
    ICA the projected unknown block by 1 - purity; SVD leaves the unknown
    block unscaled, as the reference does (``deconvolution.py:262``).
    ``shard``: the rows are this rank's."""
    option = _resolve_option(init_option, n_u, y.shape[1])
    if option not in DETERMINISTIC:
        return _draw(gen, option, y, d, R_trunc, n_u, row_weights, shard)
    if purity is None:
        raise ValueError(f"--init {option} in the purity mode needs the "
                         f"purity")
    W, alpha = _factored(option, y, d, R_trunc, n_u, shard)
    purity = torch.as_tensor(purity, device=y.device).to(alpha.dtype)
    unknown = project_columns_to_simplex(alpha[-n_u:])
    if option == "ICA":
        unknown = (1.0 - purity)[None, :] * unknown
    alpha = torch.cat([
        purity[None, :] * project_columns_to_simplex(alpha[:-n_u]),
        unknown], dim=0)
    return W[:, R_trunc.shape[1]:], alpha


def init_unsupervised(gen: torch.Generator, init_option: str, y, d,
                      n_u: int, shard=None):
    """Unsupervised init -> (u (n_cpg, n_u), alpha (n_u, n_s)). The
    reference's 'uniform' branch reads an undefined variable
    (``deconvolution.py:117``), so, as in the JAX package, it takes the
    'uniform_' draws; no zero-guard. ``shard``: the rows are this
    rank's."""
    option = _resolve_option(init_option, n_u, y.shape[1])
    if option == "uniform":
        option = "uniform_"
    if option not in DETERMINISTIC:
        return _draw(gen, option, y, d, None, n_u, shard=shard)
    y = y.to(state_dtype(y.dtype))
    if option == "ICA":
        ica = (run_nn_ica_dual if _n_rows(y, shard) > ICA_DUAL_THRESHOLD
               else run_nn_ica)
        u, alpha = ica(y, rank=n_u, t_tol=1e-1, shard=shard)
    else:
        u, alpha = nndsvd_initialize(y, rank=n_u, shard=shard)
    return torch.clamp(u, 0.0, 1.0), project_columns_to_simplex(alpha)
