"""High-level deconvolution: init + solve + restarts, for the four modes.

Counterpart of ``demethify_tpu/solvers/api.py``: reference-based,
partial-reference, purity-constrained and unsupervised. Routing: tensors
on ``cuda`` use the kernel solvers (``solvers/fused.py``), which take any
shape (past one block's shared memory the kernels keep their rows in
device memory: K1/K4's global layout, K2/K3/K5/K6's device rows past 16
column blocks);
tensors on ``cpu`` the plain ones (``solvers/partial_ref.py``,
``purity.py``, ``unsupervised.py``); a row-sharded dataset (``shard``,
the JAX API's ``_use_fused_sharded``) the row-sharded kernel solvers
(``fused.*_sharded``) on either device, whose kernels run their twins on
CPU tensors; there is no other route.

Each restart draws its init from its own generator
(``restart_generators``). An SVD or ICA init draws nothing, so it runs
one solve whatever ``n_restarts`` says, unless n_u > n_samples sends it
to the random fallback (``init.is_deterministic``, the JAX API's
``_is_deterministic``). On the card, with more than one restart, no
``init_provided`` and the gram form (n_u^2 <= 3 n_s, the JAX API's
rule), the restarts run together through the
multi-member solvers (``fused.*_solve_fused_multi``: K4 and K5 or K6),
in chunks of at most ``fused.max_multi_members``; otherwise they run as
a sequential loop of single solves (``restart_route``). The restart with
the lowest cost wins (first minimum in restart order, across chunks; a
NaN cost never wins). ``solve_members`` runs given inits the same way
and returns every member (the model-selection sweep's CCC restarts).
A row-sharded solve makes each restart's init on the rank's rows
(``solvers/init.py``'s ``shard``): the random options draw the one-rank
numbers, SVD and ICA sum over the ranks, so it starts where the one-rank
solve starts (bit for bit, or to the sums' rounding); no rank holds
another's rows. The reference-based WLS runs row-sharded the same way
(``supervised_deconv``'s ``axis``).
"""

import itertools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from demethify_tpu_torch.ops import fista
from demethify_tpu_torch.ops.cost import weighted_cost
from demethify_tpu_torch.ops.cuda_kernels import gram_form
from demethify_tpu_torch.ops.gram import accum_dtype
from demethify_tpu_torch.ops.nnls import wls_intercept_batch
from demethify_tpu_torch.parallel.distributed import LOCAL
from demethify_tpu_torch.solvers import fused
from demethify_tpu_torch.solvers.init import (
    init_partial,
    init_purity,
    init_unsupervised,
    is_deterministic,
)
from demethify_tpu_torch.solvers.partial_ref import partial_ref_solve
from demethify_tpu_torch.solvers.purity import purity_solve
from demethify_tpu_torch.solvers.unsupervised import unsupervised_solve
from demethify_tpu_torch.utils import check_finite


@dataclass
class DeconvolutionResult:
    """u: (n_cpg, n_u) unknown profiles (None for supervised);
    proportions: (p, n_s); cost: final weighted cost; n_iter: outer
    iterations of the winning restart; trace: optional cost history."""

    u: Optional[torch.Tensor]
    proportions: torch.Tensor
    cost: float
    n_iter: int
    trace: Optional[torch.Tensor] = None


def restart_generators(seed: int, n_restarts: int, device):
    """One independent generator per restart, seeded from
    ``numpy.random.SeedSequence(seed)``."""
    gens = []
    for child in np.random.SeedSequence(seed).spawn(n_restarts):
        g = torch.Generator(device=device)
        g.manual_seed(int(child.generate_state(1, np.uint64)[0] >> 1))
        gens.append(g)
    return gens


def checked_init(make_init):
    """``make_init`` whose (u0, alpha0) ``--debugnans`` checks."""
    def made(*args):
        u0, a0 = make_init(*args)
        check_finite("init", u0=u0, alpha0=a0)
        return u0, a0
    return made


def _select_best(results):
    """First minimum of the restarts' costs; NaN counts as +inf."""
    costs = [float(r[2]["cost"]) for r in results]
    costs = [np.inf if np.isnan(c) else c for c in costs]
    return results[int(np.argmin(costs))]


def supervised_deconv(y, d, R, axis=LOCAL) -> DeconvolutionResult:
    """Reference-based mode: per-sample weighted NNLS with intercept on
    methylated counts (target d*y, weights d), batched over samples. With
    ``axis`` (a row-sharded dataset: y, d, R are this rank's rows) the
    WLS sums and the cost are summed over the ranks."""
    proportions = wls_intercept_batch(d * y, d, R, axis=axis)
    cost = axis.sum_(weighted_cost(y, R, proportions, d))
    check_finite("supervised_deconv", proportions=proportions, cost=cost)
    return DeconvolutionResult(u=None, proportions=proportions,
                               cost=float(cost), n_iter=0)


def restart_route(device, n_u: int, n_s: int, n_restarts: int,
                  init_provided=None, *, init: str = "uniform_") -> str:
    """'batch' when the restarts run together through the multi-member
    kernels: on a CUDA device, more than one restart, none of them
    deterministic (no ``init_provided``, and no SVD/ICA init unless
    n_u > n_s), and the gram form (n_u^2 <= 3 n_s, the rule by which the
    JAX API routes restarts to its multi kernel). 'sequential' otherwise:
    the direct form (the JAX API vmaps its single solver there; the
    per-member results are the same), the CPU's plain solvers, one
    restart, or a deterministic init (one solve)."""
    if (torch.device(device).type == "cuda" and n_restarts > 1
            and init_provided is None
            and not is_deterministic(init, n_u, n_s) and gram_form(n_u, n_s)):
        return "batch"
    return "sequential"


def _member_solves(solve, solve_multi, inits, batch: bool, cap: int):
    """(u, alpha, info) of each init (u0, alpha0) of the iterable
    ``inits``, in order: through ``solve_multi`` in chunks of at most
    ``cap`` members when ``batch`` (the members are views of their
    chunk's results), else one ``solve`` each. A generator: a chunk's
    inits are drawn just before it runs."""
    if not batch:
        for u0, a0 in inits:
            yield solve(u0, a0)
        return
    inits = iter(inits)
    while chunk := list(itertools.islice(inits, cap)):
        u0_b, a0_b = (torch.stack(x) for x in zip(*chunk))
        u_b, alpha_b, info = solve_multi(u0_b, a0_b)
        for b in range(u_b.shape[0]):
            yield u_b[b], alpha_b[b], {k: v[b] for k, v in info.items()}


def _first_min(results):
    """The first minimum-cost (u, alpha, info) of the iterable
    ``results``, as ``_select_best`` picks it; u and alpha copied, so that
    the next chunk runs without this one's batch."""
    best = None
    for res in results:
        if best is None or _select_best([best, res]) is res:
            best = (res[0].clone(), res[1].clone(), res[2])
    return best


def _batched_restarts(solve_multi, init_fn, device, seed, n_restarts, cap):
    """The restarts through ``solve_multi`` in chunks of at most ``cap``
    members, each init drawn from its restart's generator in restart
    order. Returns the winner (u, alpha, info): the first minimum cost
    across all chunks, so the result does not depend on the chunking."""
    gens = restart_generators(seed, n_restarts, device)
    return _first_min(_member_solves(None, solve_multi,
                                     (init_fn(g) for g in gens), True, cap))


def _multi_cap(y, n_ct, n_u, axis=None):
    """The most members of one multi-member solve on y's device; with
    ``axis`` (a row-sharded dataset) the least over its ranks, so that
    every rank chunks alike."""
    cap = fused.max_multi_members(
        y.shape[0], y.shape[1], n_ct, n_u,
        torch.finfo(accum_dtype(y)).bits // 8, y.element_size(),
        fused.free_device_bytes(y.device))
    if axis is None:
        return cap
    return int(axis.min_(torch.tensor([cap], device=y.device)).item())


def _solvers(y, d, R_trunc, n_u, purity, kw, axis=None):
    """(solve, solve_multi) of the mode: unsupervised (R_trunc None),
    purity (purity given) or partial-reference. ``solve`` runs the kernel
    solver on the card, the plain one on the CPU; ``solve_multi`` the
    multi-member kernel solver. With ``axis`` (a row-sharded dataset: y,
    d, R_trunc are this rank's rows) both run the row-sharded kernel
    solvers, whose kernels run their twins on CPU tensors."""
    if R_trunc is None:
        data = (y, d)
        one, multi, plain = (fused.unsupervised_solve_fused,
                             fused.unsupervised_solve_fused_multi,
                             unsupervised_solve)
        one_sh, multi_sh = (fused.unsupervised_solve_fused_sharded,
                            fused.unsupervised_solve_fused_multi_sharded)
    elif purity is not None:
        data = (y, d, R_trunc, purity)
        one, multi, plain = (fused.purity_solve_fused,
                             fused.purity_solve_fused_multi, purity_solve)
        one_sh, multi_sh = (fused.purity_solve_fused_sharded,
                            fused.purity_solve_fused_multi_sharded)
    else:
        data = (y, d, R_trunc)
        one, multi, plain = (fused.partial_ref_solve_fused,
                             fused.partial_ref_solve_fused_multi,
                             partial_ref_solve)
        one_sh, multi_sh = (fused.partial_ref_solve_fused_sharded,
                            fused.partial_ref_solve_fused_multi_sharded)
    plain_kw = dict(kw) if purity is not None else dict(
        kw, use_gram_u=fista.use_gram_u(n_u, y.shape[1], kw["n_iter2"]))

    def solve(u0, a0):
        if axis is not None:
            return one_sh(u0, a0, *data, n_u, axis, **kw)
        if y.device.type == "cuda":
            return one(u0, a0, *data, n_u, **kw)
        return plain(u0, a0, *data, n_u, **plain_kw)

    def solve_multi(u0_b, a0_b):
        if axis is not None:
            return multi_sh(u0_b, a0_b, *data, n_u, axis, **kw)
        return multi(u0_b, a0_b, *data, n_u, **kw)
    return solve, solve_multi


def _result(u, alpha, info):
    return DeconvolutionResult(u=u, proportions=alpha,
                               cost=float(info["cost"]),
                               n_iter=int(info["n_iter"]),
                               trace=info["trace"])


def _restarts(y, d, R_trunc, n_u, purity, make_init, init, seed, n_restarts,
              init_provided, kw, shard=None):
    """Init + solve per restart (one generator each) by ``restart_route``,
    once from ``init_provided`` = (u0, alpha0), or once for a
    deterministic init; the first minimum cost wins. ``make_init(g, y, d,
    R_trunc)`` draws one init. With ``shard`` (``parallel/distributed.
    Shard``) the data are this rank's rows: the solves are the
    row-sharded ones, each init is made on the rank's rows, and
    ``init_provided`` holds this rank's rows of u."""
    n_ct = 0 if R_trunc is None else R_trunc.shape[1]
    n_s = y.shape[1]
    axis = None if shard is None else shard.axis
    make_init = checked_init(make_init)
    solve, solve_multi = _solvers(y, d, R_trunc, n_u, purity, kw, axis)
    batch = restart_route(y.device, n_u, n_s, n_restarts, init_provided,
                          init=init) == "batch"
    if init_provided is not None:
        best = solve(*init_provided)
    elif batch:
        best = _batched_restarts(solve_multi,
                                 lambda g: make_init(g, y, d, R_trunc),
                                 y.device, seed, n_restarts,
                                 _multi_cap(y, n_ct, n_u, axis))
    else:
        if is_deterministic(init, n_u, n_s):
            n_restarts = 1
        best = _select_best([solve(*make_init(g, y, d, R_trunc)) for g in
                             restart_generators(seed, n_restarts, y.device)])
    return _result(*best)


def solve_members(y, d, R_trunc, n_u: int, inits, *,
                  n_iter1: int = 10000, n_iter2: int = 20,
                  tol: float = 1e-2, tol_relative: bool = False,
                  axis=None):
    """The partial-reference (R_trunc given) or unsupervised (None)
    solves of the given inits [(u0, alpha0), ...] on the same data, as a
    list of DeconvolutionResult in their order: on the card together
    through the multi-member kernels (K4 and K5) where ``restart_route``
    would batch random restarts of this shape, else one solve each. With
    ``axis`` (a row-sharded dataset: y, d, R_trunc and the inits' u are
    this rank's rows) the solves are the row-sharded ones."""
    kw = dict(n_iter1=n_iter1, n_iter2=n_iter2, tol=tol,
              tol_relative=tol_relative, record_trace=False)
    n_ct = 0 if R_trunc is None else R_trunc.shape[1]
    solve, solve_multi = _solvers(y, d, R_trunc, n_u, None, kw, axis)
    batch = restart_route(y.device, n_u, y.shape[1], len(inits)) == "batch"
    cap = _multi_cap(y, n_ct, n_u, axis) if batch else 1
    return [_result(*res) for res in _member_solves(solve, solve_multi,
                                                     inits, batch, cap)]


def partial_reference_deconv(y, d, R_trunc, n_u: int, *,
                             init: str = "uniform_",
                             seed: int = 1,
                             n_restarts: int = 1,
                             n_iter1: int = 10000, n_iter2: int = 20,
                             tol: float = 1e-2,
                             tol_relative: bool = False,
                             record_trace: bool = False,
                             init_provided=None,
                             shard=None) -> DeconvolutionResult:
    """Partial-reference mode (``--ref --nbunknown k``). ``init_provided``
    = (u0, alpha0) skips the init (and makes restarts moot). ``shard``
    (``parallel/distributed.Shard``): y, d, R_trunc are this rank's rows
    of a row-sharded dataset, and the result's u is its rows."""
    kw = dict(n_iter1=n_iter1, n_iter2=n_iter2, tol=tol,
              tol_relative=tol_relative, record_trace=record_trace)
    return _restarts(
        y, d, R_trunc, n_u, None,
        lambda g, yy, dd, rr: init_partial(g, init, yy, dd, rr, n_u,
                                           shard=shard),
        init, seed, n_restarts, init_provided, kw, shard)


def purity_deconv(y, d, R_trunc, n_u: int, purity, *,
                  init: str = "uniform_",
                  seed: int = 1,
                  n_restarts: int = 1,
                  n_iter1: int = 100, n_iter2: int = 500,
                  tol: float = 1e-2,
                  tol_relative: bool = False,
                  record_trace: bool = False,
                  init_provided=None, shard=None) -> DeconvolutionResult:
    """Purity-constrained mode (``--ref --nbunknown k --purity ...``);
    purity (n_s,) is the already-flipped 1 - p/100 per-sample vector,
    taken in y's dtype as the JAX API takes it (a bf16 value under bf16
    storage). ``shard`` as for ``partial_reference_deconv``."""
    purity = torch.as_tensor(purity, dtype=y.dtype, device=y.device)
    kw = dict(n_iter1=n_iter1, n_iter2=n_iter2, tol=tol,
              tol_relative=tol_relative, record_trace=record_trace)
    return _restarts(
        y, d, R_trunc, n_u, purity,
        lambda g, yy, dd, rr: init_purity(g, init, yy, dd, rr, n_u,
                                          purity=purity, shard=shard),
        init, seed, n_restarts, init_provided, kw, shard)


def unsupervised_deconv(y, d, n_u: int, *,
                        init: str = "uniform_",
                        seed: int = 1,
                        n_restarts: int = 1,
                        n_iter1: int = 10000, n_iter2: int = 20,
                        tol: float = 1e-2,
                        tol_relative: bool = False,
                        record_trace: bool = False,
                        init_provided=None, shard=None
                        ) -> DeconvolutionResult:
    """Unsupervised mode (no ``--ref``): proportions (n_u, n_s) and the
    profiles of all n_u cell types. ``shard`` as for
    ``partial_reference_deconv``."""
    kw = dict(n_iter1=n_iter1, n_iter2=n_iter2, tol=tol,
              tol_relative=tol_relative, record_trace=record_trace)
    return _restarts(
        y, d, None, n_u, None,
        lambda g, yy, dd, rr: init_unsupervised(g, init, yy, dd, n_u,
                                                shard=shard),
        init, seed, n_restarts, init_provided, kw, shard)


def deconvolve(y, d, R=None, n_u: int = 0, purity=None,
               **kwargs) -> DeconvolutionResult:
    """Dispatch to one of the four modes, as the reference CLI does
    (``demethify/demethify.py:151-217``)."""
    if R is None:
        return unsupervised_deconv(y, d, n_u, **kwargs)
    if n_u == 0:
        return supervised_deconv(y, d, R)
    if purity is not None:
        return purity_deconv(y, d, R, n_u, purity, **kwargs)
    return partial_reference_deconv(y, d, R, n_u, **kwargs)
