"""Bootstrap confidence intervals (``--confidence LEVEL B``).

Counterpart of ``demethify_tpu/uncertainty/bootstrap.py`` (reference
``bt_ci``, ``demethify/bootstrap.py:10-93``): B row-resamples of (Y, D, R)
with replacement, an init and a solve per replicate, then percentile
intervals (numpy's linear interpolation, as ``np.percentile`` in the
reference) over the replicates' proportions and, in the non-supervised
modes, the unknown profiles. Two layouts, as in the JAX package:

- **resample** gathers each replicate's rows and runs one single solve
  on the copies through ``solvers/api`` (on the card K1 + K2, or K1 + K3
  with ``purity``); u intervals are per resampled row position.
- **weights** solves the equivalent row-multiplicity problem: w = the
  replicate's row counts, one (n_cpg,) vector instead of gathered copies
  of the data. In the gram form (n_u^2 <= 3 n_s) the replicates run
  together through the multi-member solvers (``fused.*_solve_fused_multi``
  with ``row_weights_b``: on the card K4 with its weights operand, then K5
  or K6 with per-member known blocks), in chunks of at most
  ``fused.max_multi_members``; u intervals are per original row. The
  direct form (n_u^2 > 3 n_s) runs the plain weighted solvers one
  replicate at a time, on the data's device (on the card no kernel runs:
  the JAX package's XLA weighted solvers, chosen by its ``_fused_gate``
  on the same shape rule, are their counterpart).
- the supervised mode (no unknowns) solves the WLS on (d y, w d, ref).

``method="auto"`` takes weights from 2,000,000 data elements on, as the
JAX package does. With an SVD or ICA init the weights layout computes
the init once on the full data and gives it to every replicate, as the
JAX package does; the resample layout inits each replicate on its
gathered rows. Multi-process runs partition the replicates over the
ranks, or run the weights layout row-sharded (``bootstrap_ci``'s ``axis``
and ``shard``): then every rank draws each replicate's indices whole and
keeps its rows of the weights, and makes the inits on its rows, so no
rank holds another's rows.

Random numbers: replicate r draws its resample indices, then its init,
from its own ``torch.Generator``, seeded from the GLOBAL replicate index
(``replicate_generator``) and kept apart from the restart generators, so
chunking never changes a result. torch cannot reproduce ``jax.random``'s
draws: the port's intervals agree with the JAX package's only when both
are given the same draws. ``indices`` and ``inits`` inject them.

bfloat16 storage: the resample layout gathers bf16 rows; the weights
layout runs K4's bf16 form. The weight rows hold the JAX package's
values, which it accumulates in y.dtype: under bf16 a row count stops at
256 (256 + 1 rounds back to 256 in bf16), and the supervised WLS weights
w d are bf16 products.

Divergences kept from the JAX package: the bootstrap uses the main
path's flipped purity 1 - p/100 (the reference's bootstrap uses p/100),
and ``ref=None`` runs the unsupervised bootstrap (the reference crashes).
"""

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from demethify_tpu_torch.ops import fista
from demethify_tpu_torch.ops.cuda_kernels import gram_form
from demethify_tpu_torch.ops.gram import accum_dtype
from demethify_tpu_torch.ops.nnls import wls_intercept_batch
from demethify_tpu_torch.parallel.distributed import LOCAL, Axis, Shard
from demethify_tpu_torch.solvers import api, fused
from demethify_tpu_torch.solvers.init import (
    DETERMINISTIC,
    init_partial,
    init_purity,
    init_unsupervised,
)
from demethify_tpu_torch.solvers.partial_ref import partial_ref_solve
from demethify_tpu_torch.solvers.purity import purity_solve
from demethify_tpu_torch.solvers.unsupervised import unsupervised_solve
from demethify_tpu_torch.utils import check_finite

WEIGHTS_MIN_ELEMS = 2_000_000
# the first spawn key of every replicate's seed sequence: keeps the
# replicate generators apart from ``api.restart_generators``'
_STREAM = 987654321
# replicates per multi-solver call on the CPU (the plain twins hold a few
# (B, n_s, n_cpg) temporaries)
CPU_MEMBERS = 8
# the replicate index whose generator draws the weights layout's shared
# init (it draws only in the SVD/ICA fallback to uniform_, n_u > n_s)
SHARED_INIT = 2 ** 31 - 1


def resolve_method(method: str, init_option: str, n_elems: int) -> str:
    """"auto" -> "weights" from WEIGHTS_MIN_ELEMS data elements on, else
    "resample" (the JAX package's rule); other names pass through."""
    if method != "auto":
        return method
    return "weights" if n_elems >= WEIGHTS_MIN_ELEMS else "resample"


def replicate_generator(seed: int, r: int, device) -> torch.Generator:
    """Replicate r's generator, from ``SeedSequence(seed)`` with spawn key
    (_STREAM, r): the same for any chunking or replicate count."""
    child = np.random.SeedSequence(seed, spawn_key=(_STREAM, r))
    g = torch.Generator(device=device)
    g.manual_seed(int(child.generate_state(1, np.uint64)[0] >> 1))
    return g


def _percentiles(arr: np.ndarray, level: float
                 ) -> Tuple[np.ndarray, np.ndarray]:
    a = 1.0 - level / 100.0
    lower = np.percentile(arr, 100 * (a / 2), axis=0)
    upper = np.percentile(arr, 100 * (1 - a / 2), axis=0)
    return lower, upper


def bootstrap_ci(y, d, ref, n_u: int, *, level: float, n_bootstrap: int,
                 init_option: str = "uniform_", n_iter1: int = 10000,
                 n_iter2: int = 20, tol: float = 1e-2, purity=None,
                 seed: int = 1, method: str = "auto",
                 tol_relative: bool = False,
                 indices: Optional[Sequence] = None,
                 inits: Optional[Sequence] = None,
                 axis: Axis = LOCAL, shard: Optional[Shard] = None):
    """Returns (lower_props, upper_props, lower_u, upper_u) as numpy
    arrays; the u bounds are None in the supervised mode (n_u == 0).

    Multi-process runs (the JAX package's ``process_count`` and
    ``process_index``): with ``axis`` of N ranks, each solves its
    contiguous block of the replicates (global indices, so the same
    generators) on its full copy of the data, and the replicates' results
    are gathered over the ranks before the percentiles, so every rank
    returns the one-process intervals. With ``shard`` (the row-sharded
    weights route, ``row_sharded``), y, d and ref are this rank's rows of
    a row-sharded dataset: every replicate runs on every rank through the
    row-sharded multi solvers (K4 on the rank's rows, the Gram partials
    summed, then K5/K6); every rank draws replicate r's (n_cpg,) indices
    from its generator, one replicate at a time, keeps its rows of their
    counts and makes the init on its rows (``solvers/init.py``'s
    ``shard``), and the u bounds are gathered over the ranks. Both
    together (the 2-D layout of ``--multihost --shard``): the replicates
    are partitioned over ``axis`` (the processes) and each is row-sharded
    over ``shard.axis`` (the process's workers).

    y, d (n_cpg, n_s) and ref (n_cpg, n_ct), or None for the unsupervised
    bootstrap, on one device; purity (n_s,) the flipped known-block mass.
    ``indices`` (n_bootstrap, n_cpg) and ``inits`` (n_bootstrap pairs
    (u0 (n_cpg, n_u), alpha0 (p, n_s)), on the original rows in the
    weights layout and on the gathered rows in the resample layout)
    replace the replicates' own draws (with ``shard`` too: each rank
    keeps its rows of them). The replicates per multi-solver
    call are ``fused.max_multi_members`` on the card, CPU_MEMBERS on the
    CPU."""
    unsupervised = ref is None
    supervised = n_u == 0
    if unsupervised and supervised:
        raise ValueError("bootstrap_ci needs ref profiles (supervised) or "
                         "n_u > 0 (unsupervised)")
    n_cpg, n_s = y.shape
    if shard is not None:
        n_cpg = shard.block.n_rows
    method = resolve_method(method, init_option, n_cpg * n_s)
    if method not in ("resample", "weights"):
        raise ValueError(f"unknown bootstrap method {method!r}")
    if shard is not None and not row_sharded(method, n_u, n_s,
                                             ref is not None):
        raise ValueError("the row-sharded bootstrap takes the weights "
                         "layout of the partial-reference or purity mode in "
                         "the gram form (row_sharded)")
    if purity is not None:
        purity = torch.as_tensor(purity, dtype=y.dtype, device=y.device)
    dtype = accum_dtype(y)
    kw = dict(n_iter1=n_iter1, n_iter2=n_iter2, tol=tol,
              tol_relative=tol_relative)

    def draw(r):
        """Replicate r's generator and resample indices (all n_cpg of
        them, with ``shard`` too)."""
        g = replicate_generator(seed, r, y.device)
        if indices is None:
            idx = torch.randint(n_cpg, (n_cpg,), generator=g,
                                device=y.device)
        else:
            idx = torch.as_tensor(np.asarray(indices[r]), device=y.device)
        return g, idx

    @api.checked_init
    def own_init(g, yb, db, refb, w=None, sh=None):
        if unsupervised:
            return init_unsupervised(g, init_option, yb, db, n_u, shard=sh)
        if purity is not None:
            return init_purity(g, init_option, yb, db, refb, n_u, w,
                               purity=purity, shard=sh)
        return init_partial(g, init_option, yb, db, refb, n_u, w, shard=sh)

    # the weights layout's shared SVD/ICA init, made on the data (this
    # rank's rows with ``shard``) at its first use
    shared = {}
    share = (method == "weights" and not supervised and inits is None
             and init_option in DETERMINISTIC)

    def init(r, g, yb, db, refb, w=None, sh=None):
        if inits is not None:
            u0, a0 = (torch.as_tensor(np.asarray(x)).to(yb.device, dtype)
                      for x in inits[r])
            return (u0 if sh is None else sh.rows_of(u0)), a0
        if share:
            if not shared:
                shared["init"] = own_init(replicate_generator(
                    seed, SHARED_INIT, yb.device), yb, db, refb, None, sh)
            return shared["init"]
        return own_init(g, yb, db, refb, w, sh)

    def weights(idx):
        w = torch.bincount(idx, minlength=n_cpg)
        if y.dtype == torch.bfloat16:
            w = torch.clamp(w, max=256)     # the JAX package's bf16 counts
        return w.to(dtype)

    def resample_one(r):
        g, idx = draw(r)
        yb, db = y[idx], d[idx]
        refb = None if unsupervised else ref[idx]
        if supervised:
            return wls_intercept_batch(db * yb, db, refb), None
        init_provided = init(r, g, yb, db, refb)
        if unsupervised:
            res = api.unsupervised_deconv(yb, db, n_u, **kw,
                                          init_provided=init_provided)
        elif purity is not None:
            res = api.purity_deconv(yb, db, refb, n_u, purity, **kw,
                                    init_provided=init_provided)
        else:
            res = api.partial_reference_deconv(yb, db, refb, n_u, **kw,
                                               init_provided=init_provided)
        return res.proportions, res.u

    def weighted_one(r):
        """One replicate through the plain weighted solver (the direct
        form, on the data's device) or, supervised, the weighted WLS."""
        g, idx = draw(r)
        w = weights(idx)
        if supervised:
            return wls_intercept_batch(d * y, w.to(d.dtype)[:, None] * d,
                                       ref), None
        u0, a0 = init(r, g, y, d, ref, w)
        gram_u = fista.use_gram_u(n_u, n_s, n_iter2)
        if unsupervised:
            u, alpha, _ = unsupervised_solve(u0, a0, y, d, n_u,
                                             use_gram_u=gram_u,
                                             row_weights=w, **kw)
        elif purity is not None:
            u, alpha, _ = purity_solve(u0, a0, y, d, ref, purity, n_u,
                                       use_gram_u=gram_u, row_weights=w,
                                       **kw)
        else:
            u, alpha, _ = partial_ref_solve(u0, a0, y, d, ref, n_u,
                                            use_gram_u=gram_u,
                                            row_weights=w, **kw)
        return alpha, u

    def chunk_draws(lo, hi):
        """(w_b, u0_b, a0_b) of replicates lo..hi-1 (with ``shard``, this
        rank's rows of w and u0): replicate r's indices drawn whole, their
        counts kept for this rank's rows, then its init on them."""
        w_b, u0_b, a0_b = [], [], []
        for r in range(lo, hi):
            g, idx = draw(r)
            w = weights(idx)
            del idx
            if shard is not None:
                w = shard.rows_of(w)
            u0, a0 = init(r, g, y, d, ref, w, shard)
            w_b.append(w)
            u0_b.append(u0)
            a0_b.append(a0)
        return tuple(torch.stack(x) for x in (w_b, u0_b, a0_b))

    def weighted_chunk(lo, hi):
        """Replicates lo..hi-1 through one multi-solver call (row-sharded
        with ``shard``: this rank's rows of their u)."""
        w_b, u0_b, a0_b = chunk_draws(lo, hi)
        solver_kw = dict(kw, row_weights_b=w_b)
        if shard is not None:
            solver_kw["axis"] = shard.axis
        if unsupervised:
            u_b, alpha_b, _ = fused.unsupervised_solve_fused_multi(
                u0_b, a0_b, y, d, n_u, **solver_kw)
        elif purity is not None:
            u_b, alpha_b, _ = fused.purity_solve_fused_multi(
                u0_b, a0_b, y, d, ref, purity, n_u, **solver_kw)
        else:
            u_b, alpha_b, _ = fused.partial_ref_solve_fused_multi(
                u0_b, a0_b, y, d, ref, n_u, **solver_kw)
        if shard is not None:
            u_b = u_b[:, :shard.block.n_data]
        return alpha_b, u_b

    props, us = [], []

    def keep(r, alpha, u):
        check_finite(f"bootstrap replicate {r}", alpha=alpha, u=u)
        props.append(alpha.cpu().numpy())
        us.append(None if u is None else u.cpu().numpy())

    # this process's contiguous block of the global replicate indices (all
    # of them in one process; every rank of a row-sharded solve takes the
    # same block)
    per_rank = -(-n_bootstrap // axis.size)
    first = min(axis.rank * per_rank, n_bootstrap)
    last = min(first + per_rank, n_bootstrap)
    if method == "weights" and not supervised and gram_form(n_u, n_s):
        cap = CPU_MEMBERS if y.device.type == "cpu" else (
            fused.max_multi_members(
                y.shape[0], n_s, 0 if unsupervised else ref.shape[1], n_u,
                torch.finfo(dtype).bits // 8, y.element_size(),
                fused.free_device_bytes(y.device), weighted=True))
        if shard is not None:
            cap = int(shard.axis.min_(torch.tensor([cap],
                                                   device=y.device)).item())
        for lo in range(first, last, cap):
            hi = min(lo + cap, last)
            alpha_b, u_b = weighted_chunk(lo, hi)
            check_finite(f"bootstrap replicates {lo}-{hi - 1}",
                         alpha=alpha_b, u=u_b)
            props.extend(alpha_b.cpu().numpy())
            us.extend(u_b.cpu().numpy())
    elif method == "weights":
        for r in range(first, last):
            keep(r, *weighted_one(r))
    else:
        for r in range(first, last):
            keep(r, *resample_one(r))

    props = [p for block in axis.all_gather_object(props) for p in block]
    lo_p, hi_p = _percentiles(np.stack(props), level)
    if supervised:
        return lo_p, hi_p, None, None
    us = [u for block in axis.all_gather_object(us) for u in block]
    lo_u, hi_u = _percentiles(np.stack(us), level)
    if shard is not None:
        lo_u, hi_u = (np.concatenate(shard.axis.all_gather_object(x))
                      for x in (lo_u, hi_u))
    return lo_p, hi_p, lo_u, hi_u


def row_sharded(method: str, n_u: int, n_s: int, has_ref: bool) -> bool:
    """True when ``bootstrap_ci`` runs on a row-sharded dataset (``shard``):
    the weights layout (``method`` resolved) of the partial-reference or
    purity mode in the gram form, the replicates through K4 with its
    weights operand, as the JAX package's ``_fused_gate`` has it (its
    other modes and forms run on the full data)."""
    return (method == "weights" and has_ref and n_u > 0
            and gram_form(n_u, n_s))
