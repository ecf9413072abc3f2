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
JAX package does. SVD and ICA inits are ROADMAP port queue item 4 (in the
weights layout the JAX package shares one full-data init among the
replicates). The sharded and multi-process routes are item 8.

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
from demethify_tpu_torch.solvers import api, fused
from demethify_tpu_torch.solvers.init import (
    init_partial,
    init_purity,
    init_unsupervised,
)
from demethify_tpu_torch.solvers.partial_ref import partial_ref_solve
from demethify_tpu_torch.solvers.purity import purity_solve
from demethify_tpu_torch.solvers.unsupervised import unsupervised_solve

WEIGHTS_MIN_ELEMS = 2_000_000
# the first spawn key of every replicate's seed sequence: keeps the
# replicate generators apart from ``api.restart_generators``'
_STREAM = 987654321
# replicates per multi-solver call on the CPU (the plain twins hold a few
# (B, n_s, n_cpg) temporaries)
CPU_MEMBERS = 8


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
                 inits: Optional[Sequence] = None):
    """Returns (lower_props, upper_props, lower_u, upper_u) as numpy
    arrays; the u bounds are None in the supervised mode (n_u == 0).

    y, d (n_cpg, n_s) and ref (n_cpg, n_ct), or None for the unsupervised
    bootstrap, on one device; purity (n_s,) the flipped known-block mass.
    ``indices`` (n_bootstrap, n_cpg) and ``inits`` (n_bootstrap pairs
    (u0 (n_cpg, n_u), alpha0 (p, n_s)), on the original rows in the
    weights layout and on the gathered rows in the resample layout)
    replace the replicates' own draws. The replicates per multi-solver
    call are ``fused.max_multi_members`` on the card, CPU_MEMBERS on the
    CPU."""
    unsupervised = ref is None
    supervised = n_u == 0
    if unsupervised and supervised:
        raise ValueError("bootstrap_ci needs ref profiles (supervised) or "
                         "n_u > 0 (unsupervised)")
    n_cpg, n_s = y.shape
    method = resolve_method(method, init_option, n_cpg * n_s)
    if method not in ("resample", "weights"):
        raise ValueError(f"unknown bootstrap method {method!r}")
    if method == "weights" and not supervised and init_option in ("SVD",
                                                                  "ICA"):
        raise NotImplementedError(
            f"--init {init_option} with the weights layout (one full-data "
            f"init shared by the replicates) is ROADMAP port queue item 4")
    if purity is not None:
        purity = torch.as_tensor(purity, dtype=y.dtype, device=y.device)
    dtype = accum_dtype(y)
    kw = dict(n_iter1=n_iter1, n_iter2=n_iter2, tol=tol,
              tol_relative=tol_relative)

    def draw(r):
        """Replicate r's generator and resample indices."""
        g = replicate_generator(seed, r, y.device)
        if indices is None:
            idx = torch.randint(n_cpg, (n_cpg,), generator=g,
                                device=y.device)
        else:
            idx = torch.as_tensor(np.asarray(indices[r]), device=y.device)
        return g, idx

    def init(r, g, yb, db, refb, w=None):
        if inits is not None:
            return tuple(torch.as_tensor(np.asarray(x)).to(y.device, dtype)
                         for x in inits[r])
        if unsupervised:
            return init_unsupervised(g, init_option, yb, db, n_u)
        if purity is not None:
            return init_purity(g, init_option, yb, db, refb, n_u, w)
        return init_partial(g, init_option, yb, db, refb, n_u, w)

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

    def weighted_chunk(lo, hi):
        """Replicates lo..hi-1 through one multi-solver call."""
        w_b, u0_b, a0_b = [], [], []
        for r in range(lo, hi):
            g, idx = draw(r)
            w = weights(idx)
            u0, a0 = init(r, g, y, d, ref, w)
            w_b.append(w)
            u0_b.append(u0)
            a0_b.append(a0)
        w_b, u0_b, a0_b = (torch.stack(x) for x in (w_b, u0_b, a0_b))
        if unsupervised:
            u_b, alpha_b, _ = fused.unsupervised_solve_fused_multi(
                u0_b, a0_b, y, d, n_u, row_weights_b=w_b, **kw)
        elif purity is not None:
            u_b, alpha_b, _ = fused.purity_solve_fused_multi(
                u0_b, a0_b, y, d, ref, purity, n_u, row_weights_b=w_b, **kw)
        else:
            u_b, alpha_b, _ = fused.partial_ref_solve_fused_multi(
                u0_b, a0_b, y, d, ref, n_u, row_weights_b=w_b, **kw)
        return alpha_b, u_b

    props, us = [], []

    def keep(alpha, u):
        props.append(alpha.cpu().numpy())
        us.append(None if u is None else u.cpu().numpy())

    if method == "weights" and not supervised and gram_form(n_u, n_s):
        cap = CPU_MEMBERS if y.device.type == "cpu" else (
            fused.max_multi_members(
                n_cpg, n_s, 0 if unsupervised else ref.shape[1], n_u,
                torch.finfo(dtype).bits // 8, y.element_size(),
                fused.free_device_bytes(y.device), weighted=True))
        for lo in range(0, n_bootstrap, cap):
            alpha_b, u_b = weighted_chunk(lo, min(lo + cap, n_bootstrap))
            props.extend(alpha_b.cpu().numpy())
            us.extend(u_b.cpu().numpy())
    elif method == "weights":
        for r in range(n_bootstrap):
            keep(*weighted_one(r))
    else:
        for r in range(n_bootstrap):
            keep(*resample_one(r))

    lo_p, hi_p = _percentiles(np.stack(props), level)
    if supervised:
        return lo_p, hi_p, None, None
    lo_u, hi_u = _percentiles(np.stack(us), level)
    return lo_p, hi_p, lo_u, hi_u
