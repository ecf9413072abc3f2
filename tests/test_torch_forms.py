"""K1's forms beyond the partial-reference main path, on the CPU, against
the JAX package's Pallas kernel in interpret mode.

- The kernel solver ``partial_ref_solve_fused`` where K1 leaves the
  n_u <= 4 gram form: one sample with two unknowns (n_u^2 = 4 > 3 n_s,
  the direct form) and five unknowns at ten samples (gram form,
  n_u = 5), from the same initial factors as the JAX kernel solver.
  float64: u and alpha atol 1e-8, cost and trace rtol 1e-9; float32:
  atol 1e-4, rtol 1e-5 (the tolerances of tests/test_torch_solver.py).
  One sample with two unknowns per site fits Y almost exactly, so its
  cost falls to ~1e-2 of sum(D Y^2), the sum the Gram identity cancels
  from; in float32 the costs then also get an absolute floor of
  1e-6 sum(D Y^2) (about eight float32 ulps of that sum).
- The K1 wrapper (its plain twin on CPU tensors) in each form: gram and
  direct, with and without a known block, lagged or not, against
  ``u_phase_grams_packed``: float64 atol 1e-10, float32 rtol and atol
  1e-5 (as tests/test_torch_kernels.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demethify_tpu.ops.pallas_kernels import u_phase_grams_packed
from demethify_tpu.solvers.fused import (
    partial_ref_solve_fused as j_partial_ref_solve_fused,
)
from demethify_tpu_torch import state
from demethify_tpu_torch.ops import cuda_kernels
from demethify_tpu_torch.ops.cuda_kernels import (
    A_U,
    L_W,
    L_W_PREV,
    N_SCAL,
    gram_form,
)
from demethify_tpu_torch.solvers.fused import partial_ref_solve_fused

N_ITER1, N_ITER2, TOL = 10, 6, 1e-9
SOLVER_TOLS = {np.float64: dict(state=1e-8, cost=1e-9, ydy_floor=0.0),
               np.float32: dict(state=1e-4, cost=1e-5, ydy_floor=1e-6)}
KERNEL_TOLS = {np.float64: dict(rtol=0, atol=1e-10),
               np.float32: dict(rtol=1e-5, atol=1e-5)}
TILE = 64


def _problem(n, n_s, n_ct, n_u, seed):
    rng = np.random.default_rng(seed)
    p = n_ct + n_u
    Rt = rng.uniform(size=(n, n_ct))
    u_true = rng.uniform(size=(n, n_u))
    alpha = rng.dirichlet(np.ones(p), size=n_s).T
    d = rng.poisson(50, size=(n, n_s)) + 1.0
    y = np.clip(np.hstack([Rt, u_true]) @ alpha
                + 0.01 * rng.normal(size=(n, n_s)), 0, 1)
    u0 = rng.uniform(size=(n, n_u))
    a0 = rng.dirichlet(np.ones(p), size=n_s).T
    return u0, a0, y, d, Rt


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n_s,n_u", [(1, 2), (10, 5)],
                         ids=["direct_ns1_nu2", "gram_ns10_nu5"])
def test_partial_ref_solver_beyond_main_form(n_s, n_u, dtype):
    u0, a0, y, d, Rt = _problem(150, n_s, 3, n_u, seed=n_s + n_u)
    assert gram_form(n_u, n_s) == (n_s == 10)
    c = lambda x: jnp.asarray(x, dtype)             # noqa: E731
    want = j_partial_ref_solve_fused(
        c(u0), c(a0), c(y), c(d), c(Rt), n_u, n_iter1=N_ITER1,
        n_iter2=N_ITER2, tol=TOL, record_trace=True)
    tensors = state.from_numpy(
        u0, a0, y, d, Rt, device="cpu",
        dtype=torch.float64 if dtype == np.float64 else torch.float32)
    u1, a1, info = partial_ref_solve_fused(*tensors, n_u, n_iter1=N_ITER1,
                                           n_iter2=N_ITER2, tol=TOL,
                                           record_trace=True)
    tol = SOLVER_TOLS[dtype]
    np.testing.assert_allclose(u1.numpy(), np.asarray(want[0]), rtol=0,
                               atol=tol["state"])
    np.testing.assert_allclose(a1.numpy(), np.asarray(want[1]), rtol=0,
                               atol=tol["state"])
    cost_tol = dict(rtol=tol["cost"],
                    atol=tol["ydy_floor"] * float(np.sum(d * y * y)))
    np.testing.assert_allclose(float(info["cost"]), float(want[2]["cost"]),
                               **cost_tol)
    assert info["n_iter"] == int(want[2]["n_iter"]) == N_ITER1
    np.testing.assert_allclose(info["trace"].numpy(),
                               np.asarray(want[2]["trace"]), **cost_tol)


def _pad(x):
    target = -(-x.shape[-1] // TILE) * TILE
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, target - x.shape[-1])])


# (n_s, n_ct, n_u, lagged): every form K1 serves
FORMS = {
    "gram_nu5": (10, 4, 5, False),
    "gram_nu8": (22, 2, 8, False),
    "direct": (2, 4, 3, False),
    "direct_lagged": (2, 4, 3, True),
    "gram_lagged_no_known": (6, 0, 3, True),
    "direct_lagged_no_known": (1, 0, 2, True),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("form", list(FORMS))
def test_u_phase_grams_forms_match_pallas(form, dtype):
    n_s, n_ct, n_u, lagged = FORMS[form]
    _, alpha, y, d, Rt = (np.asarray(x, dtype) for x in
                          _problem(200, n_s, n_ct, n_u, seed=len(form)))
    rng = np.random.default_rng(3)
    u = rng.uniform(size=(200, n_u)).astype(dtype)
    u_prev = np.clip(u + 0.05 * rng.normal(size=u.shape), 0, 1).astype(dtype)
    l_w = dtype(np.sum(alpha[-n_u:] ** 2) * d.max() ** 2)
    a, l_w_prev, steps = dtype(1.7), dtype(0.9 * l_w), 5
    ydt = np.concatenate([y.T, d.T])
    uut = np.concatenate([u.T, u_prev.T])
    known = n_ct > 0

    want = u_phase_grams_packed(
        jnp.asarray(_pad(ydt)), jnp.asarray(_pad(Rt.T)) if known else None,
        jnp.asarray(alpha[:-n_u]) if known else None,
        jnp.asarray(alpha[-n_u:]), jnp.asarray(_pad(uut)), jnp.asarray(a),
        jnp.asarray(l_w), jnp.asarray(l_w_prev), steps, lagged=lagged,
        tile=TILE)
    uut_w, a_w, lwp_w, gu_w, bu_w, usq_w = (np.asarray(x) for x in want)

    t = lambda x: torch.tensor(np.ascontiguousarray(x))  # noqa: E731
    uut_t, alpha_t = t(uut), t(alpha)
    scal = torch.zeros(N_SCAL, dtype=uut_t.dtype)
    scal[A_U], scal[L_W], scal[L_W_PREV] = float(a), float(l_w), \
        float(l_w_prev)
    gu, bu, usq = cuda_kernels.u_phase_grams(
        t(ydt), t(Rt.T) if known else None,
        alpha_t[:-n_u] if known else None, alpha_t[-n_u:], uut_t, scal,
        steps, lagged=lagged)
    tol = KERNEL_TOLS[dtype]
    assert gu.shape == (n_s, n_u, n_ct + n_u)
    np.testing.assert_allclose(uut_t.numpy(), uut_w[:, :200], **tol)
    np.testing.assert_allclose(float(scal[A_U]), float(a_w), rtol=1e-6)
    np.testing.assert_allclose(float(scal[L_W_PREV]), float(lwp_w),
                               rtol=1e-6)
    scale = np.abs(gu_w).max()
    np.testing.assert_allclose(gu.numpy() / scale, gu_w / scale, **tol)
    np.testing.assert_allclose(bu.numpy() / scale, bu_w / scale, **tol)
    np.testing.assert_allclose(float(usq), float(usq_w),
                               rtol=max(tol["rtol"], 1e-12))
    assert cuda_kernels.u_phase_grams.launches == 0


def test_gram_form_rule_matches_the_jax_kernel():
    """gram where n_u^2 <= 3 n_s (``pallas_kernels.py:298``)."""
    assert gram_form(1, 1) and gram_form(4, 6) and gram_form(5, 9)
    assert not gram_form(2, 1) and not gram_form(5, 8)
    assert not gram_form(8, 21) and gram_form(8, 22)
