"""The port's solvers on the CPU against the JAX package's and the NumPy
oracle (tests/oracle.py), from the same initial factors.

float64: u and alpha atol 1e-8, cost rtol 1e-9, equal n_iter and an equal
cost trace (rtol 1e-9), as tests/test_pallas.py holds the JAX kernel
solver to the JAX XLA solver. float32: u and alpha atol 1e-4, cost and
trace rtol 1e-5 (12 outer x 6 inner steps of float32 FISTA in two
summation orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demethify_tpu.solvers.api import (
    partial_reference_deconv as j_partial_reference_deconv,
)
from demethify_tpu.solvers.fused import (
    partial_ref_solve_fused as j_partial_ref_solve_fused,
)
from demethify_tpu_torch import state
from demethify_tpu_torch.ops import cuda_kernels, cuda_small
from demethify_tpu_torch.solvers.api import partial_reference_deconv
from demethify_tpu_torch.solvers.fused import partial_ref_solve_fused
from demethify_tpu_torch.solvers.partial_ref import partial_ref_solve
from tests import oracle

N_ITER1, N_ITER2, TOL = 12, 6, 1e-9
TOLS = {np.float64: dict(state=1e-8, cost=1e-9),
        np.float32: dict(state=1e-4, cost=1e-5)}


def _init(p, seed=6):
    rng = np.random.default_rng(seed)
    n_ct, n_u = p["R_trunc"].shape[1], p["n_u"]
    u0 = rng.uniform(size=(p["y"].shape[0], n_u))
    a0 = rng.dirichlet(np.ones(n_ct + n_u), size=p["y"].shape[1]).T
    return u0, a0


def _jax_fused(u0, a0, p, dtype):
    c = lambda x: jnp.asarray(x, dtype)             # noqa: E731
    out = j_partial_ref_solve_fused(
        c(u0), c(a0), c(p["y"]), c(p["d"]), c(p["R_trunc"]), p["n_u"],
        n_iter1=N_ITER1, n_iter2=N_ITER2, tol=TOL, record_trace=True)
    return (np.asarray(out[0]), np.asarray(out[1]),
            float(out[2]["cost"]), int(out[2]["n_iter"]),
            np.asarray(out[2]["trace"]))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("solver", ["fused", "plain"])
def test_solver_matches_jax_fused(small_problem, solver, dtype):
    p = small_problem
    u0, a0 = _init(p)
    tol = TOLS[dtype]
    u_w, a_w, cost_w, n_w, trace_w = _jax_fused(u0, a0, p, dtype)

    u, alpha, y, d, Rt = state.from_numpy(
        u0, a0, p["y"], p["d"], p["R_trunc"], device="cpu",
        dtype=torch.float64 if dtype == np.float64 else torch.float32)
    fn = partial_ref_solve_fused if solver == "fused" else partial_ref_solve
    u1, a1, info = fn(u, alpha, y, d, Rt, p["n_u"], n_iter1=N_ITER1,
                      n_iter2=N_ITER2, tol=TOL, record_trace=True)
    u1, a1, trace = state.to_numpy(u1, a1, info["trace"])
    np.testing.assert_allclose(u1, u_w, rtol=0, atol=tol["state"])
    np.testing.assert_allclose(a1, a_w, rtol=0, atol=tol["state"])
    np.testing.assert_allclose(float(info["cost"]), cost_w,
                               rtol=tol["cost"])
    assert info["n_iter"] == n_w
    np.testing.assert_allclose(trace, trace_w, rtol=tol["cost"])
    assert cuda_kernels.u_phase_grams.launches == 0
    assert cuda_small.alpha_phase_full.launches == 0


def test_fused_matches_oracle(small_problem):
    p = small_problem
    u0, a0 = _init(p, seed=9)
    R0 = np.hstack([p["R_trunc"], u0])
    u_o, a_o = oracle.partial_ref_solve(
        u0.copy(), R0, a0.copy(), p["y"], p["d"], p["R_trunc"], p["n_u"],
        N_ITER1, N_ITER2, TOL)
    tensors = state.from_numpy(u0, a0, p["y"], p["d"], p["R_trunc"],
                               device="cpu", dtype=torch.float64)
    u1, a1, _ = partial_ref_solve_fused(*tensors, p["n_u"], n_iter1=N_ITER1,
                                        n_iter2=N_ITER2, tol=TOL)
    np.testing.assert_allclose(u1.numpy(), u_o, atol=1e-8)
    np.testing.assert_allclose(a1.numpy(), a_o, atol=1e-8)


def test_early_termination_and_relative_tol(small_problem):
    """A loose tolerance stops both packages at the same iteration."""
    p = small_problem
    u0, a0 = _init(p, seed=12)
    c = lambda x: jnp.asarray(x)                     # noqa: E731
    for rel, tol in ((False, 5.0), (True, 1e-3)):
        want = j_partial_ref_solve_fused(
            c(u0), c(a0), c(p["y"]), c(p["d"]), c(p["R_trunc"]), p["n_u"],
            n_iter1=200, n_iter2=N_ITER2, tol=tol, tol_relative=rel)
        tensors = state.from_numpy(u0, a0, p["y"], p["d"], p["R_trunc"],
                                   device="cpu", dtype=torch.float64)
        got = partial_ref_solve_fused(*tensors, p["n_u"], n_iter1=200,
                                      n_iter2=N_ITER2, tol=tol,
                                      tol_relative=rel)
        assert 1 < got[2]["n_iter"] < 200
        assert got[2]["n_iter"] == int(want[2]["n_iter"])
        np.testing.assert_allclose(float(got[2]["cost"]),
                                   float(want[2]["cost"]), rtol=1e-9)


def test_slice_api_with_provided_init(small_problem):
    """The whole partial-reference entry point (init_provided, CPU route)
    against the JAX package's."""
    p = small_problem
    u0, a0 = _init(p, seed=13)
    want = j_partial_reference_deconv(
        jnp.asarray(p["y"]), jnp.asarray(p["d"]), jnp.asarray(p["R_trunc"]),
        p["n_u"], n_iter1=N_ITER1, n_iter2=N_ITER2, tol=TOL,
        init_provided=(jnp.asarray(u0), jnp.asarray(a0)))
    u, alpha, y, d, Rt = state.from_numpy(u0, a0, p["y"], p["d"],
                                          p["R_trunc"], device="cpu",
                                          dtype=torch.float64)
    got = partial_reference_deconv(y, d, Rt, p["n_u"], n_iter1=N_ITER1,
                                   n_iter2=N_ITER2, tol=TOL,
                                   init_provided=(u, alpha))
    np.testing.assert_allclose(got.proportions.numpy(),
                               np.asarray(want.proportions), atol=1e-8)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), atol=1e-8)
    np.testing.assert_allclose(got.cost, want.cost, rtol=1e-9)
    assert got.n_iter == want.n_iter


def test_restarts_pick_first_minimum(small_problem):
    p = small_problem
    _, _, y, d, Rt = state.from_numpy(None, None, p["y"], p["d"],
                                      p["R_trunc"], device="cpu",
                                      dtype=torch.float64)
    kw = dict(n_iter1=5, n_iter2=4, tol=0.0, seed=3)
    best = partial_reference_deconv(y, d, Rt, p["n_u"], n_restarts=3, **kw)
    singles = [partial_reference_deconv(y, d, Rt, p["n_u"], n_restarts=1,
                                        **kw)]
    assert np.isfinite(best.cost)
    assert best.cost <= singles[0].cost + 1e-12
    np.testing.assert_allclose(best.proportions.sum(0).numpy(), 1.0,
                               atol=1e-12)
