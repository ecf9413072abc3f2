"""The purity-constrained mode of the port on the CPU against the JAX
package's (Pallas in interpret mode) and the NumPy oracle.

Tolerances:
- K3's wrapper (its plain twin on CPU tensors) against the JAX
  ``fw_phase_full``: alpha atol 1e-12 in float64, 1e-5 in float32; the
  cost relative to sum(ydy), the sum the Gram identity cancels from;
  exact ties must go to the first row;
- ``frank_wolfe_gram`` against the JAX one and ``tests/oracle.py``:
  atol 1e-12 (float64);
- solvers against ``purity_solve`` / ``purity_solve_fused``: as
  tests/test_torch_solver.py (float64 state atol 1e-8, cost rtol 1e-9;
  float32 atol 1e-4, rtol 1e-5), equal n_iter and cost traces; in
  float32 the costs also get the absolute floor 1e-6 sum(D Y^2) of
  tests/test_torch_forms.py (a few ulps of the sum the Gram identity
  cancels from);
- the CLI against the JAX CLI: the known-block mass equals 1 - p/100 per
  column to 1e-10; proportions RMSE < 0.1 (the random inits differ).
"""

import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from demethify_tpu.cli import main as jax_cli_main
from demethify_tpu.ops.frank_wolfe import frank_wolfe_gram as j_fw_gram
from demethify_tpu.ops.pallas_small import fw_phase_full as j_fw_phase_full
from demethify_tpu.solvers.api import purity_deconv as j_purity_deconv
from demethify_tpu.solvers.fused import (
    purity_solve_fused as j_purity_solve_fused,
)
from demethify_tpu.solvers.purity import purity_solve as j_purity_solve
from demethify_tpu_torch import state
from demethify_tpu_torch.cli import flip_purity
from demethify_tpu_torch.cli import main as torch_cli_main
from demethify_tpu_torch.ops import cuda_kernels, cuda_small
from demethify_tpu_torch.ops.cuda_kernels import COST, DMAX2, L_W, N_SCAL
from demethify_tpu_torch.ops.frank_wolfe import (
    frank_wolfe_direct,
    frank_wolfe_gram,
)
from demethify_tpu_torch.ops.nnls import wls_intercept_batch
from demethify_tpu_torch.solvers.api import purity_deconv
from demethify_tpu_torch.solvers.fused import purity_solve_fused
from demethify_tpu_torch.solvers.init import init_purity
from demethify_tpu_torch.solvers.purity import purity_solve
from tests import oracle
from tests.test_torch_cli import N_CPG, N_CT, N_S, _write_fixture

TORCH_DT = {np.float64: torch.float64, np.float32: torch.float32}
N_ITER1, N_ITER2, TOL = 8, 12, 1e-9
SOLVER_TOLS = {np.float64: dict(state=1e-8, cost=1e-9, ydy_floor=0.0),
               np.float32: dict(state=1e-4, cost=1e-5, ydy_floor=1e-6)}


def _t(x):
    return torch.tensor(np.ascontiguousarray(x))


def _grams(n, n_s, n_ct, n_u, dtype, seed):
    """Known and new-u Gram blocks of a random problem, as K1 gives them."""
    rng = np.random.default_rng(seed)
    R = rng.uniform(size=(n, n_ct + n_u))
    alpha = rng.dirichlet(np.ones(n_ct + n_u), size=n_s).T
    d = rng.poisson(50, size=(n, n_s)) + 1.0
    y = np.clip(R @ alpha + 0.01 * rng.normal(size=(n, n_s)), 0, 1)
    Rt, u = R[:, :n_ct], R[:, n_ct:]
    gtt = np.einsum("ic,is,ie->sce", Rt, d, Rt)
    bt = np.einsum("ic,is->cs", Rt, d * y)
    gu = np.einsum("is,iu,iq->suq", d, u, R)
    bu = np.einsum("iu,is->us", u, d * y)
    ydy = np.sum(d * y * y, axis=0)
    purity = rng.uniform(0.3, 0.9, size=n_s)
    a1 = rng.dirichlet(np.ones(n_ct), size=n_s).T * purity
    a2 = rng.dirichlet(np.ones(n_u), size=n_s).T * (1 - purity)
    cast = lambda x: np.asarray(x, dtype)           # noqa: E731
    return (cast(gtt), cast(bt), cast(gu), cast(bu), cast(ydy),
            cast(np.vstack([a1, a2])), cast(purity), dtype(d.max() ** 2))


def _k3_both(gtt, bt, gu, bu, ydy, alpha, purity, dmax2, steps, n_u):
    want = j_fw_phase_full(jnp.asarray(gtt), jnp.asarray(bt),
                           jnp.asarray(gu), jnp.asarray(bu),
                           jnp.asarray(ydy), jnp.asarray(alpha),
                           jnp.asarray(purity), dmax2, steps, n_u)
    alpha_t = _t(alpha)
    scal = torch.zeros(N_SCAL, dtype=alpha_t.dtype)
    scal[DMAX2] = float(dmax2)
    cuda_small.fw_phase_full(_t(gtt), _t(bt), _t(gu), _t(bu), _t(ydy),
                             alpha_t, _t(purity), scal, steps, n_u)
    return [np.asarray(x) for x in want], alpha_t, scal


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n_ct,n_u", [(5, 1), (24, 2)], ids=["p6", "p26"])
def test_fw_phase_full_matches_pallas(n_ct, n_u, dtype):
    blocks = _grams(150, 6, n_ct, n_u, dtype, seed=n_ct)
    (al_w, lw_w, cost_w), alpha_t, scal = _k3_both(*blocks, 16, n_u)
    atol = 1e-12 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(alpha_t.numpy(), al_w, rtol=0, atol=atol)
    np.testing.assert_allclose(float(scal[L_W]), float(lw_w),
                               rtol=100 * atol)
    scale = float(np.sum(blocks[4]))
    np.testing.assert_allclose(float(scal[COST]) / scale,
                               float(cost_w) / scale, rtol=0, atol=atol)
    # Frank-Wolfe keeps each column on its purity-scaled simplexes
    purity = blocks[6]
    np.testing.assert_allclose(alpha_t[:n_ct].sum(0).numpy(), purity,
                               atol=10 * atol)
    assert cuda_small.fw_phase_full.launches == 0


def test_fw_exact_ties_take_the_first_row():
    """G = 0 and tied entries of b: the gradient -b ties exactly, every
    step picks the same vertex, and it is the first row of each tie."""
    n_s, n_ct, n_u = 3, 4, 3
    gtt = np.zeros((n_s, n_ct, n_ct))
    gu = np.zeros((n_s, n_u, n_ct + n_u))
    bt = np.array([[1.0, 2.0, 5.0], [3.0, 2.0, 5.0], [3.0, 1.0, 5.0],
                   [2.0, 2.0, 5.0]])                 # ties in rows 1/2, 0/1/3
    bu = np.array([[1.0, 4.0, 2.0], [1.0, 4.0, 2.0], [0.5, 4.0, 1.0]])
    ydy = np.full(n_s, 10.0)
    purity = np.array([0.6, 0.7, 0.8])
    alpha = np.vstack([np.full((n_ct, n_s), 0.25) * purity,
                       np.full((n_u, n_s), 1 / 3) * (1 - purity)])
    (al_w, _, _), alpha_t, _ = _k3_both(gtt, bt, gu, bu, ydy, alpha,
                                        purity, 1.0, 7, n_u)
    want = np.zeros_like(alpha)
    for s, (k1, k2) in enumerate([(1, 0), (0, 0), (0, 0)]):
        want[k1, s] = purity[s]
        want[n_ct + k2, s] = 1 - purity[s]
    # (1 - gamma) s + gamma s rounds in the last bit
    np.testing.assert_allclose(alpha_t.numpy(), want, rtol=0, atol=1e-15)
    np.testing.assert_allclose(al_w, want, rtol=0, atol=1e-15)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_frank_wolfe_gram_matches_jax_and_oracle(small_problem, dtype):
    p = small_problem
    R = np.hstack([p["R_trunc"], p["u_true"]])
    n_ct = p["R_trunc"].shape[1]
    rng = np.random.default_rng(8)
    purity = rng.uniform(0.3, 0.9, size=p["y"].shape[1])
    a1 = rng.dirichlet(np.ones(n_ct), size=len(purity)).T * purity
    a2 = rng.dirichlet(np.ones(p["n_u"]), size=len(purity)).T * (1 - purity)
    G = np.einsum("ip,is,iq->spq", R, p["d"], R)
    b = np.einsum("ip,is->ps", R, p["d"] * p["y"])
    c = lambda x: np.asarray(x, dtype)              # noqa: E731
    got = frank_wolfe_gram(_t(c(a1)), _t(c(a2)), _t(c(G)), _t(c(b)),
                           _t(c(purity)), 30)
    want = j_fw_gram(*(jnp.asarray(c(x)) for x in (a1, a2, G, b, purity)),
                     30)
    atol = 1e-12 if dtype == np.float64 else 1e-5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol)
    if dtype == np.float64:
        o1, o2 = oracle.frank_wolfe(p["R_trunc"], p["u_true"], p["y"], a1,
                                    a2, purity, 30, p["d"])
        d1, d2 = frank_wolfe_direct(
            *(_t(x) for x in (p["R_trunc"], p["u_true"], p["y"], a1, a2,
                              purity)), 30, _t(p["d"]))
        for g, dd, o in zip(got, (d1, d2), (o1, o2)):
            np.testing.assert_allclose(g.numpy(), o, atol=1e-12)
            np.testing.assert_allclose(dd.numpy(), o, atol=1e-12)


def _init(p, seed):
    rng = np.random.default_rng(seed)
    n_ct, n_u, n_s = p["R_trunc"].shape[1], p["n_u"], p["y"].shape[1]
    purity = rng.uniform(0.3, 0.9, size=n_s)
    u0 = rng.uniform(size=(p["y"].shape[0], n_u))
    a0 = np.vstack([rng.dirichlet(np.ones(n_ct), size=n_s).T * purity,
                    rng.dirichlet(np.ones(n_u), size=n_s).T
                    * (1 - purity)])
    return u0, a0, purity


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("solver", ["fused", "plain"])
def test_purity_solvers_match_jax(small_problem, solver, dtype):
    p = small_problem
    u0, a0, purity = _init(p, seed=5)
    c = lambda x: jnp.asarray(x, dtype)             # noqa: E731
    j_fn = j_purity_solve_fused if solver == "fused" else j_purity_solve
    want = j_fn(c(u0), c(a0), c(p["y"]), c(p["d"]), c(p["R_trunc"]),
                c(purity), p["n_u"], n_iter1=N_ITER1, n_iter2=N_ITER2,
                tol=TOL, record_trace=True)
    tdt = TORCH_DT[dtype]
    u, alpha, y, d, Rt = state.from_numpy(u0, a0, p["y"], p["d"],
                                          p["R_trunc"], device="cpu",
                                          dtype=tdt)
    pur = state.purity_from_numpy(purity, device="cpu", dtype=tdt)
    fn = purity_solve_fused if solver == "fused" else purity_solve
    u1, a1, info = fn(u, alpha, y, d, Rt, pur, p["n_u"], n_iter1=N_ITER1,
                      n_iter2=N_ITER2, tol=TOL, record_trace=True)
    tol = SOLVER_TOLS[dtype]
    np.testing.assert_allclose(u1.numpy(), np.asarray(want[0]), rtol=0,
                               atol=tol["state"])
    np.testing.assert_allclose(a1.numpy(), np.asarray(want[1]), rtol=0,
                               atol=tol["state"])
    cost_tol = dict(rtol=tol["cost"], atol=tol["ydy_floor"] * float(
        np.sum(p["d"] * p["y"] ** 2)))
    np.testing.assert_allclose(float(info["cost"]), float(want[2]["cost"]),
                               **cost_tol)
    assert info["n_iter"] == int(want[2]["n_iter"]) == N_ITER1
    np.testing.assert_allclose(info["trace"].numpy(),
                               np.asarray(want[2]["trace"]), **cost_tol)
    n_ct = p["R_trunc"].shape[1]
    np.testing.assert_allclose(a1[:n_ct].sum(0).numpy(), purity,
                               atol=1e-12 if dtype == np.float64 else 1e-5)
    assert cuda_kernels.u_phase_grams.launches == 0
    assert cuda_small.fw_phase_full.launches == 0


def test_purity_api_with_provided_init(small_problem):
    """The whole purity entry point (init_provided, CPU route) against the
    JAX package's, early termination included."""
    p = small_problem
    u0, a0, purity = _init(p, seed=6)
    want = j_purity_deconv(
        jnp.asarray(p["y"]), jnp.asarray(p["d"]), jnp.asarray(p["R_trunc"]),
        p["n_u"], jnp.asarray(purity), n_iter1=200, n_iter2=10, tol=5.0,
        init_provided=(jnp.asarray(u0), jnp.asarray(a0)))
    u, alpha, y, d, Rt = state.from_numpy(u0, a0, p["y"], p["d"],
                                          p["R_trunc"], device="cpu",
                                          dtype=torch.float64)
    got = purity_deconv(y, d, Rt, p["n_u"], purity, n_iter1=200,
                        n_iter2=10, tol=5.0, init_provided=(u, alpha))
    assert 1 < got.n_iter < 200 and got.n_iter == want.n_iter
    np.testing.assert_allclose(got.proportions.numpy(),
                               np.asarray(want.proportions), atol=1e-8)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), atol=1e-8)
    np.testing.assert_allclose(got.cost, want.cost, rtol=1e-9)


@pytest.mark.parametrize("init", ["uniform_", "beta", "uniform"])
def test_init_purity_draws(small_problem, init):
    p = small_problem
    y, d, Rt = (torch.tensor(p[k]) for k in ("y", "d", "R_trunc"))
    u, alpha = init_purity(torch.Generator().manual_seed(4), init, y, d, Rt,
                           p["n_u"])
    assert u.shape == (y.shape[0], p["n_u"])
    assert alpha.shape == (Rt.shape[1] + p["n_u"], y.shape[1])
    assert ((u >= 0) & (u <= 1)).all() and (alpha >= 0).all()
    if init == "uniform":
        # no zero-guard: exactly the WLS fit on [Rt | u]
        assert torch.equal(alpha, wls_intercept_batch(
            y, d, torch.cat([Rt, u], dim=1)))
    else:
        np.testing.assert_allclose(alpha.sum(0).numpy(), 1.0, atol=1e-12)


def test_init_purity_fallback_and_svd_ica():
    y = torch.rand((50, 2), dtype=torch.float64)
    Rt = torch.rand((50, 3), dtype=torch.float64)
    purity = torch.tensor([0.4, 0.7], dtype=torch.float64)
    for option in ("SVD", "ICA"):
        # SVD and ICA scale by the purity, so they need it
        with pytest.raises(ValueError, match="purity"):
            init_purity(torch.Generator(), option, y, y, Rt, 1)
        u, alpha = init_purity(torch.Generator(), option, y, y, Rt, 1,
                               purity=purity)
        assert u.shape == (50, 1) and alpha.shape == (4, 2)
        np.testing.assert_allclose(alpha[:3].sum(0).numpy(), purity.numpy(),
                                   atol=1e-12)
        # n_u > n_s forces uniform_ before any option is looked at
        u, alpha = init_purity(torch.Generator(), option, y, y, Rt, 3)
        assert u.shape == (50, 3) and alpha.shape == (6, 2)
        np.testing.assert_allclose(alpha.sum(0).numpy(), 1.0, atol=1e-12)


def test_purity_from_numpy_and_flip(capsys):
    pur = state.purity_from_numpy(np.array([0.25, 0.5]), device="cpu",
                                  dtype=torch.float32)
    assert pur.dtype == torch.float32 and pur.is_contiguous()
    with pytest.raises(ValueError):
        state.purity_from_numpy(np.ones((2, 2)), device="cpu",
                                dtype=torch.float64)
    np.testing.assert_allclose(flip_purity([20.0, 75.0], 2), [0.8, 0.25])
    flip_purity([0.5, 60.0], 2)
    assert "between 0 and 1" in capsys.readouterr().out
    for bad, n in (([120.0, 50.0], 2), ([50.0], 2)):
        with pytest.raises(SystemExit):
            flip_purity(bad, n)


def test_purity_cli_matches_jax(tmp_path):
    samples, ref = _write_fixture(str(tmp_path))
    percent = ["20", "35", "50", "65"]
    base = ["--methfreq", *samples, "--ref", ref, "--bedmethyl", "--noprint",
            "--dtype", "float64", "--nbunknown", "1", "--purity", *percent,
            "--iterations", "20", "50"]
    out_j, out_t = tmp_path / "jax", tmp_path / "torch"
    assert jax_cli_main(base + ["--outdir", str(out_j),
                                "--platform", "cpu"]) == 0
    assert torch_cli_main(base + ["--outdir", str(out_t),
                                  "--device", "cpu"]) == 0
    want = pd.read_csv(out_j / "celltypes_proportions.csv", index_col=0)
    got = pd.read_csv(out_t / "celltypes_proportions.csv", index_col=0)
    assert list(got.index) == list(want.index)
    assert list(got.columns) == list(want.columns)
    mass = 1 - np.array(percent, dtype=float) / 100
    np.testing.assert_allclose(got.values[:N_CT].sum(axis=0), mass,
                               atol=1e-10)
    np.testing.assert_allclose(got.values[N_CT:].sum(axis=0), 1 - mass,
                               atol=1e-10)
    assert np.sqrt(np.mean((got.values - want.values) ** 2)) < 0.1
    prof = pd.read_csv(out_t / "methylation_profile_estimate.csv")
    assert prof.shape == (N_CPG, 1) and list(prof.columns) == list(
        pd.read_csv(out_j / "methylation_profile_estimate.csv").columns)
    assert os.path.exists(out_t / "log.log")
    assert got.shape == (N_CT + 1, N_S)
