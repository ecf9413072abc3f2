"""The unsupervised mode of the port (no reference, R = U, the lagged
u-gradient) on the CPU against the JAX package's (Pallas in interpret
mode) and the NumPy oracle.

Tolerances:
- K2's wrapper without a known block (its plain twin on CPU tensors)
  against the JAX ``alpha_phase_full(None, None, ...)``: float64 atol
  1e-10, float32 rtol and atol 1e-5 (as tests/test_torch_kernels.py);
- solvers against ``unsupervised_solve`` / ``unsupervised_solve_fused``:
  float64 state atol 1e-8, cost rtol 1e-9; float32 atol 1e-4, rtol 1e-5
  with the absolute cost floor 1e-6 sum(D Y^2) of
  tests/test_torch_forms.py; equal n_iter and cost traces;
- the CLI without ``--ref`` against the JAX CLI, on samples made of two
  cell types: the same files, headers and profile shape; proportions
  RMSE < 0.1 after matching the unknown cell types (the random inits
  differ, and the factors are unique only up to the order of their
  rows).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from demethify_tpu.cli import main as jax_cli_main
from demethify_tpu.ops.pallas_small import alpha_phase_full as j_alpha_full
from demethify_tpu.solvers.api import (
    unsupervised_deconv as j_unsupervised_deconv,
)
from demethify_tpu.solvers.fused import (
    unsupervised_solve_fused as j_unsupervised_solve_fused,
)
from demethify_tpu.solvers.unsupervised import (
    unsupervised_solve as j_unsupervised_solve,
)
from demethify_tpu_torch import state
from demethify_tpu_torch.cli import main as torch_cli_main
from demethify_tpu_torch.ops import cuda_kernels, cuda_small
from demethify_tpu_torch.ops.cuda_kernels import (
    A_ALPHA,
    COST,
    DMAX2,
    L_H_PREV,
    L_W,
    N_SCAL,
)
from demethify_tpu_torch.solvers.api import deconvolve, unsupervised_deconv
from demethify_tpu_torch.solvers.fused import unsupervised_solve_fused
from demethify_tpu_torch.solvers.init import init_unsupervised
from demethify_tpu_torch.solvers.unsupervised import unsupervised_solve
from tests import oracle
from tests.test_torch_cli import N_CPG, N_S, _write_fixture

TORCH_DT = {np.float64: torch.float64, np.float32: torch.float32}
N_ITER1, N_ITER2, TOL = 12, 6, 1e-9
SOLVER_TOLS = {np.float64: dict(state=1e-8, cost=1e-9, ydy_floor=0.0),
               np.float32: dict(state=1e-4, cost=1e-5, ydy_floor=1e-6)}


def _t(x):
    return torch.tensor(np.ascontiguousarray(x))


def _problem(n_u, seed, n=150, n_s=6):
    rng = np.random.default_rng(seed)
    u_true = rng.uniform(size=(n, n_u))
    alpha = rng.dirichlet(np.ones(n_u), size=n_s).T
    d = rng.poisson(50, size=(n, n_s)) + 1.0
    y = np.clip(u_true @ alpha + 0.01 * rng.normal(size=(n, n_s)), 0, 1)
    u0 = rng.uniform(size=(n, n_u))
    a0 = rng.dirichlet(np.ones(n_u), size=n_s).T
    return u0, a0, y, d


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n_u", [2, 3])
def test_alpha_phase_full_no_known_matches_pallas(n_u, dtype):
    u, alpha, y, d = (np.asarray(x, dtype) for x in _problem(n_u, seed=n_u))
    rng = np.random.default_rng(2)
    alpha_prev = rng.dirichlet(np.ones(n_u), size=y.shape[1]).T.astype(dtype)
    u64 = u.astype(np.float64)
    gu = np.einsum("is,iu,iq->suq", d, u64, u64).astype(dtype)
    bu = np.einsum("iu,is->us", u64, d * y).astype(dtype)
    usq = dtype(np.sum(u64 ** 2))
    ydy = np.sum(d.astype(np.float64) * y * y, axis=0).astype(dtype)
    dmax2 = dtype(d.max() ** 2)
    a, l_h_prev, steps = dtype(2.1), dtype(1.1 * usq * dmax2), 7
    want = j_alpha_full(None, None, jnp.asarray(gu), jnp.asarray(bu),
                        jnp.asarray(usq), jnp.asarray(ydy),
                        jnp.asarray(alpha), jnp.asarray(alpha_prev),
                        jnp.asarray(a), jnp.asarray(l_h_prev), 0.0, dmax2,
                        steps, n_u)
    al_w, ap_w, a_w, lhp_w, lw_w, cost_w = (np.asarray(x) for x in want)

    alpha_t, alpha_prev_t = _t(alpha), _t(alpha_prev)
    scal = torch.zeros(N_SCAL, dtype=alpha_t.dtype)
    scal[A_ALPHA], scal[L_H_PREV], scal[DMAX2] = float(a), float(l_h_prev), \
        float(dmax2)
    n_s = y.shape[1]
    cuda_small.alpha_phase_full(
        torch.empty((n_s, 0, 0), dtype=alpha_t.dtype),
        torch.empty((0, n_s), dtype=alpha_t.dtype), _t(gu), _t(bu),
        _t(usq), _t(ydy), alpha_t, alpha_prev_t, scal, steps, n_u)
    tol = (dict(rtol=0, atol=1e-10) if dtype == np.float64
           else dict(rtol=1e-5, atol=1e-5))
    np.testing.assert_allclose(alpha_t.numpy(), al_w, **tol)
    np.testing.assert_allclose(alpha_prev_t.numpy(), ap_w, **tol)
    np.testing.assert_allclose(float(scal[A_ALPHA]), float(a_w), rtol=1e-6)
    np.testing.assert_allclose(float(scal[L_H_PREV]), float(lhp_w),
                               rtol=1e-6)
    np.testing.assert_allclose(float(scal[L_W]), float(lw_w), rtol=1e-5)
    scale = float(np.sum(ydy))
    np.testing.assert_allclose(float(scal[COST]) / scale,
                               float(cost_w) / scale, **tol)
    assert cuda_small.alpha_phase_full.launches == 0


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("solver", ["fused", "plain", "plain_direct"])
def test_unsupervised_solvers_match_jax(solver, dtype):
    n_u = 3
    u0, a0, y, d = _problem(n_u, seed=11)
    c = lambda x: jnp.asarray(x, dtype)             # noqa: E731
    kw = dict(n_iter1=N_ITER1, n_iter2=N_ITER2, tol=TOL, record_trace=True)
    if solver == "fused":
        want = j_unsupervised_solve_fused(c(u0), c(a0), c(y), c(d), n_u,
                                          **kw)
    else:
        want = j_unsupervised_solve(c(u0), c(a0), c(y), c(d), n_u,
                                    use_gram_u=solver == "plain", **kw)
    u, alpha, yt, dt, _ = state.from_numpy(u0, a0, y, d, None, device="cpu",
                                           dtype=TORCH_DT[dtype])
    if solver == "fused":
        u1, a1, info = unsupervised_solve_fused(u, alpha, yt, dt, n_u, **kw)
    else:
        u1, a1, info = unsupervised_solve(u, alpha, yt, dt, n_u,
                                          use_gram_u=solver == "plain", **kw)
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
    assert cuda_kernels.u_phase_grams.launches == 0
    assert cuda_small.alpha_phase_full.launches == 0


def test_fused_matches_oracle():
    n_u = 2
    u0, a0, y, d = _problem(n_u, seed=13)
    u_o, a_o = oracle.unsupervised_solve(u0.copy(), a0.copy(), y, d, n_u,
                                         N_ITER1, N_ITER2, TOL)
    u, alpha, yt, dt, _ = state.from_numpy(u0, a0, y, d, None, device="cpu",
                                           dtype=torch.float64)
    u1, a1, _ = unsupervised_solve_fused(u, alpha, yt, dt, n_u,
                                         n_iter1=N_ITER1, n_iter2=N_ITER2,
                                         tol=TOL)
    np.testing.assert_allclose(u1.numpy(), u_o, atol=1e-8)
    np.testing.assert_allclose(a1.numpy(), a_o, atol=1e-8)


def test_unsupervised_api_with_provided_init():
    """The whole unsupervised entry point (init_provided, CPU route, and
    the ``deconvolve`` dispatcher) against the JAX package's, early
    termination included."""
    n_u = 2
    u0, a0, y, d = _problem(n_u, seed=14)
    want = j_unsupervised_deconv(
        jnp.asarray(y), jnp.asarray(d), n_u, n_iter1=300, n_iter2=N_ITER2,
        tol=1e-3, init_provided=(jnp.asarray(u0), jnp.asarray(a0)))
    u, alpha, yt, dt, _ = state.from_numpy(u0, a0, y, d, None, device="cpu",
                                           dtype=torch.float64)
    got = unsupervised_deconv(yt, dt, n_u, n_iter1=300, n_iter2=N_ITER2,
                              tol=1e-3, init_provided=(u, alpha))
    assert 1 < got.n_iter < 300 and got.n_iter == want.n_iter
    np.testing.assert_allclose(got.proportions.numpy(),
                               np.asarray(want.proportions), atol=1e-8)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), atol=1e-8)
    np.testing.assert_allclose(got.cost, want.cost, rtol=1e-9)
    again = deconvolve(yt, dt, None, n_u, n_iter1=300, n_iter2=N_ITER2,
                       tol=1e-3, init_provided=(u, alpha))
    assert torch.equal(again.proportions, got.proportions)


@pytest.mark.parametrize("init", ["uniform_", "beta", "uniform"])
def test_init_unsupervised_draws(init):
    _, _, y, d = _problem(3, seed=1)
    y, d = torch.tensor(y), torch.tensor(d)
    u, alpha = init_unsupervised(torch.Generator().manual_seed(9), init, y,
                                 d, 3)
    assert u.shape == (y.shape[0], 3) and alpha.shape == (3, y.shape[1])
    assert ((u >= 0) & (u <= 1)).all() and (alpha >= 0).all()
    np.testing.assert_allclose(alpha.sum(0).numpy(), 1.0, atol=1e-12)
    if init == "uniform":
        # the reference's broken 'uniform' takes the 'uniform_' draws
        u_, alpha_ = init_unsupervised(torch.Generator().manual_seed(9),
                                       "uniform_", y, d, 3)
        assert torch.equal(u, u_) and torch.equal(alpha, alpha_)


def test_init_unsupervised_fallback_and_svd_ica():
    y = torch.rand((40, 2), dtype=torch.float64)
    for option in ("SVD", "ICA"):
        u, alpha = init_unsupervised(torch.Generator(), option, y, y, 2)
        assert ((u >= 0) & (u <= 1)).all()
        np.testing.assert_allclose(alpha.sum(0).numpy(), 1.0, atol=1e-12)
        # n_u > n_s forces uniform_ before any option is looked at
        u, alpha = init_unsupervised(torch.Generator(), option, y, y, 3)
        assert u.shape == (40, 3) and alpha.shape == (3, 2)
    with pytest.raises(ValueError):
        init_unsupervised(torch.Generator(), "nope", y, y, 1)


def _best_rmse(got, want):
    """RMSE over the best matching of the rows (unknown cell types)."""
    return min(np.sqrt(np.mean((got[list(perm)] - want) ** 2))
               for perm in itertools.permutations(range(got.shape[0])))


def _write_unsupervised_fixture(root, n_u=2, seed=5):
    """bedmethyl samples made of n_u cell types and nothing else."""
    rng = np.random.default_rng(seed)
    R = rng.uniform(size=(N_CPG, n_u))
    alpha = rng.dirichlet(np.ones(n_u), size=N_S).T
    cov = rng.poisson(40, size=(N_CPG, N_S)) + 1
    meth = np.clip(R @ alpha + 0.01 * rng.normal(size=(N_CPG, N_S)), 0, 1)
    samples = []
    for s in range(N_S):
        path = f"{root}/sample{s}.bed"
        with open(path, "w") as f:
            f.write("chrom\tstart\tend\tvalid_coverage\tcount_modified\t"
                    "percent_modified\n")
            for i in range(N_CPG):
                m = meth[i, s]
                f.write(f"chr1\t{i}\t{i + 1}\t{cov[i, s]}\t"
                        f"{int(round(m * cov[i, s]))}\t{100 * m:.4f}\n")
        samples.append(path)
    return samples


def test_unsupervised_cli_matches_jax(tmp_path):
    samples = _write_unsupervised_fixture(str(tmp_path))
    base = ["--methfreq", *samples, "--bedmethyl", "--noprint", "--dtype",
            "float64", "--nbunknown", "2", "--iterations", "200", "10"]
    out_j, out_t = tmp_path / "jax", tmp_path / "torch"
    assert jax_cli_main(base + ["--outdir", str(out_j),
                                "--platform", "cpu"]) == 0
    assert torch_cli_main(base + ["--outdir", str(out_t),
                                  "--device", "cpu"]) == 0
    want = pd.read_csv(out_j / "celltypes_proportions.csv", index_col=0)
    got = pd.read_csv(out_t / "celltypes_proportions.csv", index_col=0)
    assert list(got.index) == list(want.index) == ["unknown_cell_1",
                                                   "unknown_cell_2"]
    assert list(got.columns) == list(want.columns)
    assert got.shape == (2, N_S)
    np.testing.assert_allclose(got.values.sum(axis=0), 1.0, atol=1e-10)
    assert _best_rmse(got.values, want.values) < 0.1
    prof_j = pd.read_csv(out_j / "methylation_profile_estimate.csv")
    prof_t = pd.read_csv(out_t / "methylation_profile_estimate.csv")
    assert list(prof_t.columns) == list(prof_j.columns)
    assert prof_t.shape == prof_j.shape == (N_CPG, 2)


def test_cli_without_ref_needs_unknowns(tmp_path):
    samples, _ = _write_fixture(str(tmp_path))
    with pytest.raises(SystemExit):
        torch_cli_main(["--methfreq", *samples, "--bedmethyl", "--noprint",
                        "--outdir", str(tmp_path / "o"), "--device", "cpu"])
