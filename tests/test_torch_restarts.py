"""The batched random restarts of the port on the CPU: its three
``*_solve_fused_multi`` solvers (the K4-K6 twins on CPU tensors) against
the JAX package's solvers of the same names (Pallas in interpret mode) and
against the port's single-member solver on each member; the member cap
and chunking; the first-minimum selection; the routing.

Tolerances, as tests/test_torch_solver.py: float64 state atol 1e-8 and
cost rtol 1e-9; float32 state atol 1e-4 and cost rtol 1e-5, the costs
with the absolute floor 1e-6 sum(D Y^2) of tests/test_torch_forms.py (a
few ulps of the sum the Gram identity cancels from). Per-member n_iter
must be equal. On the card the multi solvers are held to the sequential
single-member kernel solves bit for bit (``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demethify_tpu.solvers.fused import (
    partial_ref_solve_fused_multi as j_partial_multi,
)
from demethify_tpu.solvers.fused import (
    purity_solve_fused_multi as j_purity_multi,
)
from demethify_tpu.solvers.fused import (
    unsupervised_solve_fused_multi as j_unsup_multi,
)
from demethify_tpu_torch import state
from demethify_tpu_torch.ops import cuda_kernels, cuda_multi, cuda_small
from demethify_tpu_torch.ops.cuda_kernels import gram_entries
from demethify_tpu_torch.solvers import api, fused
from demethify_tpu_torch.solvers.init import init_partial

TORCH_DT = {np.float64: torch.float64, np.float32: torch.float32}
SOLVER_TOLS = {np.float64: dict(state=1e-8, cost=1e-9, ydy_floor=0.0),
               np.float32: dict(state=1e-4, cost=1e-5, ydy_floor=1e-6)}
N_ITER1, N_ITER2 = 8, 12


def _batch(p, n_b, n_u, known, seed, purity=None):
    """B members' seeded initial factors (numpy)."""
    rng = np.random.default_rng(seed)
    n_ct = p["R_trunc"].shape[1] if known else 0
    u_b = rng.uniform(size=(n_b, p["y"].shape[0], n_u))
    a_b = np.stack([rng.dirichlet(np.ones(n_ct + n_u),
                                  size=p["y"].shape[1]).T
                    for _ in range(n_b)])
    if purity is not None:
        a_b[:, :n_ct] *= purity / a_b[:, :n_ct].sum(1, keepdims=True)
        a_b[:, n_ct:] *= (1 - purity) / a_b[:, n_ct:].sum(1, keepdims=True)
    return u_b, a_b


def _mode(p, mode, n_b, seed):
    """(port multi solver, JAX multi solver, port single solver, the
    numpy inputs after u_b, alpha_b, n_u) for a mode."""
    n_u = p["n_u"]
    if mode == "unsupervised":
        u_b, a_b = _batch(p, n_b, n_u, False, seed)
        return (fused.unsupervised_solve_fused_multi, j_unsup_multi,
                fused.unsupervised_solve_fused, u_b, a_b,
                (p["y"], p["d"]), n_u)
    if mode == "purity":
        purity = np.random.default_rng(seed + 1).uniform(
            0.3, 0.9, size=p["y"].shape[1])
        u_b, a_b = _batch(p, n_b, n_u, True, seed, purity)
        return (fused.purity_solve_fused_multi, j_purity_multi,
                fused.purity_solve_fused, u_b, a_b,
                (p["y"], p["d"], p["R_trunc"], purity), n_u)
    u_b, a_b = _batch(p, n_b, n_u, True, seed)
    return (fused.partial_ref_solve_fused_multi, j_partial_multi,
            fused.partial_ref_solve_fused, u_b, a_b,
            (p["y"], p["d"], p["R_trunc"]), n_u)


def _torch(u_b, a_b, data, dtype):
    """The port's tensors for the members and the data they share."""
    y, d = data[0], data[1]
    R = data[2] if len(data) > 2 else None
    u_b, a_b, y, d, R = state.from_numpy_batch(u_b, a_b, y, d, R,
                                               device="cpu", dtype=dtype)
    rest = () if R is None else (R,)
    if len(data) > 3:
        rest += (state.purity_from_numpy(data[3], device="cpu",
                                         dtype=dtype),)
    return u_b, a_b, (y, d) + rest


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("mode", ["partial", "purity", "unsupervised"])
def test_multi_solvers_match_jax(small_problem, mode, dtype):
    p = small_problem
    multi, j_multi, _, u_b, a_b, data, n_u = _mode(p, mode, 3, seed=11)
    kw = dict(n_iter1=N_ITER1, n_iter2=N_ITER2, tol=1e-9, record_trace=True)
    want = j_multi(*(jnp.asarray(x, dtype) for x in (u_b, a_b, *data)), n_u,
                   **kw)
    u_t, a_t, data_t = _torch(u_b, a_b, data, TORCH_DT[dtype])
    got = multi(u_t, a_t, *data_t, n_u, **kw)
    tol = SOLVER_TOLS[dtype]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=tol["state"])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=tol["state"])
    cost_tol = dict(rtol=tol["cost"], atol=tol["ydy_floor"] * float(
        np.sum(p["d"] * p["y"] ** 2)))
    np.testing.assert_allclose(got[2]["cost"].numpy(),
                               np.asarray(want[2]["cost"]), **cost_tol)
    np.testing.assert_array_equal(got[2]["n_iter"].numpy(),
                                  np.asarray(want[2]["n_iter"]))
    np.testing.assert_allclose(got[2]["trace"].numpy(),
                               np.asarray(want[2]["trace"]), **cost_tol)
    for fn in (cuda_multi.u_phase_grams_multi,
               cuda_small.alpha_phase_full_multi,
               cuda_small.fw_phase_full_multi):
        assert fn.launches == 0


@pytest.mark.parametrize("mode", ["partial", "purity", "unsupervised"])
def test_multi_solvers_match_single_per_member(small_problem, mode):
    p = small_problem
    multi, _, single, u_b, a_b, data, n_u = _mode(p, mode, 4, seed=12)
    kw = dict(n_iter1=N_ITER1, n_iter2=N_ITER2, tol=1e-9, record_trace=True)
    u_t, a_t, data_t = _torch(u_b, a_b, data, torch.float64)
    got = multi(u_t, a_t, *data_t, n_u, **kw)
    for b in range(4):
        u1, a1, i1 = single(u_t[b], a_t[b], *data_t, n_u, **kw)
        np.testing.assert_allclose(got[0][b].numpy(), u1.numpy(), atol=1e-8)
        np.testing.assert_allclose(got[1][b].numpy(), a1.numpy(), atol=1e-8)
        np.testing.assert_allclose(got[2]["trace"][b].numpy(),
                                   i1["trace"].numpy(), rtol=1e-9)
        assert int(got[2]["n_iter"][b]) == i1["n_iter"]


def test_per_member_termination_thirteen_members(small_problem):
    """A loose tolerance makes the 13 members stop at different outer
    iterations: each member's n_iter, alpha and cost equal its
    single-member run and the JAX multi solver's (a frozen member's
    alpha, a and l_w_prev must not move once it stops)."""
    p = small_problem
    multi, j_multi, single, u_b, a_b, data, n_u = _mode(p, "partial", 13,
                                                         seed=29)
    kw = dict(n_iter1=400, n_iter2=6, tol=5.0)
    u_t, a_t, data_t = _torch(u_b, a_b, data, torch.float64)
    got = multi(u_t, a_t, *data_t, n_u, **kw)
    want = j_multi(*(jnp.asarray(x) for x in (u_b, a_b, *data)), n_u, **kw)
    n_iters = got[2]["n_iter"].numpy()
    assert len(set(n_iters.tolist())) > 1          # members really diverged
    np.testing.assert_array_equal(n_iters, np.asarray(want[2]["n_iter"]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-8)
    np.testing.assert_allclose(got[2]["cost"].numpy(),
                               np.asarray(want[2]["cost"]), rtol=1e-9)
    for b in range(13):
        _, a1, i1 = single(u_t[b], a_t[b], *data_t, n_u, **kw)
        assert i1["n_iter"] == int(n_iters[b])
        np.testing.assert_allclose(got[1][b].numpy(), a1.numpy(), atol=1e-8)


def test_nan_start_is_inactive_and_never_wins(small_problem):
    """A member whose starting cost is NaN does no iteration, and the
    restart selection never picks it."""
    p = small_problem
    multi, _, _, u_b, a_b, data, n_u = _mode(p, "partial", 3, seed=13)
    u_b[1, 0, 0] = np.nan
    u_t, a_t, data_t = _torch(u_b, a_b, data, torch.float64)
    u, alpha, info = multi(u_t, a_t, *data_t, n_u, n_iter1=5, n_iter2=4,
                           tol=1e-9)
    assert info["n_iter"].tolist() == [5, 0, 5]
    assert torch.isnan(info["cost"][1])
    best = api._select_best([(u[b], alpha[b], {k: v[b] for k, v in
                                                info.items()})
                             for b in range(3)])
    assert float(best[2]["cost"]) == float(info["cost"].nan_to_num(
        np.inf).min())


@pytest.mark.parametrize("costs,want", [
    ([3.0, float("nan"), 1.0, 1.0, 2.0], 2),     # first of a tie
    ([float("nan"), float("nan")], 0),            # all NaN: the first
    ([float("nan"), 4.0, float("inf")], 1)])
def test_first_minimum_selection(costs, want):
    results = [(None, k, {"cost": torch.tensor(c)})
               for k, c in enumerate(costs)]
    assert api._select_best(results)[1] == want


def test_member_cap_and_chunking(small_problem):
    """The cap's formula, and chunks of 2 pick the same winner as one
    batch of 5 (the first minimum in restart order)."""
    p = small_problem
    n_cpg, n_s = p["y"].shape
    n_ct, n_u = p["R_trunc"].shape[1], p["n_u"]
    per = 8 * (gram_entries(n_s, n_ct, n_u) * -(-n_cpg // 128)
               + 4 * n_u * n_cpg)
    shared = 8 * n_cpg * (2 * n_s + n_ct)
    free = 2 * (shared + 3 * per)
    assert fused.max_multi_members(n_cpg, n_s, n_ct, n_u, 8, 8, free) == 3
    assert fused.max_multi_members(n_cpg, n_s, n_ct, n_u, 8, 8, free - 2) == 2
    assert fused.max_multi_members(n_cpg, n_s, n_ct, n_u, 8, 8, 0) == 1
    # 1M x 10, 5 + 1, float32, 79 GB free: 18.2 MB a member (2.2 MB of K4
    # partials), 100 MB shared -> 2162 members
    assert fused.max_multi_members(1_000_000, 10, 5, 1, 4, 4,
                                   79 * 10 ** 9) == 2162

    y, d, Rt = (torch.tensor(p[k]) for k in ("y", "d", "R_trunc"))
    kw = dict(n_iter1=6, n_iter2=5, tol=1e-9, record_trace=True)

    def solve_multi(u0_b, a0_b):
        return fused.partial_ref_solve_fused_multi(u0_b, a0_b, y, d, Rt, n_u,
                                                   **kw)

    def init_fn(g):
        return init_partial(g, "uniform_", y, d, Rt, n_u)

    whole = api._batched_restarts(solve_multi, init_fn, "cpu", 7, 5, 5)
    chunked = api._batched_restarts(solve_multi, init_fn, "cpu", 7, 5, 2)
    np.testing.assert_allclose(chunked[1].numpy(), whole[1].numpy(),
                               atol=1e-12)
    np.testing.assert_allclose(float(chunked[2]["cost"]),
                               float(whole[2]["cost"]), rtol=1e-12)
    # and the same winner as the sequential route on the same generators
    seq = api.partial_reference_deconv(y, d, Rt, n_u, seed=7, n_restarts=5,
                                       **kw)
    np.testing.assert_allclose(seq.cost, float(whole[2]["cost"]), rtol=1e-9)
    np.testing.assert_allclose(seq.proportions.numpy(), whole[1].numpy(),
                               atol=1e-8)


@pytest.mark.parametrize("device,n_u,n_s,n_restarts,provided,want", [
    ("cuda", 1, 10, 4, False, "batch"),
    ("cuda", 3, 10, 8, False, "batch"),          # 9 <= 30: gram form
    ("cuda", 2, 1, 4, False, "sequential"),      # direct form (4 > 3)
    ("cuda", 4, 5, 4, False, "sequential"),      # direct form (16 > 15)
    ("cuda", 1, 10, 1, False, "sequential"),     # one restart
    ("cuda", 1, 10, 4, True, "sequential"),      # init_provided
    ("cpu", 1, 10, 4, False, "sequential")])     # the plain solvers
def test_restart_route(device, n_u, n_s, n_restarts, provided, want):
    init = (None, None) if provided else None
    assert api.restart_route(device, n_u, n_s, n_restarts, init) == want


def test_row_weights_and_row_mask_raise_naming_their_items(small_problem):
    """Row weights are ported (the weighted bootstrap): all-ones weights
    give the unweighted restarts, and a weight row of the wrong length is
    refused; K5's row_mask_b still names its item."""
    p = small_problem
    u_b, a_b = _batch(p, 2, p["n_u"], True, seed=1)
    u_t, a_t, (y, d, Rt) = _torch(u_b, a_b, (p["y"], p["d"], p["R_trunc"]),
                                  torch.float64)
    w = torch.ones(2, y.shape[0], dtype=torch.float64)
    kw = dict(n_iter1=4, n_iter2=5, tol=1e-9, record_trace=True)
    ones = fused.partial_ref_solve_fused_multi(u_t, a_t, y, d, Rt, p["n_u"],
                                               row_weights_b=w, **kw)
    plain = fused.partial_ref_solve_fused_multi(u_t, a_t, y, d, Rt, p["n_u"],
                                                **kw)
    np.testing.assert_allclose(ones[1].numpy(), plain[1].numpy(), atol=1e-12)
    np.testing.assert_allclose(ones[2]["trace"].numpy(),
                               plain[2]["trace"].numpy(), rtol=1e-12)
    pur = torch.full((y.shape[1],), 0.5, dtype=torch.float64)
    with pytest.raises(ValueError, match="row_weights_b"):
        fused.purity_solve_fused_multi(u_t, a_t, y, d, Rt, pur, p["n_u"],
                                       row_weights_b=w[:, 1:])
    with pytest.raises(NotImplementedError, match="item 10"):
        cuda_small.alpha_phase_full_multi(
            *(torch.zeros(1) for _ in range(8)), torch.zeros(1, 10), 3, 1,
            row_mask_b=torch.ones(1, 3))
    assert cuda_kernels.u_phase_grams.launches == 0


def test_from_numpy_batch_checks_shapes(small_problem):
    p = small_problem
    u_b, a_b = _batch(p, 2, p["n_u"], True, seed=1)
    out = state.from_numpy_batch(u_b, a_b, p["y"], p["d"], p["R_trunc"],
                                 device="cpu", dtype=torch.float32)
    assert out[0].shape == u_b.shape and out[1].dtype == torch.float32
    assert all(t.is_contiguous() for t in out)
    with pytest.raises(ValueError):
        state.from_numpy_batch(u_b[0], a_b, p["y"], p["d"], None,
                               device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError):
        state.from_numpy_batch(u_b, a_b[:1], p["y"], p["d"], None,
                               device="cpu", dtype=torch.float64)
