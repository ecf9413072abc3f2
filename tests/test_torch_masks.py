"""Row masks: K2 ``alpha_phase_full(row_mask=)``, K5
``alpha_phase_full_multi(row_mask_b=)``, the masked simplex projection,
``fista_alpha_gram(row_mask=)``, the plain ``partial_ref_solve(row_mask=)``
and the padded ``partial_ref_solve_fused(row_mask=)``, each against its
JAX counterpart (Pallas in interpret mode, the XLA solvers jitted), and
the padded solve against the port's own lower-rank solve.

The padded solve's contract (the JAX package's
``tests/test_pallas.py::TestFusedRowMask``): with the inactive u columns
and alpha rows starting at zero, they stay exactly 0, and the active
block equals the lower-rank solve. Tolerances: float64 1e-12 for the
alpha kernels and projections (the same arithmetic, summed in other
orders), 1e-10 for the solves (ten outer iterations). The CUDA kernels
have no CPU mode; ``chip_smoke.py`` checks them against these same twins
on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demethify_tpu.ops.fista import fista_alpha_gram as j_fista_alpha
from demethify_tpu.ops.gram import known_block_grams as j_known_grams
from demethify_tpu.ops.pallas_small import alpha_phase_full as j_k2
from demethify_tpu.ops.pallas_small import alpha_phase_full_multi as j_k5
from demethify_tpu.ops.simplex import (
    project_columns_to_simplex_masked as j_project_masked,
)
from demethify_tpu.solvers.fused import partial_ref_solve_fused as j_fused
from demethify_tpu.solvers.partial_ref import partial_ref_solve as j_plain
from demethify_tpu_torch.ops import cuda_small
from demethify_tpu_torch.ops.cuda_kernels import (
    A_ALPHA,
    ACTIVE,
    COST,
    DMAX2,
    L_H_PREV,
    L_W,
    N_SCAL,
    N_SCAL_MULTI,
    RT_SQ,
)
from demethify_tpu_torch.ops.fista import fista_alpha_gram
from demethify_tpu_torch.ops.simplex import project_columns_to_simplex_masked
from demethify_tpu_torch.solvers import fused
from demethify_tpu_torch.solvers.partial_ref import partial_ref_solve

TOL = dict(rtol=0, atol=1e-12)
SOLVE_TOL = dict(rtol=0, atol=1e-10)
N, N_S, N_CT, N_U = 150, 6, 4, 3


def _t(x):
    return torch.tensor(np.ascontiguousarray(x))


def _glue(n_b, seed):
    """Known blocks and n_b members' new-u blocks, alpha and alpha_prev."""
    rng = np.random.default_rng(seed)
    p = N_CT + N_U
    R = rng.uniform(size=(N, p))
    d = rng.poisson(50, size=(N, N_S)) + 1.0
    y = np.clip(R @ rng.dirichlet(np.ones(p), size=N_S).T
                + 0.01 * rng.normal(size=(N, N_S)), 0, 1)
    Rt = R[:, :N_CT]
    gtt, bt, ydy = (np.asarray(x) for x in j_known_grams(
        jnp.asarray(Rt), jnp.asarray(d), jnp.asarray(y)))
    u = rng.uniform(size=(n_b, N, N_U))
    R_b = np.concatenate([np.broadcast_to(Rt, (n_b, N, N_CT)), u], axis=2)
    gu = np.einsum("is,biu,biq->bsuq", d, u, R_b)
    bu = np.einsum("biu,is->bus", u, d * y)
    usq = np.sum(u * u, axis=(1, 2))
    alpha = np.stack([rng.dirichlet(np.ones(p), size=N_S).T
                      for _ in range(2 * n_b)])
    return (gtt, bt, gu, bu, usq, ydy, alpha[:n_b], alpha[n_b:],
            d.max() ** 2, np.sum(Rt ** 2))


def test_masked_projection_matches_jax():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(9, 40))
    mask = np.array([1, 0, 1, 1, 0, 1, 1, 1, 0], bool)
    want = np.asarray(j_project_masked(jnp.asarray(v), jnp.asarray(mask)))
    got = project_columns_to_simplex_masked(_t(v), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got[~mask], 0.0)
    # a mask per column: each column projected with its own rows
    per_col = rng.uniform(size=v.shape) > 0.3
    per_col[0] = True
    got = project_columns_to_simplex_masked(_t(v), _t(per_col)).numpy()
    for c in range(v.shape[1]):
        col = np.asarray(j_project_masked(jnp.asarray(v[:, c:c + 1]),
                                          jnp.asarray(per_col[:, c])))
        np.testing.assert_allclose(got[:, c:c + 1], col, **TOL)


def test_fista_alpha_gram_row_mask_matches_jax():
    gtt, bt, gu, bu, usq, ydy, al, ap, dmax2, rt_sq = _glue(1, seed=1)
    G = np.concatenate([np.concatenate([gtt, np.swapaxes(
        gu[0][:, :, :N_CT], 1, 2)], axis=2), gu[0]], axis=1)
    b = np.concatenate([bt, bu[0]])
    l_h = (rt_sq + usq[0]) * dmax2
    mask = np.array([1, 1, 0, 1, 1, 0, 1], bool)
    j = jnp.asarray
    want = j_fista_alpha(j(al[0]), j(ap[0]), j(2.0), j(1.1 * l_h), j(l_h),
                         j(G), j(b), 9, row_mask=j(mask))
    f64 = lambda x: torch.tensor(x, dtype=torch.float64)  # noqa: E731
    got = fista_alpha_gram(_t(al[0]), _t(ap[0]), f64(2.0), f64(1.1 * l_h),
                           f64(l_h), _t(G), _t(b), 9, _t(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **TOL)
    np.testing.assert_array_equal(got[0].numpy()[~mask], 0.0)


@pytest.mark.parametrize("mask", [[1, 1, 1, 1, 1, 0, 0],
                                  [1, 0, 1, 1, 1, 1, 0],
                                  [1, 1, 1, 1, 1, 1, 1]],
                         ids=["unknown-rows", "known-and-unknown",
                              "all-ones"])
def test_alpha_phase_full_row_mask_matches_pallas(mask):
    gtt, bt, gu, bu, usq, ydy, al, ap, dmax2, rt_sq = _glue(1, seed=2)
    mask = np.asarray(mask, np.float64)
    a, l_h_prev, steps = 2.3, 1.1 * (rt_sq + usq[0]) * dmax2, 7
    j = jnp.asarray
    want = j_k2(j(gtt), j(bt), j(gu[0]), j(bu[0]), j(usq[0]), j(ydy),
                j(al[0]), j(ap[0]), j(a), j(l_h_prev), rt_sq, dmax2, steps,
                N_U, row_mask=j(mask))
    al_w, ap_w, _, _, lw_w, cost_w = (np.asarray(x) for x in want)

    def run(row_mask):
        scal = torch.zeros(N_SCAL, dtype=torch.float64)
        scal[A_ALPHA], scal[L_H_PREV], scal[RT_SQ], scal[DMAX2] = (
            a, l_h_prev, rt_sq, dmax2)
        alpha, alpha_prev = _t(al[0]), _t(ap[0])
        cuda_small.alpha_phase_full(_t(gtt), _t(bt), _t(gu[0]), _t(bu[0]),
                                    _t(usq[0]), _t(ydy), alpha, alpha_prev,
                                    scal, steps, N_U, row_mask)
        return alpha, alpha_prev, scal

    alpha, alpha_prev, scal = run(_t(mask))
    np.testing.assert_allclose(alpha.numpy(), al_w, **TOL)
    np.testing.assert_allclose(alpha_prev.numpy(), ap_w, **TOL)
    np.testing.assert_array_equal(alpha.numpy()[mask == 0], 0.0)
    np.testing.assert_allclose(float(scal[L_W]), float(lw_w), rtol=1e-12)
    scale = float(np.sum(ydy))
    np.testing.assert_allclose(float(scal[COST]) / scale,
                               float(cost_w) / scale, **TOL)
    if mask.all():                      # an all-ones mask is no mask
        for x, y in zip((alpha, alpha_prev, scal), run(None)):
            assert torch.equal(x, y)
    assert cuda_small.alpha_phase_full.launches == 0


def test_alpha_phase_full_multi_row_mask_b_matches_pallas():
    active = np.array([1.0, 1.0, 0.0, 1.0])
    n_b = len(active)
    gtt, bt, gu, bu, usq, ydy, al, ap, dmax2, rt_sq = _glue(n_b, seed=3)
    mask = np.ones((n_b, N_CT + N_U))
    mask[0, -1] = mask[1, 1] = mask[2, 0] = 0.0
    mask[3, -2:] = 0.0
    a = np.linspace(1.5, 2.5, n_b)
    l_h_prev, steps = 1.1 * (rt_sq + usq) * dmax2, 7
    j = jnp.asarray
    al_w, ap_w, _, _, lw_w, cost_w = (np.asarray(x) for x in j_k5(
        j(gtt), j(bt), j(gu), j(bu), j(usq), j(ydy), j(al), j(ap), j(a),
        j(l_h_prev), rt_sq, dmax2, steps, N_U, row_mask_b=j(mask)))
    scal = np.zeros((n_b, N_SCAL_MULTI))
    scal[:, A_ALPHA], scal[:, L_H_PREV] = a, l_h_prev
    scal[:, RT_SQ], scal[:, DMAX2], scal[:, ACTIVE] = rt_sq, dmax2, active
    scal[:, COST] = 0.5 * np.sum(ydy)
    scal_t, alpha, alpha_prev = _t(scal), _t(al), _t(ap)
    cuda_small.alpha_phase_full_multi(_t(gtt), _t(bt), _t(gu), _t(bu),
                                      _t(usq), _t(ydy), alpha, alpha_prev,
                                      scal_t, steps, N_U,
                                      row_mask_b=_t(mask))
    act = active > 0
    np.testing.assert_allclose(alpha[act].numpy(), al_w[act], **TOL)
    np.testing.assert_allclose(alpha_prev[act].numpy(), ap_w[act], **TOL)
    np.testing.assert_array_equal(alpha[~act].numpy(), al[~act])
    for b in np.flatnonzero(act):
        np.testing.assert_array_equal(alpha[b].numpy()[mask[b] == 0], 0.0)
    np.testing.assert_allclose(scal_t[act, L_W].numpy(), lw_w[act],
                               rtol=1e-12)
    scale = float(np.sum(ydy))
    np.testing.assert_allclose(scal_t[act, COST].numpy() / scale,
                               cost_w[act] / scale, **TOL)
    assert cuda_small.alpha_phase_full_multi.launches == 0


def _padded(p, n_u, n_u_max, seed):
    """A lower-rank init (u, alpha) and its zero-padded form with the
    mask of its rows."""
    y, Rt = p["y"], p["R_trunc"]
    n_ct, n_s = Rt.shape[1], y.shape[1]
    rng = np.random.default_rng(seed)
    u_small = rng.uniform(size=(y.shape[0], n_u))
    a_small = rng.dirichlet(np.ones(n_ct + n_u), size=n_s).T
    u_pad = np.zeros((y.shape[0], n_u_max))
    u_pad[:, :n_u] = u_small
    a_pad = np.zeros((n_ct + n_u_max, n_s))
    a_pad[:n_ct + n_u] = a_small
    mask = np.arange(n_ct + n_u_max) < n_ct + n_u
    return u_small, a_small, u_pad, a_pad, mask


def test_partial_ref_solve_row_mask_matches_jax(small_problem):
    p = small_problem
    y, d, Rt = p["y"], p["d"], p["R_trunc"]
    n_ct = Rt.shape[1]
    _, _, u_pad, a_pad, mask = _padded(p, 1, 3, seed=21)
    kw = dict(n_iter1=10, n_iter2=6, tol=1e-9)
    j = jnp.asarray
    want_u, want_a, want_info = j_plain(j(u_pad), j(a_pad), j(y), j(d),
                                        j(Rt), 3, row_mask=j(mask), **kw)
    got_u, got_a, got_info = partial_ref_solve(
        _t(u_pad), _t(a_pad), _t(y), _t(d), _t(Rt), 3, row_mask=_t(mask),
        **kw)
    assert got_info["n_iter"] == int(want_info["n_iter"])
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u),
                               **SOLVE_TOL)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a),
                               **SOLVE_TOL)
    np.testing.assert_array_equal(got_u.numpy()[:, 1:], 0.0)
    np.testing.assert_array_equal(got_a.numpy()[n_ct + 1:], 0.0)


def test_fused_padded_solve_matches_jax_and_lower_rank(small_problem):
    """The padded masked fused solve (K1 every iteration, then K2 with the
    mask) against the JAX fused solve with the same mask, and against the
    port's own unpadded lower-rank solve."""
    p = small_problem
    y, d, Rt = p["y"], p["d"], p["R_trunc"]
    n_ct = Rt.shape[1]
    n_u, n_u_max = 1, 3
    u_small, a_small, u_pad, a_pad, mask = _padded(p, n_u, n_u_max,
                                                   seed=21)
    kw = dict(n_iter1=12, n_iter2=6, tol=1e-9, record_trace=True)
    j = jnp.asarray
    want_u, want_a, want_info = j_fused(j(u_pad), j(a_pad), j(y), j(d),
                                        j(Rt), n_u_max, row_mask=j(mask),
                                        **kw)
    got_u, got_a, got_info = fused.partial_ref_solve_fused(
        _t(u_pad), _t(a_pad), _t(y), _t(d), _t(Rt), n_u_max,
        row_mask=_t(mask), **kw)
    low_u, low_a, low_info = fused.partial_ref_solve_fused(
        _t(u_small), _t(a_small), _t(y), _t(d), _t(Rt), n_u, **kw)

    assert got_info["n_iter"] == int(want_info["n_iter"])
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u),
                               **SOLVE_TOL)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a),
                               **SOLVE_TOL)
    np.testing.assert_array_equal(got_u.numpy()[:, n_u:], 0.0)
    np.testing.assert_array_equal(got_a.numpy()[n_ct + n_u:], 0.0)
    assert got_info["n_iter"] == low_info["n_iter"]
    np.testing.assert_allclose(got_u.numpy()[:, :n_u], low_u.numpy(),
                               **SOLVE_TOL)
    np.testing.assert_allclose(got_a.numpy()[:n_ct + n_u], low_a.numpy(),
                               **SOLVE_TOL)
    np.testing.assert_allclose(got_info["trace"].numpy(),
                               low_info["trace"].numpy(), rtol=1e-10)


def test_alpha_phase_full_multi_row_mask_b_equals_masked_members():
    """K5's per-member masks are K2's mask, member by member: each
    member's masked K5 step equals masked K2 on that member's blocks."""
    n_b = 3
    gtt, bt, gu, bu, usq, ydy, al, ap, dmax2, rt_sq = _glue(n_b, seed=4)
    mask = np.ones((n_b, N_CT + N_U))
    mask[0, -2:] = mask[1, 2] = 0.0
    a = np.array([1.4, 2.0, 2.6])
    l_h_prev, steps = 1.1 * (rt_sq + usq) * dmax2, 6
    scal = np.zeros((n_b, N_SCAL_MULTI))
    scal[:, A_ALPHA], scal[:, L_H_PREV] = a, l_h_prev
    scal[:, RT_SQ], scal[:, DMAX2], scal[:, ACTIVE] = rt_sq, dmax2, 1.0
    scal_b, alpha_b, alpha_prev_b = _t(scal), _t(al), _t(ap)
    cuda_small.alpha_phase_full_multi(_t(gtt), _t(bt), _t(gu), _t(bu),
                                      _t(usq), _t(ydy), alpha_b, alpha_prev_b,
                                      scal_b, steps, N_U,
                                      row_mask_b=_t(mask))
    for b in range(n_b):
        sc = torch.zeros(N_SCAL, dtype=torch.float64)
        sc[A_ALPHA], sc[L_H_PREV], sc[RT_SQ], sc[DMAX2] = (
            a[b], l_h_prev[b], rt_sq, dmax2)
        alpha, alpha_prev = _t(al[b]), _t(ap[b])
        cuda_small.alpha_phase_full(_t(gtt), _t(bt), _t(gu[b]), _t(bu[b]),
                                    _t(usq[b]), _t(ydy), alpha, alpha_prev,
                                    sc, steps, N_U, _t(mask[b]))
        np.testing.assert_allclose(alpha_b[b].numpy(), alpha.numpy(), **TOL)
        np.testing.assert_allclose(alpha_prev_b[b].numpy(),
                                   alpha_prev.numpy(), **TOL)
        np.testing.assert_array_equal(alpha_b[b].numpy()[mask[b] == 0], 0.0)
        np.testing.assert_allclose(float(scal_b[b, L_W]), float(sc[L_W]),
                                   rtol=1e-12)
        np.testing.assert_allclose(float(scal_b[b, COST]), float(sc[COST]),
                                   rtol=1e-12)
