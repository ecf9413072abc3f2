"""The weighted bootstrap's pieces of the port on the CPU, against the JAX
package: the row-weight forms of the Gram and cost helpers, the plain
solvers with ``row_weights``, the 'uniform' init's weighted WLS, the K4
twin with its weights operand, the K5/K6 twins with per-member known
blocks, and the three multi solvers with ``row_weights_b``.

Inputs come from a numpy seed; row weights are resample multiplicities
(a bincount of draws, in {0, 1, 2, 3, ...}), some with the max-coverage row
dropped. Tolerances: float64 atol 1e-10 for the helpers and the kernel
twins (the two sides sum in different orders), 1e-8 for solver state and
rtol 1e-9 for solver costs (the JAX package's own TestWeightedFusedMulti
bounds); float32 as tests/test_torch_multi.py. The CUDA kernels have no CPU
mode; ``chip_smoke.py`` checks them against these same twins on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demethify_tpu.ops import cost as j_cost
from demethify_tpu.ops import gram as j_gram
from demethify_tpu.ops.nnls import wls_intercept_batch as j_wls
from demethify_tpu.ops.pallas_kernels import u_phase_grams_multi as j_k4
from demethify_tpu.ops.pallas_small import alpha_phase_full_multi as j_k5
from demethify_tpu.ops.pallas_small import fw_phase_full_multi as j_k6
from demethify_tpu.solvers.fused import (
    partial_ref_solve_fused_multi as j_partial_multi,
)
from demethify_tpu.solvers.fused import (
    purity_solve_fused_multi as j_purity_multi,
)
from demethify_tpu.solvers.partial_ref import partial_ref_solve as j_partial
from demethify_tpu.solvers.purity import purity_solve as j_purity
from demethify_tpu.solvers.unsupervised import unsupervised_solve as j_unsup
from demethify_tpu_torch.ops import cost, cuda_multi, cuda_small, gram
from demethify_tpu_torch.ops.cuda_kernels import (
    A_ALPHA,
    A_U,
    ACTIVE,
    COST,
    DMAX2,
    L_H_PREV,
    L_W,
    L_W_PREV,
    N_SCAL_MULTI,
    RT_SQ,
    TOL,
)
from demethify_tpu_torch.solvers import fused
from demethify_tpu_torch.solvers.init import init_partial, init_purity
from demethify_tpu_torch.solvers.partial_ref import partial_ref_solve
from demethify_tpu_torch.solvers.purity import purity_solve
from demethify_tpu_torch.solvers.unsupervised import unsupervised_solve

TORCH_DT = {np.float64: torch.float64, np.float32: torch.float32}
TILE = 64
ACTIVE_MASK = np.array([1.0, 0.0, 1.0, 1.0])
KERNEL_TOLS = {np.float64: dict(rtol=0, atol=1e-10),
               np.float32: dict(rtol=1e-5, atol=1e-5)}
SOLVER_TOLS = {np.float64: dict(state=1e-8, cost=1e-9, ydy_floor=0.0),
               np.float32: dict(state=1e-4, cost=1e-5, ydy_floor=1e-6)}


def _t(x, dtype=None):
    t = torch.tensor(np.ascontiguousarray(x))
    return t if dtype is None else t.to(dtype)


def _weights(rng, n, drop=None):
    """Resample multiplicities of n rows; ``drop`` forces one row out."""
    idx = rng.integers(0, n, size=n)
    if drop is not None:
        idx = np.where(idx == drop, (drop + 1) % n, idx)
    return np.bincount(idx, minlength=n).astype(np.float64)


def _weights_b(rng, n_b, n, d=None):
    """B members' multiplicities; member 0 drops the max-coverage row."""
    drop = None if d is None else int(np.argmax(d.max(axis=1)))
    return np.stack([_weights(rng, n, drop if b == 0 else None)
                     for b in range(n_b)])


# ----------------------------------------------------------------- helpers
@pytest.mark.parametrize("what", ["sample_grams", "known_block_grams",
                                  "incremental", "cost"])
def test_weighted_helpers_match_jax(small_problem, what):
    p = small_problem
    y, d, Rt = p["y"], p["d"], p["R_trunc"]
    rng = np.random.default_rng(1)
    w = _weights(rng, y.shape[0])
    u = rng.uniform(size=(y.shape[0], p["n_u"]))
    R = np.hstack([Rt, u])
    j = jnp.asarray
    if what == "sample_grams":
        want = j_gram.sample_grams(j(R), j(d), j(y), row_weights=j(w))
        got = gram.sample_grams(_t(R), _t(d), _t(y), _t(w))
    elif what == "known_block_grams":
        want = j_gram.known_block_grams(j(Rt), j(d), j(y), row_weights=j(w))
        got = gram.known_block_grams(_t(Rt), _t(d), _t(y), _t(w))
    elif what == "incremental":
        G_tt, b_t, _ = j_gram.known_block_grams(j(Rt), j(d), j(y),
                                                row_weights=j(w))
        want = j_gram.sample_grams_incremental(G_tt, b_t, j(Rt), j(u), j(d),
                                               j(y), row_weights=j(w))
        got = gram.sample_grams_incremental(
            _t(np.asarray(G_tt)), _t(np.asarray(b_t)), _t(Rt), _t(u), _t(d),
            _t(y), _t(w))
    else:
        alpha = p["alpha"]
        want = [j_cost.weighted_cost(j(y), j(R), j(alpha), j(d),
                                     row_weights=j(w))]
        got = [cost.weighted_cost(_t(y), _t(R), _t(alpha), _t(d), _t(w))]
    for g, wv in zip(got, want):
        scale = max(1.0, float(np.abs(np.asarray(wv)).max()))
        np.testing.assert_allclose(g.numpy() / scale, np.asarray(wv) / scale,
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("n_ct", [4, 0])
def test_weighted_known_grams_per_member(small_problem, n_ct):
    """The batched helper equals the JAX known blocks member by member."""
    p = small_problem
    y, d = p["y"], p["d"]
    Rt = p["R_trunc"][:, :n_ct]
    w_b = _weights_b(np.random.default_rng(2), 5, y.shape[0], d)
    G, b, ydy = gram.weighted_known_grams(_t(Rt), _t(d), _t(y), _t(w_b))
    assert G.shape == (5, y.shape[1], n_ct, n_ct)
    for m in range(5):
        want = j_gram.known_block_grams(jnp.asarray(Rt), jnp.asarray(d),
                                        jnp.asarray(y),
                                        row_weights=jnp.asarray(w_b[m]))
        for g, wv in zip((G[m], b[m], ydy[m]), want):
            scale = max(1.0, float(np.abs(np.asarray(wv)).max(initial=0)))
            np.testing.assert_allclose(g.numpy() / scale,
                                       np.asarray(wv) / scale, rtol=0,
                                       atol=1e-12)


def test_coverage_max2_drops_unsampled_rows(small_problem):
    d = small_problem["d"]
    top = int(np.argmax(d.max(axis=1)))
    w = np.ones(d.shape[0])
    w[top] = 0.0
    got = float(gram.coverage_max2(_t(d), _t(w), torch.float64))
    want = np.max(np.delete(d, top, axis=0)) ** 2
    assert got == want < d.max() ** 2
    assert float(gram.coverage_max2(_t(d), None, torch.float64)) == \
        d.max() ** 2


# ------------------------------------------------------ the plain solvers
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("mode", ["partial", "purity", "unsupervised"])
def test_plain_weighted_solvers_match_jax(small_problem, mode, dtype):
    p = small_problem
    y, d, Rt, n_u = p["y"], p["d"], p["R_trunc"], p["n_u"]
    rng = np.random.default_rng(3)
    w = _weights_b(rng, 1, y.shape[0], d)[0]
    u0 = rng.uniform(size=(y.shape[0], n_u))
    kw = dict(n_iter1=12, n_iter2=6, tol=1e-9, record_trace=True)
    j = lambda x: jnp.asarray(x, dtype)               # noqa: E731
    T = lambda x: _t(x, TORCH_DT[dtype])              # noqa: E731
    if mode == "unsupervised":
        a0 = rng.dirichlet(np.ones(n_u), size=y.shape[1]).T
        want = j_unsup(j(u0), j(a0), j(y), j(d), n_u, row_weights=j(w), **kw)
        got = unsupervised_solve(T(u0), T(a0), T(y), T(d), n_u,
                                 row_weights=T(w), **kw)
    elif mode == "purity":
        purity = rng.uniform(0.3, 0.7, size=y.shape[1])
        a0 = rng.dirichlet(np.ones(Rt.shape[1] + n_u), size=y.shape[1]).T
        kw.update(n_iter1=6, n_iter2=12)
        want = j_purity(j(u0), j(a0), j(y), j(d), j(Rt), j(purity), n_u,
                        row_weights=j(w), **kw)
        got = purity_solve(T(u0), T(a0), T(y), T(d), T(Rt), T(purity), n_u,
                           row_weights=T(w), **kw)
    else:
        a0 = rng.dirichlet(np.ones(Rt.shape[1] + n_u), size=y.shape[1]).T
        want = j_partial(j(u0), j(a0), j(y), j(d), j(Rt), n_u,
                         row_weights=j(w), **kw)
        got = partial_ref_solve(T(u0), T(a0), T(y), T(d), T(Rt), n_u,
                                row_weights=T(w), **kw)
    tol = SOLVER_TOLS[dtype]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=tol["state"])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=tol["state"])
    assert got[2]["n_iter"] == int(want[2]["n_iter"])
    np.testing.assert_allclose(
        got[2]["trace"].numpy(), np.asarray(want[2]["trace"]),
        rtol=tol["cost"],
        atol=tol["ydy_floor"] * float(np.sum(w[:, None] * d * y ** 2)))


@pytest.mark.parametrize("init_fn", [init_partial, init_purity],
                         ids=["partial", "purity"])
def test_uniform_init_takes_the_weighted_wls(small_problem, init_fn):
    """'uniform' with row weights: the WLS on (y, w d, [Rt | u]) of the
    drawn u, as the JAX init computes it."""
    p = small_problem
    y, d, Rt, n_u = p["y"], p["d"], p["R_trunc"], p["n_u"]
    w = _weights(np.random.default_rng(4), y.shape[0])
    g = torch.Generator().manual_seed(6)
    u, alpha = init_fn(g, "uniform", _t(y), _t(d), _t(Rt), n_u, _t(w))
    want = np.array(j_wls(jnp.asarray(y), jnp.asarray(d * w[:, None]),
                          jnp.asarray(np.hstack([Rt, u.numpy()]))))
    if init_fn is init_partial and np.any(want[-n_u] == 0.0):
        want[-n_u] = 1e-10                    # the zero-guard, as both have
        want[:-n_u] *= 1 - 1e-10
    np.testing.assert_allclose(alpha.numpy(), want, rtol=0, atol=1e-9)


# -------------------------------------------------------------- K4 twin
def _pad(x):
    target = -(-x.shape[-1] // TILE) * TILE
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, target - x.shape[-1])])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n_u,known,lagged", [(1, True, False),
                                              (3, True, False),
                                              (1, False, True),
                                              (3, False, True)],
                         ids=["n_u1-known", "n_u3-known", "n_u1-none-lagged",
                              "n_u3-none-lagged"])
def test_u_phase_grams_multi_weights_match_pallas(n_u, known, lagged, dtype):
    rng = np.random.default_rng(10 + n_u)
    n, n_s, n_b = 150, 6, len(ACTIVE_MASK)
    n_ct = 4 if known else 0
    pp = n_ct + n_u
    R = rng.uniform(size=(n, pp))
    alpha = rng.dirichlet(np.ones(pp), size=n_s).T
    d = rng.poisson(50, size=(n, n_s)) + 1.0
    y = np.clip(R @ alpha + 0.01 * rng.normal(size=(n, n_s)), 0, 1)
    alpha_b = np.stack([rng.dirichlet(np.ones(pp), size=n_s).T
                        for _ in range(n_b)])
    u_b = rng.uniform(size=(n_b, n_u, n))
    up_b = np.clip(u_b + 0.05 * rng.normal(size=u_b.shape), 0, 1)
    w = rng.integers(0, 4, size=(n_b, n)).astype(np.float64)   # {0..3}
    y, d, R, alpha_b, u_b, up_b, w = (np.asarray(x, dtype) for x in
                                      (y, d, R, alpha_b, u_b, up_b, w))
    Rt = R[:, :n_ct]
    l_w = (np.sum(alpha_b[:, -n_u:] ** 2, axis=(1, 2))
           * d.max() ** 2).astype(dtype)
    a = np.linspace(1.2, 2.4, n_b).astype(dtype)
    j = jnp.asarray
    want = j_k4(j(_pad(y.T)), j(_pad(d.T)), j(_pad(Rt.T)) if known else None,
                j(alpha_b[:, :n_ct]) if known else None,
                j(alpha_b[:, n_ct:]), j(_pad(u_b)), j(_pad(up_b)), j(a),
                j(l_w), j((0.9 * l_w).astype(dtype)), 5,
                active=j(ACTIVE_MASK.astype(dtype)), lagged=lagged,
                weights=j(_pad(w)), tile=TILE)
    u_w, up_w, _, _, gu_w, bu_w, usq_w = (np.asarray(x) for x in want)

    scal_b = np.zeros((n_b, N_SCAL_MULTI), dtype)
    scal_b[:, A_U], scal_b[:, L_W] = a, l_w
    scal_b[:, L_W_PREV], scal_b[:, ACTIVE] = 0.9 * l_w, ACTIVE_MASK
    uut_b = _t(np.concatenate([u_b, up_b], axis=1))
    alpha_t = _t(alpha_b)
    gu, bu, usq = cuda_multi.u_phase_grams_multi(
        _t(np.concatenate([y.T, d.T])), _t(Rt.T) if known else None,
        alpha_t[:, :n_ct] if known else None, alpha_t[:, n_ct:], uut_b,
        _t(scal_b), 5, lagged, weights=_t(w))
    tol = KERNEL_TOLS[dtype]
    act = ACTIVE_MASK > 0
    np.testing.assert_allclose(uut_b[:, :n_u].numpy(), u_w[:, :, :n], **tol)
    scale = np.abs(gu_w).max(axis=(1, 2, 3))[:, None, None, None]
    np.testing.assert_allclose(gu.numpy()[act] / scale[act],
                               gu_w[act] / scale[act], **tol)
    np.testing.assert_allclose(bu.numpy()[act] / scale[act, ..., 0],
                               bu_w[act] / scale[act, ..., 0], **tol)
    np.testing.assert_allclose(usq.numpy()[act], usq_w[act],
                               rtol=max(tol["rtol"], 1e-12))
    assert cuda_multi.u_phase_grams_multi.launches == 0


def test_u_phase_grams_multi_weights_fold_once():
    """w in {0, 1, 2, 3} multiplies each Gram sum exactly once: gu equals
    sum_i w_i d_is u_iv [Rt | u]_iq, and all-ones weights give the
    unweighted twin bit for bit."""
    rng = np.random.default_rng(12)
    n, n_s, n_ct, n_u, n_b = 40, 3, 2, 2, 2
    ydt = _t(rng.uniform(size=(2 * n_s, n)) + 0.5)
    rtt = _t(rng.uniform(size=(n_ct, n)))
    alpha = _t(rng.dirichlet(np.ones(n_ct + n_u), size=(n_b, n_s))
               .transpose(0, 2, 1))
    uut = _t(rng.uniform(size=(n_b, 2 * n_u, n)))
    scal = torch.zeros((n_b, N_SCAL_MULTI), dtype=torch.float64)
    scal[:, A_U], scal[:, L_W], scal[:, L_W_PREV] = 1.0, 50.0, 50.0
    scal[:, ACTIVE] = 1.0
    w = _t(rng.integers(0, 4, size=(n_b, n)).astype(np.float64))
    args = (ydt, rtt, alpha[:, :n_ct], alpha[:, n_ct:])
    u1 = uut.clone()
    gu, bu, usq = cuda_multi.u_phase_grams_multi_plain(*args, u1, scal.clone(),
                                                       0, weights=w)
    u = u1[:, :n_u].numpy()
    rext = np.concatenate([np.broadcast_to(rtt.numpy(), (n_b, n_ct, n)), u],
                          axis=1)
    want = np.einsum("bi,si,bvi,bqi->bsvq", w.numpy(), ydt[n_s:].numpy(), u,
                     rext)
    np.testing.assert_allclose(gu.numpy(), want, rtol=1e-13)
    np.testing.assert_allclose(usq.numpy(),
                               np.einsum("bi,bvi->b", w.numpy(), u * u),
                               rtol=1e-13)
    ones = cuda_multi.u_phase_grams_multi_plain(
        *args, uut.clone(), scal.clone(), 3, weights=torch.ones_like(w))
    plain = cuda_multi.u_phase_grams_multi_plain(*args, uut.clone(),
                                                 scal.clone(), 3)
    assert all(torch.equal(a, b) for a, b in zip(ones, plain))


# ------------------------------------------------------------ K5/K6 twins
def _member_blocks(n_u, n_ct, n_b, seed):
    """Per-member weighted known blocks and K4-twin blocks (numpy)."""
    rng = np.random.default_rng(seed)
    n, n_s = 150, 6
    pp = n_ct + n_u
    R = rng.uniform(size=(n, pp))
    alpha = rng.dirichlet(np.ones(pp), size=n_s).T
    d = rng.poisson(50, size=(n, n_s)) + 1.0
    y = np.clip(R @ alpha + 0.01 * rng.normal(size=(n, n_s)), 0, 1)
    Rt = R[:, :n_ct]
    w_b = _weights_b(rng, n_b, n, d)
    gtt, bt, ydy = (x.numpy() for x in gram.weighted_known_grams(
        _t(Rt), _t(d), _t(y), _t(w_b)))
    u = rng.uniform(size=(n_b, n, n_u))
    R_b = np.concatenate([np.broadcast_to(Rt, (n_b, n, n_ct)), u], axis=2)
    gu = np.einsum("bi,is,biu,biq->bsuq", w_b, d, u, R_b)
    bu = np.einsum("bi,biu,is->bus", w_b, u, d * y)
    usq = np.einsum("bi,biu->b", w_b, u * u)
    rowmax = d.max(axis=1)
    dmax2 = np.max(np.where(w_b > 0, rowmax, 0.0), axis=1) ** 2
    rt_sq = w_b @ np.sum(Rt ** 2, axis=1)
    alpha_b = np.stack([rng.dirichlet(np.ones(pp), size=n_s).T
                        for _ in range(n_b)])
    alpha_prev_b = np.stack([rng.dirichlet(np.ones(pp), size=n_s).T
                             for _ in range(n_b)])
    return (gtt, bt, gu, bu, usq, ydy, alpha_b, alpha_prev_b, dmax2, rt_sq)


def _scal_rows(dtype, slots, active=ACTIVE_MASK):
    s = np.zeros((len(active), N_SCAL_MULTI), dtype)
    for slot, value in slots.items():
        s[:, slot] = value
    s[:, ACTIVE] = active
    return s


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n_u,n_ct", [(1, 4), (3, 0)],
                         ids=["p5-known", "p3-none"])
def test_alpha_phase_full_multi_member_blocks_match_pallas(n_u, n_ct, dtype):
    n_b = len(ACTIVE_MASK)
    blocks = _member_blocks(n_u, n_ct, n_b, seed=20 + n_u)
    (gtt, bt, gu, bu, usq, ydy, alpha_b, alpha_prev_b, dmax2,
     rt_sq) = (np.asarray(x, dtype) for x in blocks)
    a = np.linspace(1.5, 2.5, n_b).astype(dtype)
    l_h_prev = (1.1 * (rt_sq + usq) * dmax2).astype(dtype)
    j = jnp.asarray
    want = j_k5(j(gtt), j(bt), j(gu), j(bu), j(usq), j(ydy), j(alpha_b),
                j(alpha_prev_b), j(a), j(l_h_prev), j(rt_sq), j(dmax2), 7,
                n_u)
    al_w, ap_w, _, _, lw_w, cost_w = (np.asarray(x) for x in want)
    scal0 = _scal_rows(dtype, {A_ALPHA: a, L_H_PREV: l_h_prev, RT_SQ: rt_sq,
                               DMAX2: dmax2, COST: 0.0, TOL: 0.0})
    scal, alpha_t, alpha_prev_t = _t(scal0), _t(alpha_b), _t(alpha_prev_b)
    cuda_small.alpha_phase_full_multi(_t(gtt), _t(bt), _t(gu), _t(bu),
                                      _t(usq), _t(ydy), alpha_t,
                                      alpha_prev_t, scal, 7, n_u)
    tol = KERNEL_TOLS[dtype]
    act = ACTIVE_MASK > 0
    np.testing.assert_allclose(alpha_t[act].numpy(), al_w[act], **tol)
    np.testing.assert_allclose(alpha_prev_t[act].numpy(), ap_w[act], **tol)
    np.testing.assert_array_equal(alpha_t[~act].numpy(), alpha_b[~act])
    np.testing.assert_array_equal(scal[~act].numpy(), scal0[~act])
    s = scal[act].numpy()
    np.testing.assert_allclose(s[:, L_W], lw_w[act], rtol=1e-5)
    scale = ydy.sum(axis=1)[act]
    np.testing.assert_allclose(s[:, COST] / scale, cost_w[act] / scale, **tol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fw_phase_full_multi_member_blocks_match_pallas(dtype):
    n_u, n_ct, n_b = 1, 4, len(ACTIVE_MASK)
    blocks = _member_blocks(n_u, n_ct, n_b, seed=30)
    (gtt, bt, gu, bu, _, ydy, alpha_b, _, dmax2,
     _) = (np.asarray(x, dtype) for x in blocks)
    purity = np.random.default_rng(31).uniform(0.3, 0.9, 6).astype(dtype)
    k, u = alpha_b[:, :n_ct], alpha_b[:, n_ct:]
    alpha_b = np.concatenate([k / k.sum(1, keepdims=True) * purity,
                              u / u.sum(1, keepdims=True) * (1 - purity)],
                             axis=1).astype(dtype)
    j = jnp.asarray
    al_w, lw_w, cost_w = (np.asarray(x) for x in j_k6(
        j(gtt), j(bt), j(gu), j(bu), j(ydy), j(alpha_b), j(purity),
        j(dmax2), 16, n_u))
    scal0 = _scal_rows(dtype, {DMAX2: dmax2})
    scal, alpha_t = _t(scal0), _t(alpha_b)
    cuda_small.fw_phase_full_multi(_t(gtt), _t(bt), _t(gu), _t(bu), _t(ydy),
                                   alpha_t, _t(purity), scal, 16, n_u)
    atol = 1e-12 if dtype == np.float64 else 1e-5
    act = ACTIVE_MASK > 0
    np.testing.assert_allclose(alpha_t[act].numpy(), al_w[act], rtol=0,
                               atol=atol)
    np.testing.assert_array_equal(alpha_t[~act].numpy(), alpha_b[~act])
    s = scal[act].numpy()
    np.testing.assert_allclose(s[:, L_W], lw_w[act], rtol=100 * atol)
    scale = ydy.sum(axis=1)[act]
    np.testing.assert_allclose(s[:, COST] / scale, cost_w[act] / scale,
                               rtol=0, atol=atol)


@pytest.mark.parametrize("kernel", ["alpha", "fw"])
def test_shared_blocks_equal_their_per_member_copies(kernel):
    """Shared known blocks (stride 0) and per-member copies of the same
    blocks give the same result bit for bit."""
    n_u, n_ct, n_b = 1, 4, len(ACTIVE_MASK)
    (gtt, bt, gu, bu, usq, ydy, alpha_b, alpha_prev_b, dmax2,
     rt_sq) = _member_blocks(n_u, n_ct, n_b, seed=40)
    shared = (gtt[0], bt[0], ydy[0])
    copies = tuple(np.broadcast_to(x, (n_b,) + x.shape) for x in shared)
    outs = []
    for g, b_, y_ in (shared, copies):
        scal = _t(_scal_rows(np.float64, {A_ALPHA: 1.5, L_H_PREV: 1e5,
                                          RT_SQ: rt_sq, DMAX2: dmax2}))
        a = _t(alpha_b)
        if kernel == "alpha":
            ap = _t(alpha_prev_b)
            cuda_small.alpha_phase_full_multi(_t(g), _t(b_), _t(gu), _t(bu),
                                              _t(usq), _t(y_), a, ap, scal,
                                              5, n_u)
        else:
            cuda_small.fw_phase_full_multi(_t(g), _t(b_), _t(gu), _t(bu),
                                           _t(y_), a, _t(np.full(6, 0.6)),
                                           scal, 9, n_u)
        outs.append((a, scal))
    assert all(torch.equal(x, y) for x, y in zip(*outs))


# --------------------------------------------------------- multi solvers
def _multi_case(p, mode, n_b, seed):
    rng = np.random.default_rng(seed)
    y, d, Rt, n_u = p["y"], p["d"], p["R_trunc"], p["n_u"]
    n, n_s = y.shape
    n_ct = 0 if mode == "unsupervised" else Rt.shape[1]
    u_b = rng.uniform(size=(n_b, n, n_u))
    a_b = np.stack([rng.dirichlet(np.ones(n_ct + n_u), size=n_s).T
                    for _ in range(n_b)])
    w_b = _weights_b(rng, n_b, n, d)
    purity = None
    if mode == "purity":
        purity = rng.uniform(0.3, 0.7, size=n_s)
        a_b[:, :n_ct] *= purity / a_b[:, :n_ct].sum(1, keepdims=True)
        a_b[:, n_ct:] *= (1 - purity) / a_b[:, n_ct:].sum(1, keepdims=True)
    return u_b, a_b, w_b, purity


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("mode", ["partial", "purity", "unsupervised"])
def test_weighted_multi_solvers_match_jax(small_problem, mode, dtype):
    p = small_problem
    y, d, Rt, n_u = p["y"], p["d"], p["R_trunc"], p["n_u"]
    u_b, a_b, w_b, purity = _multi_case(p, mode, 3, seed=50)
    kw = dict(n_iter1=10, n_iter2=6, tol=1e-9, record_trace=True)
    j = lambda x: jnp.asarray(x, dtype)               # noqa: E731
    T = lambda x: _t(x, TORCH_DT[dtype])              # noqa: E731
    if mode == "partial":
        want = j_partial_multi(j(u_b), j(a_b), j(y), j(d), j(Rt), n_u,
                               row_weights_b=j(w_b), **kw)
        got = fused.partial_ref_solve_fused_multi(
            T(u_b), T(a_b), T(y), T(d), T(Rt), n_u, row_weights_b=T(w_b),
            **kw)
    elif mode == "purity":
        kw.update(n_iter1=6, n_iter2=10)
        want = j_purity_multi(j(u_b), j(a_b), j(y), j(d), j(Rt), j(purity),
                              n_u, row_weights_b=j(w_b), **kw)
        got = fused.purity_solve_fused_multi(
            T(u_b), T(a_b), T(y), T(d), T(Rt), T(purity), n_u,
            row_weights_b=T(w_b), **kw)
    else:
        # the JAX package has no weighted multi unsupervised solver: its
        # weighted bootstrap vmaps the XLA solver
        want = jax.vmap(lambda u0, a0, w: j_unsup(
            u0, a0, j(y), j(d), n_u, row_weights=w, **kw))(
            j(u_b), j(a_b), j(w_b))
        got = fused.unsupervised_solve_fused_multi(
            T(u_b), T(a_b), T(y), T(d), n_u, row_weights_b=T(w_b), **kw)
    tol = SOLVER_TOLS[dtype]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=tol["state"])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=tol["state"])
    np.testing.assert_array_equal(got[2]["n_iter"].numpy(),
                                  np.asarray(want[2]["n_iter"]))
    floor = tol["ydy_floor"] * float(np.sum(d * y ** 2)) * w_b.max()
    np.testing.assert_allclose(got[2]["cost"].numpy(),
                               np.asarray(want[2]["cost"]),
                               rtol=tol["cost"], atol=floor)
    np.testing.assert_allclose(got[2]["trace"].numpy(),
                               np.asarray(want[2]["trace"]),
                               rtol=tol["cost"], atol=floor)


def test_weighted_multi_member_cap(small_problem):
    """The weight row joins the per-member bytes of the cap."""
    n_cpg, n_s, n_ct, n_u = 1_000_000, 10, 5, 1
    free = 79 * 10 ** 9
    plain = fused.max_multi_members(n_cpg, n_s, n_ct, n_u, 4, 4, free)
    weighted = fused.max_multi_members(n_cpg, n_s, n_ct, n_u, 4, 4, free,
                                       weighted=True)
    # 18.2 MB a member, 4 MB more with the weight row
    assert plain == 2162 and weighted == 1773


def test_row_weights_b_shape_is_checked(small_problem):
    p = small_problem
    u_b, a_b, w_b, _ = _multi_case(p, "partial", 2, seed=51)
    with pytest.raises(ValueError, match="row_weights_b"):
        fused.partial_ref_solve_fused_multi(
            _t(u_b), _t(a_b), _t(p["y"]), _t(p["d"]), _t(p["R_trunc"]),
            p["n_u"], row_weights_b=_t(w_b[:, :-1]), n_iter1=2)
