"""The port's multi-member kernel wrappers (K4 ``u_phase_grams_multi``, K5
``alpha_phase_full_multi``, K6 ``fw_phase_full_multi``) on CPU tensors,
where they run their plain PyTorch twins, against the JAX package's
wrappers of the same names (Pallas in interpret mode), in every form the
batched restarts run: n_u = 1 and n_u = 3, with and without a known
block, lagged, each with a mixed active mask.

Tolerances, as tests/test_torch_kernels.py: float64 atol 1e-10 (the two
sides sum the Gram blocks in different orders); float32 rtol 1e-5 with an
atol floor of 1e-5 for the O(1) quantities (u in [0, 1], alpha on the
simplex). The JAX kernels compute every member; the port leaves an
inactive member exactly as it was, so inactive members are held to their
inputs bit for bit. The CUDA kernels have no CPU mode; ``chip_smoke.py``
checks them against these same twins on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demethify_tpu.ops.gram import known_block_grams as j_known_grams
from demethify_tpu.ops.pallas_kernels import u_phase_grams_multi as j_k4
from demethify_tpu.ops.pallas_small import alpha_phase_full_multi as j_k5
from demethify_tpu.ops.pallas_small import fw_phase_full_multi as j_k6
from demethify_tpu_torch.ops import cuda_multi, cuda_small
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

TILE = 64
N, N_S, N_CT = 150, 6, 4          # 150 sites: a ragged last tile of 64
TOLS = {np.float64: dict(rtol=0, atol=1e-10),
        np.float32: dict(rtol=1e-5, atol=1e-5)}
ACTIVE_MASK = np.array([1.0, 0.0, 1.0, 1.0])
FORMS = [(1, True, False), (3, True, False), (1, False, True),
         (3, False, True)]
FORM_IDS = ["n_u1-known", "n_u3-known", "n_u1-none-lagged",
            "n_u3-none-lagged"]


def _t(x):
    return torch.tensor(np.ascontiguousarray(x))


def _members(n_u, n_ct, n_b, dtype, seed):
    """Shared data and B members' factors of a random problem (numpy)."""
    rng = np.random.default_rng(seed)
    p = n_ct + n_u
    R = rng.uniform(size=(N, p))
    alpha = rng.dirichlet(np.ones(p), size=N_S).T
    d = rng.poisson(50, size=(N, N_S)) + 1.0
    y = np.clip(R @ alpha + 0.01 * rng.normal(size=(N, N_S)), 0, 1)
    alpha_b = np.stack([rng.dirichlet(np.ones(p), size=N_S).T
                        for _ in range(n_b)])
    u_b = rng.uniform(size=(n_b, n_u, N))
    u_prev_b = np.clip(u_b + 0.05 * rng.normal(size=u_b.shape), 0, 1)
    cast = lambda x: np.asarray(x, dtype)           # noqa: E731
    return (cast(y), cast(d), cast(R[:, :n_ct]), cast(alpha_b), cast(u_b),
            cast(u_prev_b))


def _pad(x):
    target = -(-x.shape[-1] // TILE) * TILE
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, target - x.shape[-1])])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n_u,known,lagged", FORMS, ids=FORM_IDS)
def test_u_phase_grams_multi_matches_pallas(n_u, known, lagged, dtype):
    n_ct = N_CT if known else 0
    n_b = len(ACTIVE_MASK)
    y, d, Rt, alpha_b, u_b, up_b = _members(n_u, n_ct, n_b, dtype, seed=n_u)
    dmax2 = d.max() ** 2
    l_w = (np.sum(alpha_b[:, -n_u:] ** 2, axis=(1, 2)) * dmax2).astype(dtype)
    a = np.linspace(1.2, 2.4, n_b).astype(dtype)
    l_w_prev = (0.9 * l_w).astype(dtype)
    steps = 5
    j = jnp.asarray
    want = j_k4(j(_pad(y.T)), j(_pad(d.T)), j(_pad(Rt.T)) if known else None,
                j(alpha_b[:, :n_ct]) if known else None,
                j(alpha_b[:, n_ct:]), j(_pad(u_b)), j(_pad(up_b)), j(a),
                j(l_w), j(l_w_prev), steps,
                active=j(ACTIVE_MASK.astype(dtype)), lagged=lagged,
                tile=TILE)
    u_w, up_w, a_w, lwp_w, gu_w, bu_w, usq_w = (np.asarray(x) for x in want)

    scal_b = np.zeros((n_b, N_SCAL_MULTI), dtype)
    scal_b[:, A_U], scal_b[:, L_W], scal_b[:, L_W_PREV] = a, l_w, l_w_prev
    scal_b[:, ACTIVE] = ACTIVE_MASK
    uut_b = _t(np.concatenate([u_b, up_b], axis=1))
    uut_0, scal_t = uut_b.clone(), _t(scal_b)
    alpha_t = _t(alpha_b)
    gu, bu, usq = cuda_multi.u_phase_grams_multi(
        _t(np.concatenate([y.T, d.T])), _t(Rt.T) if known else None,
        alpha_t[:, :n_ct] if known else None, alpha_t[:, n_ct:], uut_b,
        scal_t, steps, lagged)

    tol = TOLS[dtype]
    act = ACTIVE_MASK > 0
    np.testing.assert_allclose(uut_b[:, :n_u].numpy(), u_w[:, :, :N], **tol)
    np.testing.assert_allclose(uut_b[:, n_u:].numpy(), up_w[:, :, :N], **tol)
    assert torch.equal(uut_b[~act], uut_0[~act])          # frozen members
    np.testing.assert_allclose(scal_t[:, A_U].numpy(), a_w, rtol=1e-6)
    np.testing.assert_allclose(scal_t[:, L_W_PREV].numpy(), lwp_w,
                               rtol=1e-6)
    assert torch.equal(scal_t[~act], _t(scal_b)[~act])
    scale = np.abs(gu_w).max(axis=(1, 2, 3))[:, None, None, None]
    np.testing.assert_allclose(gu.numpy() / scale, gu_w / scale, **tol)
    np.testing.assert_allclose(bu.numpy() / scale[..., 0], bu_w
                               / scale[..., 0], **tol)
    np.testing.assert_allclose(usq.numpy(), usq_w,
                               rtol=max(tol["rtol"], 1e-12))
    assert cuda_multi.u_phase_grams_multi.launches == 0


def _glue_inputs(n_u, n_ct, n_b, dtype, seed):
    """Shared known blocks and B members' new-u blocks (numpy)."""
    y, d, Rt, alpha_b, u_b, _ = _members(n_u, n_ct, n_b, np.float64, seed)
    gtt, bt, ydy = (np.asarray(x) for x in j_known_grams(
        jnp.asarray(Rt), jnp.asarray(d), jnp.asarray(y)))
    u = np.swapaxes(u_b, 1, 2)                         # (B, N, n_u)
    R_b = np.concatenate([np.broadcast_to(Rt, (n_b, N, n_ct)), u], axis=2)
    gu = np.einsum("is,biu,biq->bsuq", d, u, R_b)
    bu = np.einsum("biu,is->bus", u, d * y)
    usq = np.sum(u * u, axis=(1, 2))
    rng = np.random.default_rng(seed + 1)
    alpha_prev_b = np.stack([rng.dirichlet(np.ones(n_ct + n_u), size=N_S).T
                             for _ in range(n_b)])
    cast = lambda x: np.asarray(x, dtype)           # noqa: E731
    return (cast(gtt), cast(bt), cast(gu), cast(bu), cast(usq), cast(ydy),
            cast(alpha_b), cast(alpha_prev_b), dtype(d.max() ** 2),
            dtype(np.sum(Rt ** 2)))


def _scal_rows(dtype, slots, active=ACTIVE_MASK):
    """Scalar rows {slot: per-member value} with the given active flags."""
    s = np.zeros((len(active), N_SCAL_MULTI), dtype)
    for slot, value in slots.items():
        s[:, slot] = value
    s[:, ACTIVE] = active
    return s


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n_u,known", [(1, True), (3, False)],
                         ids=["p5-known", "p3-none"])
def test_alpha_phase_full_multi_matches_pallas(n_u, known, dtype):
    n_ct = N_CT if known else 0
    n_b = len(ACTIVE_MASK)
    (gtt, bt, gu, bu, usq, ydy, alpha_b, alpha_prev_b, dmax2,
     rt_sq) = _glue_inputs(n_u, n_ct, n_b, dtype, seed=3 + n_u)
    if not known:
        rt_sq = dtype(0.0)
    a = np.linspace(1.5, 2.5, n_b).astype(dtype)
    l_h_prev = (1.1 * (rt_sq + usq) * dmax2).astype(dtype)
    steps = 7
    j = jnp.asarray
    want = j_k5(j(gtt), j(bt), j(gu), j(bu), j(usq), j(ydy), j(alpha_b),
                j(alpha_prev_b), j(a), j(l_h_prev), rt_sq, dmax2, steps, n_u)
    al_w, ap_w, a_w, lhp_w, lw_w, cost_w = (np.asarray(x) for x in want)

    old_cost = np.full(n_b, 0.5 * float(np.sum(ydy)), dtype)
    scal0 = _scal_rows(dtype, {A_ALPHA: a, L_H_PREV: l_h_prev,
                               RT_SQ: rt_sq, DMAX2: dmax2, COST: old_cost,
                               TOL: 0.05 * float(np.sum(ydy))})
    scal = _t(scal0)
    alpha_t, alpha_prev_t = _t(alpha_b), _t(alpha_prev_b)
    cuda_small.alpha_phase_full_multi(_t(gtt), _t(bt), _t(gu), _t(bu),
                                      _t(usq), _t(ydy), alpha_t,
                                      alpha_prev_t, scal, steps, n_u)
    tol = TOLS[dtype]
    act = ACTIVE_MASK > 0
    np.testing.assert_allclose(alpha_t[act].numpy(), al_w[act], **tol)
    np.testing.assert_allclose(alpha_prev_t[act].numpy(), ap_w[act], **tol)
    np.testing.assert_array_equal(alpha_t[~act].numpy(), alpha_b[~act])
    np.testing.assert_array_equal(alpha_prev_t[~act].numpy(),
                                  alpha_prev_b[~act])
    np.testing.assert_array_equal(scal[~act].numpy(), scal0[~act])
    s = scal[act].numpy()
    np.testing.assert_allclose(s[:, A_ALPHA], a_w[act], rtol=1e-6)
    np.testing.assert_allclose(s[:, L_H_PREV], lhp_w[act], rtol=1e-6)
    np.testing.assert_allclose(s[:, L_W], lw_w[act], rtol=1e-5)
    scale = float(np.sum(ydy))
    np.testing.assert_allclose(s[:, COST] / scale, cost_w[act] / scale,
                               **tol)
    # the next iteration's flag: |new cost - old cost| >= tol, per member
    np.testing.assert_array_equal(
        s[:, ACTIVE], (np.abs(s[:, COST] - old_cost[act])
                       >= 0.05 * scale).astype(dtype))
    assert cuda_small.alpha_phase_full_multi.launches == 0


def _purity_alpha(alpha_b, purity, n_ct):
    k, u = alpha_b[:, :n_ct], alpha_b[:, n_ct:]
    return np.concatenate([k / k.sum(1, keepdims=True) * purity,
                           u / u.sum(1, keepdims=True) * (1 - purity)],
                          axis=1)


def _k6_both(gtt, bt, gu, bu, ydy, alpha_b, purity, dmax2, steps, n_u,
             active=ACTIVE_MASK):
    j = jnp.asarray
    want = j_k6(j(gtt), j(bt), j(gu), j(bu), j(ydy), j(alpha_b), j(purity),
                dmax2, steps, n_u)
    scal0 = _scal_rows(alpha_b.dtype, {DMAX2: dmax2}, active)
    scal, alpha_t = _t(scal0), _t(alpha_b)
    cuda_small.fw_phase_full_multi(_t(gtt), _t(bt), _t(gu), _t(bu), _t(ydy),
                                   alpha_t, _t(purity), scal, steps, n_u)
    return [np.asarray(x) for x in want], alpha_t, scal, scal0


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fw_phase_full_multi_matches_pallas(dtype):
    n_u, n_b = 1, len(ACTIVE_MASK)
    (gtt, bt, gu, bu, _, ydy, alpha_b, _, dmax2,
     _) = _glue_inputs(n_u, N_CT, n_b, dtype, seed=9)
    purity = np.random.default_rng(10).uniform(0.3, 0.9, N_S).astype(dtype)
    alpha_b = _purity_alpha(alpha_b, purity, N_CT).astype(dtype)
    (al_w, lw_w, cost_w), alpha_t, scal, scal0 = _k6_both(
        gtt, bt, gu, bu, ydy, alpha_b, purity, dmax2, 16, n_u)
    atol = 1e-12 if dtype == np.float64 else 1e-5
    act = ACTIVE_MASK > 0
    np.testing.assert_allclose(alpha_t[act].numpy(), al_w[act], rtol=0,
                               atol=atol)
    np.testing.assert_array_equal(alpha_t[~act].numpy(), alpha_b[~act])
    np.testing.assert_array_equal(scal[~act].numpy(), scal0[~act])
    s = scal[act].numpy()
    np.testing.assert_allclose(s[:, L_W], lw_w[act], rtol=100 * atol)
    scale = float(np.sum(ydy))
    np.testing.assert_allclose(s[:, COST] / scale, cost_w[act] / scale,
                               rtol=0, atol=atol)
    np.testing.assert_allclose(alpha_t[act][:, :N_CT].sum(1).numpy(),
                               np.broadcast_to(purity, (act.sum(), N_S)),
                               atol=10 * atol)
    assert cuda_small.fw_phase_full_multi.launches == 0


def test_fw_multi_exact_ties_take_the_first_row():
    """G = 0 and tied entries of b, different per member: the gradient -b
    ties exactly, every step picks the same vertex, and it is the first
    row of each tie, in each member, as in the JAX kernel."""
    n_s, n_ct, n_u = 3, 4, 3
    gtt = np.zeros((n_s, n_ct, n_ct))
    gu = np.zeros((2, n_s, n_u, n_ct + n_u))
    bt = np.array([[1.0, 2.0, 5.0], [3.0, 2.0, 5.0], [3.0, 1.0, 5.0],
                   [2.0, 2.0, 5.0]])                 # ties in rows 1/2, 0/1/3
    bu = np.array([[[1.0, 4.0, 2.0], [1.0, 4.0, 2.0], [0.5, 4.0, 1.0]],
                   [[0.0, 4.0, 2.0], [1.0, 3.0, 2.0], [1.0, 4.0, 2.0]]])
    ydy = np.full(n_s, 10.0)
    purity = np.array([0.6, 0.7, 0.8])
    alpha = np.vstack([np.full((n_ct, n_s), 0.25) * purity,
                       np.full((n_u, n_s), 1 / 3) * (1 - purity)])
    alpha_b = np.stack([alpha, alpha])
    (al_w, _, _), alpha_t, _, _ = _k6_both(gtt, bt, gu, bu, ydy, alpha_b,
                                           purity, 1.0, 7, n_u,
                                           active=np.ones(2))
    want = np.zeros_like(alpha_b)
    for b, rows in enumerate([[(1, 0), (0, 0), (0, 0)],
                              [(1, 1), (0, 0), (0, 0)]]):
        for s, (k1, k2) in enumerate(rows):
            want[b, k1, s] = purity[s]
            want[b, n_ct + k2, s] = 1 - purity[s]
    # (1 - gamma) s + gamma s rounds in the last bit
    np.testing.assert_allclose(alpha_t.numpy(), want, rtol=0, atol=1e-15)
    np.testing.assert_allclose(al_w, want, rtol=0, atol=1e-15)


@pytest.mark.parametrize("bad", ["weights", "row_mask_b", "direct", "n_u9",
                                 "members"])
def test_multi_wrappers_reject(bad):
    n_b, n_s = 2, 2 if bad == "direct" else N_S
    n_u = {"direct": 3, "n_u9": 9}.get(bad, 1)
    dt = torch.float64
    ydt = torch.zeros((2 * n_s, 8), dtype=dt)
    a2 = torch.zeros((n_b, n_u, n_s), dtype=dt)
    uut = torch.zeros((n_b, 2 * n_u, 8), dtype=dt)
    scal = torch.zeros((n_b + (bad == "members"), N_SCAL_MULTI), dtype=dt)
    if bad == "row_mask_b":
        p = N_CT + 1
        args = [torch.zeros(s, dtype=dt) for s in (
            (n_s, N_CT, N_CT), (N_CT, n_s), (n_b, n_s, 1, p), (n_b, 1, n_s),
            (n_b,), (n_s,), (n_b, p, n_s), (n_b, p, n_s))]
        with pytest.raises(NotImplementedError, match="item 10"):
            cuda_small.alpha_phase_full_multi(*args, scal, 3, 1,
                                              row_mask_b=torch.ones(n_b, p))
        return
    # weights: a row per member and site, in the operands' dtype
    expected, match = {"weights": (ValueError, "weights"),
                       "n_u9": (NotImplementedError, "item 12"),
                       "direct": (ValueError, "gram form only")}.get(
        bad, (ValueError, None))
    with pytest.raises(expected, match=match):
        cuda_multi.u_phase_grams_multi(
            ydt, None, None, a2, uut, scal, 3, lagged=True,
            weights=torch.ones(n_b, 7, dtype=dt) if bad == "weights"
            else None)
