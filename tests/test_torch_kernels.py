"""The port's kernel wrappers (K1 ``u_phase_grams``, K2
``alpha_phase_full``) on CPU tensors, where they run their plain PyTorch
twins, against the JAX package's Pallas wrappers in interpret mode.

Tolerances: float64 atol 1e-10 (the two sides sum the Gram blocks in
different orders); float32 rtol 1e-5 with an atol floor of 1e-5 for the
O(1) quantities (u in [0, 1], alpha on the simplex).

The CUDA kernels themselves have no CPU mode; ``chip_smoke.py`` checks
them against these same twins on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demethify_tpu.ops.pallas_kernels import u_phase_grams_packed
from demethify_tpu.ops.pallas_small import alpha_phase_full as j_alpha_full
from demethify_tpu_torch.device import resolve_device
from demethify_tpu_torch.ops import cuda_kernels, cuda_small
from demethify_tpu_torch.ops.cuda_kernels import (
    A_ALPHA,
    A_U,
    COST,
    DMAX2,
    L_H_PREV,
    L_W,
    L_W_PREV,
    N_SCAL,
    RT_SQ,
)

TILE = 64
N, N_S, N_CT = 200, 6, 4          # 200 sites: a ragged last tile of 64
TOL = {np.float64: dict(rtol=0, atol=1e-10),
       np.float32: dict(rtol=1e-5, atol=1e-5)}
TORCH_DT = {np.float64: torch.float64, np.float32: torch.float32}


def _problem(n_u, dtype, seed=0):
    rng = np.random.default_rng(seed)
    p = N_CT + n_u
    Rt = rng.uniform(size=(N, N_CT))
    u_true = rng.uniform(size=(N, n_u))
    alpha = rng.dirichlet(np.ones(p), size=N_S).T
    d = rng.poisson(50, size=(N, N_S)) + 1.0
    y = np.clip(np.hstack([Rt, u_true]) @ alpha
                + 0.01 * rng.normal(size=(N, N_S)), 0, 1)
    u = rng.uniform(size=(N, n_u))
    u_prev = np.clip(u + 0.05 * rng.normal(size=u.shape), 0, 1)
    cast = lambda x: np.asarray(x, dtype)           # noqa: E731
    return cast(y), cast(d), cast(Rt), cast(alpha), cast(u), cast(u_prev)


def _pad(x):
    target = -(-x.shape[-1] // TILE) * TILE
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, target - x.shape[-1])])


def _t(x):
    return torch.tensor(np.ascontiguousarray(x))


def _scal(dtype, **slots):
    s = np.zeros(N_SCAL, dtype)
    for k, v in slots.items():
        s[{"a_u": A_U, "l_w": L_W, "l_w_prev": L_W_PREV, "a_alpha": A_ALPHA,
           "l_h_prev": L_H_PREV, "rt_sq": RT_SQ, "dmax2": DMAX2}[k]] = v
    return torch.tensor(s)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n_u", [1, 2])
def test_u_phase_grams_matches_pallas(n_u, dtype):
    y, d, Rt, alpha, u, u_prev = _problem(n_u, dtype)
    tol = TOL[dtype]
    l_w = dtype(np.sum(alpha[-n_u:] ** 2) * d.max() ** 2)
    a, l_w_prev, steps = dtype(1.7), dtype(0.9 * l_w), 5
    ydt = np.concatenate([y.T, d.T])
    uut = np.concatenate([u.T, u_prev.T])

    want = u_phase_grams_packed(
        jnp.asarray(_pad(ydt)), jnp.asarray(_pad(Rt.T)),
        jnp.asarray(alpha[:-n_u]), jnp.asarray(alpha[-n_u:]),
        jnp.asarray(_pad(uut)), jnp.asarray(a), jnp.asarray(l_w),
        jnp.asarray(l_w_prev), steps, tile=TILE)
    uut_w, a_w, lwp_w, gu_w, bu_w, usq_w = (np.asarray(x) for x in want)

    tdt = TORCH_DT[dtype]
    uut_t = _t(uut)
    scal = _scal(dtype, a_u=a, l_w=l_w, l_w_prev=l_w_prev)
    alpha_t = _t(alpha)
    gu, bu, usq = cuda_kernels.u_phase_grams(
        _t(ydt), _t(Rt.T),
        alpha_t[:-n_u], alpha_t[-n_u:], uut_t, scal, steps)
    assert gu.dtype == bu.dtype == usq.dtype == tdt
    np.testing.assert_allclose(uut_t.numpy(), uut_w[:, :N], **tol)
    np.testing.assert_allclose(float(scal[A_U]), float(a_w), rtol=1e-6)
    np.testing.assert_allclose(float(scal[L_W_PREV]), float(lwp_w),
                               rtol=1e-6)
    scale = np.abs(gu_w).max()          # Gram entries are O(N * d)
    np.testing.assert_allclose(gu.numpy() / scale, gu_w / scale, **tol)
    np.testing.assert_allclose(bu.numpy() / scale, bu_w / scale, **tol)
    np.testing.assert_allclose(float(usq), float(usq_w),
                               rtol=max(tol["rtol"], 1e-12))
    assert cuda_kernels.u_phase_grams.launches == 0


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n_u", [1, 2])
def test_alpha_phase_full_matches_pallas(n_u, dtype):
    y, d, Rt, alpha, u, _ = _problem(n_u, dtype, seed=1)
    tol = TOL[dtype]
    from demethify_tpu.ops.gram import known_block_grams

    G_tt, b_t, ydy = (np.asarray(x, dtype) for x in known_block_grams(
        jnp.asarray(Rt, jnp.float64), jnp.asarray(d, jnp.float64),
        jnp.asarray(y, jnp.float64)))
    R = np.hstack([Rt, u]).astype(np.float64)
    gu = np.einsum("is,iu,iq->suq", d, u, R).astype(dtype)
    bu = np.einsum("iu,is->us", u, d * y).astype(dtype)
    usq = dtype(np.sum(u.astype(np.float64) ** 2))
    rng = np.random.default_rng(2)
    alpha_prev = rng.dirichlet(np.ones(alpha.shape[0]),
                               size=N_S).T.astype(dtype)
    dmax2 = dtype(d.max() ** 2)
    rt_sq = dtype(np.sum(Rt.astype(np.float64) ** 2))
    a, l_h_prev, steps = dtype(2.3), dtype(1.1 * (rt_sq + usq) * dmax2), 7

    want = j_alpha_full(
        jnp.asarray(G_tt), jnp.asarray(b_t), jnp.asarray(gu),
        jnp.asarray(bu), jnp.asarray(usq), jnp.asarray(ydy),
        jnp.asarray(alpha), jnp.asarray(alpha_prev), jnp.asarray(a),
        jnp.asarray(l_h_prev), rt_sq, dmax2, steps, n_u)
    al_w, ap_w, a_w, lhp_w, lw_w, cost_w = (np.asarray(x) for x in want)

    t = _t
    alpha_t, alpha_prev_t = t(alpha), t(alpha_prev)
    scal = _scal(dtype, a_alpha=a, l_h_prev=l_h_prev, rt_sq=rt_sq,
                 dmax2=dmax2)
    cuda_small.alpha_phase_full(t(G_tt), t(b_t), t(gu), t(bu), t(usq),
                                t(ydy), alpha_t, alpha_prev_t, scal, steps,
                                n_u)
    np.testing.assert_allclose(alpha_t.numpy(), al_w, **tol)
    np.testing.assert_allclose(alpha_prev_t.numpy(), ap_w, **tol)
    np.testing.assert_allclose(float(scal[A_ALPHA]), float(a_w), rtol=1e-6)
    np.testing.assert_allclose(float(scal[L_H_PREV]), float(lhp_w),
                               rtol=1e-6)
    np.testing.assert_allclose(float(scal[L_W]), float(lw_w), rtol=1e-5)
    # the Gram-identity cost cancels: compare relative to sum(ydy)
    scale = float(np.sum(ydy))
    np.testing.assert_allclose(float(scal[COST]) / scale,
                               float(cost_w) / scale, **tol)
    assert cuda_small.alpha_phase_full.launches == 0


def test_cuda_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("bad", ["n_u9", "no_sites", "shape",
                                 "noncontig", "dtype"])
def test_u_phase_grams_rejects(bad):
    n_u = 9 if bad == "n_u9" else 1
    n = 0 if bad == "no_sites" else 8
    n_s, n_ct = N_S, N_CT
    dt = torch.float16 if bad == "dtype" else torch.float64
    ydt = torch.zeros((2 * n_s, n), dtype=dt)
    rtt = torch.zeros((n_ct + (bad == "shape"), n), dtype=dt)
    if bad == "noncontig":
        rtt = torch.zeros((n, n_ct), dtype=dt).T
    a1 = torch.zeros((n_ct, n_s), dtype=dt)
    a2 = torch.zeros((n_u, n_s), dtype=dt)
    uut = torch.zeros((2 * n_u, n), dtype=dt)
    scal = torch.zeros(N_SCAL, dtype=dt)
    expected = {"dtype": TypeError, "n_u9": NotImplementedError}.get(
        bad, ValueError)
    with pytest.raises(expected, match="item 12" if bad == "n_u9" else None):
        cuda_kernels.u_phase_grams(ydt, rtt, a1, a2, uut, scal, 3)
