"""The single-phase kernels K7 ``u_phase``, K8 ``grams``, K9
``alpha_phase`` and K10 ``fw_phase`` on CPU tensors, where their wrappers
run the plain PyTorch twins, against the JAX package's Pallas wrappers in
interpret mode (``tile=64``, so the 200-site problems run several
programs and a ragged last one); and their composition K7 -> K8 -> K9
(``chip_smoke.composed_solve``) against the JAX composition and the plain
solver's cost trace.

Tolerances:
- float64: 1e-10 absolute for the U and alpha iterates, 1e-10 of each
  Gram output's largest entry, as the JAX tests hold them (the two sides
  sum in different orders);
- float32: 1e-5 absolute for u and alpha (values in [0, 1]; XLA's CPU dots
  and PyTorch's sum C, M and G a in other orders, a few ulps per step),
  1e-6 of each Gram output's largest entry (200-term float32 sums);
- bf16 data: both sides round the same products to bf16 and sum in
  float32, so the float32 bounds hold; the twin of K8 differs from
  ``ops/gram.sample_grams`` under bf16 by about 3e-4 (r d_s rounded),
  far outside that bound.

The CUDA kernels have no CPU mode; ``chip_smoke.py`` holds them to these
same twins on the card.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demethify_tpu.ops.pallas_kernels import grams as j_grams
from demethify_tpu.ops.pallas_kernels import u_phase as j_u_phase
from demethify_tpu.ops.pallas_small import alpha_phase as j_alpha_phase
from demethify_tpu.ops.pallas_small import fw_phase as j_fw_phase
from demethify_tpu_torch.ops import cuda_kernels, cuda_small
from demethify_tpu_torch.ops.gram import sample_grams
from demethify_tpu_torch.solvers.partial_ref import partial_ref_solve

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

TILE = 64
N, N_S, N_CT = 200, 6, 4
U_TOL = {"float64": 1e-10, "float32": 1e-5}
GRAM_TOL = {"float64": 1e-10, "float32": 1e-6}


def _problem(n_u, dtype, seed=0, n_ct=N_CT, n_s=N_S):
    rng = np.random.default_rng(seed)
    p = n_ct + n_u
    Rt = rng.uniform(size=(N, n_ct))
    u_true = rng.uniform(size=(N, n_u))
    alpha = rng.dirichlet(np.ones(p), size=n_s).T
    d = rng.poisson(50, size=(N, n_s)) + 1.0
    y = np.clip(np.hstack([Rt, u_true]) @ alpha
                + 0.01 * rng.normal(size=(N, n_s)), 0, 1)
    u = rng.uniform(size=(N, n_u))
    u_prev = np.clip(u + 0.05 * rng.normal(size=u.shape), 0, 1)
    cast = lambda x: np.asarray(x, dtype)           # noqa: E731
    return cast(y), cast(d), cast(Rt), cast(alpha), cast(u), cast(u_prev)


def _t(x):
    return torch.tensor(np.ascontiguousarray(x))


def _data(x, data):
    """numpy x as a (JAX, torch) pair, in bf16 when ``data`` says so."""
    j, t = jnp.asarray(x), _t(x)
    if data == "bfloat16":
        j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


# ------------------------------------------------------------------- K7

@pytest.mark.parametrize("n_u,dtype,known,lagged,data", [
    (2, "float64", True, False, None),
    (2, "float64", True, True, None),
    (3, "float64", False, True, None),     # the unsupervised shape
    (2, "float32", True, False, None),
    (2, "float32", True, False, "bfloat16"),
    (9, "float64", True, False, None),     # past the register form
])
def test_u_phase_matches_pallas(n_u, dtype, known, lagged, data):
    dt = getattr(np, dtype)
    y, d, Rt, alpha, u, u_prev = _problem(n_u, dt, seed=n_u)
    l_w = dt(np.sum(alpha[-n_u:] ** 2) * d.max() ** 2)
    a, l_w_prev, steps = dt(1.7), dt(0.9 * l_w), 5
    jy, ty = _data(y.T, data)
    jd, td = _data(d.T, data)
    jr, tr = _data(Rt.T, data) if known else (None, None)
    a1 = alpha[:-n_u] if known else None
    want = j_u_phase(jy, jd, jr, None if a1 is None else jnp.asarray(a1),
                     jnp.asarray(alpha[-n_u:]), jnp.asarray(u.T),
                     jnp.asarray(u_prev.T), jnp.asarray(a),
                     jnp.asarray(l_w), jnp.asarray(l_w_prev), steps,
                     lagged=lagged, tile=TILE)
    ut, upt = _t(u.T), _t(u_prev.T)
    got = cuda_kernels.u_phase(ty, td, tr, None if a1 is None else _t(a1),
                               _t(alpha[-n_u:]), ut, upt, a, l_w, l_w_prev,
                               steps, lagged=lagged)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=U_TOL[dtype])
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-12)
    np.testing.assert_array_equal(ut.numpy(), u.T)      # inputs unchanged
    np.testing.assert_array_equal(upt.numpy(), u_prev.T)
    assert cuda_kernels.u_phase.launches == 0


def test_u_phase_zero_steps_and_refusals():
    y, d, Rt, alpha, u, u_prev = _problem(1, np.float64)
    args = (_t(y.T), _t(d.T), _t(Rt.T), _t(alpha[:-1]), _t(alpha[-1:]),
            _t(u.T), _t(u_prev.T))
    u0, up0, a0, lp0 = cuda_kernels.u_phase(*args, 2.0, 5.0, 4.0, 0)
    assert torch.equal(u0, args[5]) and torch.equal(up0, args[6])
    assert float(a0) == 2.0 and float(lp0) == 4.0
    with pytest.raises(ValueError):
        cuda_kernels.u_phase(*args[:5], args[5][:, :10], args[6], 1.0, 1.0,
                             1.0, 3)
    with pytest.raises(TypeError):
        cuda_kernels.u_phase(*(x.to(torch.float16) for x in args), 1.0,
                             1.0, 1.0, 3)


def test_k7_shared_memory_plan():
    """K7's plan: the n_ct staged rows of Rt, 129 values each, whatever
    n_s and n_u; a raise, naming the bytes, past the card's limit.
    ``chip_smoke.py`` holds ``k7_smem`` to the kernel's
    ``dm_u_phase_smem`` export."""
    smem = cuda_kernels.k7_smem
    assert smem(4, 5) == 4 * 5 * 129
    assert smem(4, 25) == 4 * 25 * 129
    assert smem(8, 25) == 8 * 25 * 129
    assert smem(4, 0) == 0
    assert smem(8, 225) <= cuda_kernels.SMEM_LIMIT
    assert smem(4, 450) <= cuda_kernels.SMEM_LIMIT
    with pytest.raises(NotImplementedError, match="bytes"):
        smem(8, 226)
    with pytest.raises(NotImplementedError, match="bytes"):
        smem(4, 451)


# ------------------------------------------------------------------- K8

@pytest.mark.parametrize("dtype,data", [("float64", None),
                                        ("float32", None),
                                        ("float32", "bfloat16")])
def test_grams_matches_pallas(dtype, data):
    dt = getattr(np, dtype)
    y, d, Rt, alpha, u, _ = _problem(2, dt, seed=11)
    R = np.hstack([Rt, u])
    jy, ty = _data(y.T, data)
    jd, td = _data(d.T, data)
    jr, tr = _data(R.T, data)
    want = j_grams(jy, jd, jr, tile=TILE)
    got = cuda_kernels.grams(ty, td, tr)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == getattr(torch, dtype) and g.shape == w.shape
        scale = np.abs(w).max()
        np.testing.assert_allclose(g.numpy() / scale, w / scale, rtol=0,
                                   atol=GRAM_TOL[dtype])
    assert cuda_kernels.grams.launches == 0


def test_grams_bf16_is_not_sample_grams():
    """Under bf16 K8 rounds r d_s and d y where the JAX kernel's program
    rounds them; ``sample_grams`` follows the solvers' programs, which do
    not, so the two differ far beyond K8's bound (G and b), while ydy
    ((d y rounded) y, unrounded, summed in float32) agrees."""
    y, d, Rt, _, u, _ = _problem(2, np.float32, seed=12)
    R = np.hstack([Rt, u])
    ty, td, tr = (_t(x).to(torch.bfloat16) for x in (y.T, d.T, R.T))
    got = cuda_kernels.grams(ty, td, tr)
    ref = sample_grams(tr.T, td.T, ty.T)
    rel = [float((g - r).abs().max() / r.abs().max())
           for g, r in zip(got, ref)]
    assert rel[0] > 100 * GRAM_TOL["float32"]
    assert rel[1] > 100 * GRAM_TOL["float32"]
    assert rel[2] <= GRAM_TOL["float32"]


def test_grams_plan():
    """K8's launch plan covers every site in whole tiles (chunks of whole
    tiles, the last one ragged), every sample in its groups and every
    column in its warp tiles, and keeps the shared memory under the
    card's limit at the main shape, the cohort shape, ragged N and
    p = 64, n_s = 500 in float64 (the widest: 16 sample groups of 32, its
    67 warp tiles of columns in five column groups)."""
    for n, n_s, p in ((1_000_000, 10, 6), (1_000_000, 100, 29),
                      (1_000_003, 3, 1), (70_000, 500, 64)):
        for kind in (0, 1, 2):
            plan = cuda_kernels.grams_plan(n, n_s, p, kind)
            chunk = plan.chunk_sites
            assert chunk % plan.tile == 0
            assert (plan.n_chunks - 1) * chunk < n <= plan.n_chunks * chunk
            assert plan.n_chunks <= 65535
            assert ((plan.n_groups - 1) * plan.group_samples < n_s
                    <= plan.n_groups * plan.group_samples)
            assert plan.smem == cuda_kernels.grams_smem(
                kind, p, plan.group_samples, plan.tile, plan.stages,
                plan.items, plan.slices) <= cuda_kernels.SMEM_LIMIT
    wide = cuda_kernels.grams_plan(70_000, 500, 64, 1)
    assert (wide.group_samples, wide.n_groups, wide.col_groups) == (32, 16, 5)
    assert wide.col_groups * wide.items >= 2080 // 32 + 2


# ------------------------------------------------------------- K9, K10

def _grams64(n_u, n_ct=N_CT, seed=20, n_s=N_S):
    y, d, Rt, alpha, u, u_prev = _problem(n_u, np.float64, seed, n_ct, n_s)
    R = np.hstack([Rt, u])
    G = np.einsum("is,iq,ir->sqr", d, R, R)
    b = np.einsum("iq,is->qs", R, d * y)
    l_h = np.sum(R * R) * d.max() ** 2
    return G, b, l_h, alpha


@pytest.mark.parametrize("p,masked,dtype", [(6, False, "float64"),
                                            (6, True, "float64"),
                                            (6, False, "float32"),
                                            (40, False, "float64"),
                                            (100, False, "float64"),
                                            (100, False, "float32"),
                                            (200, False, "float64"),
                                            (200, True, "float64"),
                                            (460, False, "float64"),
                                            (625, False, "float64")])
def test_alpha_phase_matches_pallas(p, masked, dtype):
    """p = 100 and 200 run K2's column blocks on the card (one block, a
    cluster of two), p = 460 a cluster of nine, p = 625 its device rows
    past 16 blocks."""
    dt = getattr(np, dtype)
    n_u = 2
    G, b, l_h, alpha = (np.asarray(x, dt) for x in _grams64(
        n_u, n_ct=p - n_u, seed=21 + p))
    rng = np.random.default_rng(p)
    alpha_prev = rng.dirichlet(np.ones(p), size=N_S).T.astype(dt)
    mask = (np.arange(p) != p - 1).astype(dt) if masked else None
    if masked:
        alpha = alpha * mask[:, None]
        alpha = (alpha / alpha.sum(0)).astype(dt)
    a, l_h_prev, steps = dt(1.9), dt(1.07 * l_h), 9
    want = j_alpha_phase(jnp.asarray(G), jnp.asarray(b), jnp.asarray(alpha),
                         jnp.asarray(alpha_prev), jnp.asarray(a),
                         jnp.asarray(l_h_prev), jnp.asarray(l_h), steps,
                         row_mask=None if mask is None else jnp.asarray(mask))
    al, ap = _t(alpha), _t(alpha_prev)
    got = cuda_small.alpha_phase(_t(G), _t(b), al, ap, a, l_h_prev, l_h,
                                 steps,
                                 row_mask=None if mask is None else _t(mask))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=U_TOL[dtype])
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-12)
    if masked:
        assert (got[0][-1] == 0).all()
    np.testing.assert_array_equal(al.numpy(), alpha)     # inputs unchanged
    assert cuda_small.alpha_phase.launches == 0


@pytest.mark.parametrize("p,steps,dtype", [(6, 25, "float64"),
                                           (6, 100, "float64"),
                                           (6, 25, "float32"),
                                           (40, 30, "float64"),
                                           (100, 8, "float64"),
                                           (100, 8, "float32"),
                                           (200, 8, "float64"),
                                           (490, 8, "float64"),
                                           (671, 8, "float64")])
def test_fw_phase_matches_pallas(p, steps, dtype):
    """n_steps <= 64 runs the JAX kernel's unrolled schedule, 100 its
    chunked fori_loop; p = 40 the port's two-row form, p = 100 and 200
    K3's column blocks (one block, a cluster of two), p = 490 a cluster of
    nine, p = 671 its device rows past 16 blocks (8 steps: the
    interpret-mode schedule unrolls them)."""
    dt = getattr(np, dtype)
    n_u = 2
    G, b = (np.asarray(x, dt)
            for x in _grams64(n_u, n_ct=p - n_u, seed=31 + p)[:2])
    rng = np.random.default_rng(steps)
    purity = rng.uniform(0.2, 0.8, size=N_S).astype(dt)
    a1 = (rng.dirichlet(np.ones(p - n_u), size=N_S).T * purity).astype(dt)
    a2 = (rng.dirichlet(np.ones(n_u), size=N_S).T * (1 - purity)).astype(dt)
    want = j_fw_phase(jnp.asarray(G), jnp.asarray(b), jnp.asarray(a1),
                      jnp.asarray(a2), jnp.asarray(purity), steps)
    got = cuda_small.fw_phase(_t(G), _t(b), _t(a1), _t(a2), _t(purity),
                              steps)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12 if dtype == "float64"
                                   else U_TOL[dtype])
    np.testing.assert_allclose(got[0].sum(0).numpy(), purity,
                               atol=1e-5 if dtype == "float32" else 1e-12)
    assert cuda_small.fw_phase.launches == 0


def test_fw_phase_refuses_an_empty_block():
    G, b, _, alpha = _grams64(2)
    with pytest.raises(ValueError):
        cuda_small.fw_phase(_t(G), _t(b), _t(alpha[:0]), _t(alpha),
                            torch.full((N_S,), 0.5, dtype=torch.float64), 3)


# ----------------------------------------------------------- the slice

def test_composed_iteration_matches_jax_and_plain_solver():
    """Three outer iterations of K7 -> K8 -> K9 (the helper ``chip_smoke``
    drives on the card) on the twins, against the same composition of the
    JAX package's Pallas kernels and against ``partial_ref_solve``'s cost
    trace and iterates from the same inits, float64."""
    n_u, n1, n2 = 2, 3, 5
    y, d, Rt, _, _, _ = _problem(n_u, np.float64, seed=40)
    rng = np.random.default_rng(41)
    u0 = rng.uniform(size=(N, n_u))
    a0 = rng.dirichlet(np.ones(N_CT + n_u), size=N_S).T

    u_c, a_c, tr_c = chip_smoke.composed_solve(
        _t(u0), _t(a0), _t(y), _t(d), _t(Rt), n_u, n1, n2)

    # the JAX composition: u_phase -> grams -> alpha_phase
    yt, dt, rtt = jnp.asarray(y.T), jnp.asarray(d.T), jnp.asarray(Rt.T)
    dmax2 = d.max() ** 2
    rt_sq = np.sum(Rt * Rt)
    ut, upt = jnp.asarray(u0.T), jnp.asarray(u0.T)
    alpha, alpha_prev = jnp.asarray(a0), jnp.asarray(a0)
    a1 = a2 = jnp.ones(())
    l_w = l_w_prev = jnp.sum(alpha[-n_u:] ** 2) * dmax2
    l_h_prev = jnp.asarray((rt_sq + np.sum(u0 * u0)) * dmax2)
    trace = []
    for _ in range(n1):
        ut, upt, a1, l_w_prev = j_u_phase(
            yt, dt, rtt, alpha[:-n_u], alpha[-n_u:], ut, upt, a1, l_w,
            l_w_prev, n2, tile=TILE)
        G, b, ydy = j_grams(yt, dt, jnp.concatenate([rtt, ut]), tile=TILE)
        l_h = (rt_sq + jnp.sum(ut * ut)) * dmax2
        alpha, alpha_prev, a2, l_h_prev = j_alpha_phase(
            G, b, alpha, alpha_prev, a2, l_h_prev, l_h, n2)
        l_w = jnp.sum(alpha[-n_u:] ** 2) * dmax2
        trace.append(float(jnp.sum(ydy - 2.0 * jnp.sum(b * alpha, axis=0)
                                   + jnp.einsum("spq,ps,qs->s", G, alpha,
                                                alpha))))
    np.testing.assert_allclose(u_c.numpy(), np.asarray(ut).T, rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(a_c.numpy(), np.asarray(alpha), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(tr_c.numpy(), trace, rtol=1e-10)

    u_p, a_p, info = partial_ref_solve(_t(u0), _t(a0), _t(y), _t(d), _t(Rt),
                                       n_u, n_iter1=n1, n_iter2=n2, tol=0.0,
                                       record_trace=True)
    assert info["n_iter"] == n1 == len(tr_c)
    np.testing.assert_allclose(tr_c.numpy(), info["trace"].numpy(),
                               rtol=1e-10)
    np.testing.assert_allclose(a_c.numpy(), a_p.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(u_c.numpy(), u_p.numpy(), rtol=0, atol=1e-10)
