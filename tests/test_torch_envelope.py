"""The port's shape envelope: the kernel wrappers' twins at the shapes the
card's kernels once refused, against the JAX package's kernels (Pallas in
interpret mode), and the shape planning that picks the kernels' layouts.

- K1 ``u_phase_grams`` and K4 ``u_phase_grams_multi`` at n_s = 256 with
  25 known + 4 unknown cell types (the wide layout on the card), and in
  the n_u > 8 form (its state on the chip): n_u = 12 in both dataflows,
  the sweep's widest rank (n_u = 25, direct), the direct form past one
  chunk of samples (n_s = 40), n_u = 17 (gram) in K1 and n_u = 16 in K4,
  the last four at 256 sites;
- K1 with Rt folded into the data block ([Y.T; D.T; Rt.T], ``rtt`` None)
  against the JAX ``u_phase_grams_packed`` in its ``rt_folded`` layout;
- K1's ``bf16_compute`` in the direct form (d y rounded alone) against
  the JAX ``u_phase_grams(bf16_compute=True)``;
- K2, K3, K5 and K6 at p = 40 rows (the wide form on the card);
- ``u_phase_layout`` on every cover shape (n_s <= 512 at 25 + 4 in
  float32, float64 and bf16 storage; n_u up to 16), the resident layout
  at the shapes the kernel took before the wide one existed unless the
  wide one fits twice its blocks per SM, the glue
  kernels' ``glue_smem`` at p = 33-64, and K1's partial buffer at
  1M x 500.

Tolerances: float64 1e-10 (absolute on u and alpha, relative to the
largest Gram entry for the Gram blocks: the two sides sum in different
orders); bf16_compute 2e-3 as ``tests/test_torch_bf16.py`` (a site whose
u lies within rounding of a bf16 step rounds the other way). N is 2,048
sites, so interpret mode stays quick. The CUDA kernels have no CPU mode;
``chip_smoke.py`` checks them against these same twins on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demethify_tpu.ops.gram import known_block_grams as j_known_grams
from demethify_tpu.ops.pallas_kernels import u_phase_grams as j_k1
from demethify_tpu.ops.pallas_kernels import u_phase_grams_multi as j_k4
from demethify_tpu.ops.pallas_kernels import u_phase_grams_packed as j_k1p
from demethify_tpu.ops.pallas_small import alpha_phase_full as j_k2
from demethify_tpu.ops.pallas_small import alpha_phase_full_multi as j_k5
from demethify_tpu.ops.pallas_small import fw_phase_full as j_k3
from demethify_tpu.ops.pallas_small import fw_phase_full_multi as j_k6
from demethify_tpu_torch.ops import cuda_kernels, cuda_multi, cuda_small
from demethify_tpu_torch.ops.cuda_kernels import (
    A_ALPHA,
    A_U,
    ACTIVE,
    COST,
    DMAX2,
    L_H_PREV,
    L_W,
    L_W_PREV,
    N_SCAL,
    N_SCAL_MULTI,
    RT_SQ,
    SMEM_LIMIT,
    blocks_per_sm,
    gram_entries,
    state_rows,
    u_phase_layout,
    u_phase_smem,
)

N, TILE = 2048, 1024
TOL64 = dict(rtol=0, atol=1e-10)


def _t(x):
    return torch.tensor(np.ascontiguousarray(x))


def _data(n_s, n_ct, n_u, seed, n_b=1, n=N):
    """y, d, Rt (numpy float64) and n_b members' alpha, u, u_prev at n
    sites."""
    rng = np.random.default_rng(seed)
    p = n_ct + n_u
    R = rng.uniform(size=(n, p))
    alpha = rng.dirichlet(np.ones(p), size=n_s).T
    d = rng.poisson(50, size=(n, n_s)) + 1.0
    y = np.clip(R @ alpha + 0.01 * rng.normal(size=(n, n_s)), 0, 1)
    alpha_b = np.stack([rng.dirichlet(np.ones(p), size=n_s).T
                        for _ in range(n_b)])
    u_b = rng.uniform(size=(n_b, n_u, n))
    up_b = np.clip(u_b + 0.05 * rng.normal(size=u_b.shape), 0, 1)
    return y, d, R[:, :n_ct], alpha_b, u_b, up_b


def _assert_grams(got, want, tol=TOL64):
    """gu, b_u, usq relative to the largest Gram entry (sums over N)."""
    scale = np.abs(want[0]).max()
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g) / scale,
                                   np.asarray(w) / scale, **tol)


# ------------------------------------------------------------- K1 and K4
# the n_u > 8 form's widest user shapes run at N_WIDE_U sites (a tile of
# TILE_WIDE_U lanes on the JAX side), so interpret mode stays quick
N_WIDE_U, TILE_WIDE_U = 256, 128


@pytest.mark.parametrize("n_s,n_ct,n_u,folded,n", [
    (256, 25, 4, False, N), (48, 25, 12, False, N), (6, 4, 12, False, N),
    (10, 5, 2, True, N), (10, 5, 25, False, N_WIDE_U),
    (100, 5, 17, False, N_WIDE_U), (40, 5, 12, False, N_WIDE_U)],
    ids=["wide-n_s256-25+4", "n_u12-gram", "n_u12-direct", "rt-folded",
         "n_u25-direct-sweep", "n_u17-gram", "n_u12-direct-chunks"])
def test_u_phase_grams_matches_pallas(n_s, n_ct, n_u, folded, n):
    y, d, Rt, alpha_b, u_b, up_b = _data(n_s, n_ct, n_u, seed=n_s + n_u,
                                         n=n)
    alpha, u, up = alpha_b[0], u_b[0], up_b[0]
    l_w = np.sum(alpha[-n_u:] ** 2) * d.max() ** 2
    a, l_w_prev, steps = 1.7, 0.9 * l_w, 5
    ydt = np.concatenate([y.T, d.T] + ([Rt.T] if folded else []))
    uut = np.concatenate([u, up])
    j = jnp.asarray
    want = j_k1p(j(ydt), None if folded else j(Rt.T), j(alpha[:-n_u]),
                 j(alpha[-n_u:]), j(uut), j(a), j(l_w), j(l_w_prev), steps,
                 tile=min(TILE, n) if n == N else TILE_WIDE_U)
    uut_w, a_w, lwp_w, gu_w, bu_w, usq_w = (np.asarray(x) for x in want)

    scal = torch.zeros(N_SCAL, dtype=torch.float64)
    scal[A_U], scal[L_W], scal[L_W_PREV] = a, l_w, l_w_prev
    uut_t, alpha_t, ydt_t = _t(uut), _t(alpha), _t(ydt)
    got = cuda_kernels.u_phase_grams(
        ydt_t, None if folded else _t(Rt.T), alpha_t[:-n_u], alpha_t[-n_u:],
        uut_t, scal, steps)
    np.testing.assert_allclose(uut_t.numpy(), uut_w, **TOL64)
    np.testing.assert_allclose(float(scal[A_U]), float(a_w), rtol=1e-12)
    np.testing.assert_allclose(float(scal[L_W_PREV]), float(lwp_w),
                               rtol=1e-12)
    _assert_grams(got, (gu_w, bu_w, usq_w))
    if folded:
        # the folded layout is a view of one buffer: no copy of Rt, and
        # the same numbers as the unfolded call
        uut2, scal2 = _t(uut), scal.new_zeros(N_SCAL)
        scal2[A_U], scal2[L_W], scal2[L_W_PREV] = a, l_w, l_w_prev
        ref = cuda_kernels.u_phase_grams(
            ydt_t[:2 * n_s].clone(), ydt_t[2 * n_s:].clone(),
            alpha_t[:-n_u], alpha_t[-n_u:], uut2, scal2, steps)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
        assert torch.equal(uut_t, uut2)
    assert cuda_kernels.u_phase_grams.launches == 0


@pytest.mark.parametrize("n_s,n_ct,n_u,n", [
    (256, 25, 4, N), (48, 25, 12, N), (100, 5, 16, N_WIDE_U)],
    ids=["wide-n_s256-25+4", "n_u12", "n_u16"])
def test_u_phase_grams_multi_matches_pallas(n_s, n_ct, n_u, n):
    active = np.array([1.0, 0.0, 1.0])
    n_b = len(active)
    y, d, Rt, alpha_b, u_b, up_b = _data(n_s, n_ct, n_u, seed=7, n_b=n_b,
                                         n=n)
    l_w = np.sum(alpha_b[:, -n_u:] ** 2, axis=(1, 2)) * d.max() ** 2
    a = np.linspace(1.2, 2.4, n_b)
    l_w_prev, steps = 0.9 * l_w, 5
    j = jnp.asarray
    want = j_k4(j(y.T), j(d.T), j(Rt.T), j(alpha_b[:, :n_ct]),
                j(alpha_b[:, n_ct:]), j(u_b), j(up_b), j(a), j(l_w),
                j(l_w_prev), steps, active=j(active),
                tile=TILE if n == N else TILE_WIDE_U)
    u_w, up_w, a_w, lwp_w, gu_w, bu_w, usq_w = (np.asarray(x) for x in want)

    scal = np.zeros((n_b, N_SCAL_MULTI))
    scal[:, A_U], scal[:, L_W], scal[:, L_W_PREV] = a, l_w, l_w_prev
    scal[:, ACTIVE] = active
    uut_b = _t(np.concatenate([u_b, up_b], axis=1))
    uut_0, scal_t, alpha_t = uut_b.clone(), _t(scal), _t(alpha_b)
    gu, bu, usq = cuda_multi.u_phase_grams_multi(
        _t(np.concatenate([y.T, d.T])), _t(Rt.T), alpha_t[:, :n_ct],
        alpha_t[:, n_ct:], uut_b, scal_t, steps)
    act = active > 0
    np.testing.assert_allclose(uut_b[act, :n_u].numpy(), u_w[act], **TOL64)
    np.testing.assert_allclose(uut_b[act, n_u:].numpy(), up_w[act], **TOL64)
    assert torch.equal(uut_b[~act], uut_0[~act])
    np.testing.assert_allclose(scal_t[act, A_U].numpy(), a_w[act],
                               rtol=1e-12)
    for b in np.flatnonzero(act):
        _assert_grams((gu[b], bu[b], usq[b]), (gu_w[b], bu_w[b], usq_w[b]))
    assert cuda_multi.u_phase_grams_multi.launches == 0


def test_u_phase_grams_bf16_compute_direct_matches_pallas():
    """bf16_compute in the direct form (n_u^2 > 3 n_s): the float32
    dataflow with d y rounded to bf16, as the JAX kernel's fallback."""
    n_s, n_ct, n_u = 3, 4, 4
    assert not cuda_kernels.gram_form(n_u, n_s)
    y, d, Rt, alpha_b, u_b, up_b = _data(n_s, n_ct, n_u, seed=11)
    f32 = lambda x: np.asarray(x, np.float32)       # noqa: E731
    y, d, Rt, alpha, u, up = (f32(x) for x in (y, d, Rt, alpha_b[0],
                                               u_b[0], up_b[0]))
    l_w = np.float32(np.sum(alpha[-n_u:] ** 2) * d.max() ** 2)
    a, l_w_prev, steps = np.float32(1.7), np.float32(0.9 * l_w), 5
    jb = lambda x: jnp.asarray(x, jnp.bfloat16)     # noqa: E731
    jf = jnp.asarray
    want = j_k1(jb(y.T), jb(d.T), jb(Rt.T), jf(alpha[:-n_u]),
                jf(alpha[-n_u:]), jf(u), jf(up), jf(a), jf(l_w),
                jf(l_w_prev), steps, bf16_compute=True, tile=TILE)
    u_w, up_w, _, _, gu_w, bu_w, usq_w = (np.asarray(x) for x in want)
    tb = lambda x: _t(x).to(torch.bfloat16)         # noqa: E731
    scal = torch.zeros(N_SCAL)
    scal[A_U], scal[L_W], scal[L_W_PREV] = float(a), float(l_w), float(
        l_w_prev)
    uut = _t(np.concatenate([u, up]))
    alpha_t = _t(alpha)
    got = cuda_kernels.u_phase_grams(
        tb(np.concatenate([y.T, d.T])), tb(Rt.T), alpha_t[:-n_u],
        alpha_t[-n_u:], uut, scal, steps, bf16_compute=True)
    tol = dict(rtol=0, atol=2e-3)
    np.testing.assert_allclose(uut[:n_u].numpy(), u_w, **tol)
    np.testing.assert_allclose(uut[n_u:].numpy(), up_w, **tol)
    _assert_grams(got, (gu_w, bu_w, usq_w), tol)
    assert cuda_kernels.u_phase_grams.launches_bf16_compute == 0


# ------------------------------------------------------ K2, K3, K5, K6
P40 = (36, 4)            # n_ct, n_u: p = 40 rows


def _glue_blocks(n_b, seed, n_s=6):
    """Known blocks and n_b members' new-u blocks at p = 40 (numpy)."""
    n_ct, n_u = P40
    y, d, Rt, alpha_b, u_b, _ = _data(n_s, n_ct, n_u, seed, n_b)
    gtt, bt, ydy = (np.asarray(x) for x in j_known_grams(
        jnp.asarray(Rt), jnp.asarray(d), jnp.asarray(y)))
    u = np.swapaxes(u_b, 1, 2)                             # (B, N, n_u)
    R_b = np.concatenate([np.broadcast_to(Rt, (n_b, N, n_ct)), u], axis=2)
    gu = np.einsum("is,biu,biq->bsuq", d, u, R_b)
    bu = np.einsum("biu,is->bus", u, d * y)
    usq = np.sum(u * u, axis=(1, 2))
    rng = np.random.default_rng(seed + 1)
    alpha_prev_b = np.stack([rng.dirichlet(np.ones(n_ct + n_u), size=n_s).T
                             for _ in range(n_b)])
    return (gtt, bt, gu, bu, usq, ydy, alpha_b, alpha_prev_b, d.max() ** 2,
            np.sum(Rt ** 2))


def test_alpha_phase_full_p40_matches_pallas():
    (gtt, bt, gu, bu, usq, ydy, alpha_b, alpha_prev_b, dmax2,
     rt_sq) = _glue_blocks(1, seed=21)
    n_u = P40[1]
    a, l_h_prev, steps = 2.3, 1.1 * (rt_sq + usq[0]) * dmax2, 7
    j = jnp.asarray
    want = j_k2(j(gtt), j(bt), j(gu[0]), j(bu[0]), j(usq[0]), j(ydy),
                j(alpha_b[0]), j(alpha_prev_b[0]), j(a), j(l_h_prev), rt_sq,
                dmax2, steps, n_u)
    al_w, ap_w, a_w, lhp_w, lw_w, cost_w = (np.asarray(x) for x in want)
    scal = torch.zeros(N_SCAL, dtype=torch.float64)
    scal[A_ALPHA], scal[L_H_PREV], scal[RT_SQ], scal[DMAX2] = (
        a, l_h_prev, rt_sq, dmax2)
    al, ap = _t(alpha_b[0]), _t(alpha_prev_b[0])
    cuda_small.alpha_phase_full(_t(gtt), _t(bt), _t(gu[0]), _t(bu[0]),
                                _t(usq[0]), _t(ydy), al, ap, scal, steps,
                                n_u)
    np.testing.assert_allclose(al.numpy(), al_w, **TOL64)
    np.testing.assert_allclose(ap.numpy(), ap_w, **TOL64)
    np.testing.assert_allclose(float(scal[L_W]), float(lw_w), rtol=1e-10)
    scale = float(np.sum(ydy))
    np.testing.assert_allclose(float(scal[COST]) / scale,
                               float(cost_w) / scale, **TOL64)
    assert cuda_small.alpha_phase_full.launches == 0


def test_fw_phase_full_p40_matches_pallas():
    gtt, bt, gu, bu, _, ydy, alpha_b, _, dmax2, _ = _glue_blocks(1, seed=22)
    n_ct, n_u = P40
    purity = np.linspace(0.3, 0.9, alpha_b.shape[-1])
    alpha = alpha_b[0].copy()            # [known; unknown] at the purities
    alpha[:n_ct] *= purity / alpha[:n_ct].sum(0)
    alpha[n_ct:] *= (1 - purity) / alpha[n_ct:].sum(0)
    steps = 20
    j = jnp.asarray
    al_w, lw_w, cost_w = (np.asarray(x) for x in j_k3(
        j(gtt), j(bt), j(gu[0]), j(bu[0]), j(ydy), j(alpha), j(purity),
        dmax2, steps, n_u))
    scal = torch.zeros(N_SCAL, dtype=torch.float64)
    scal[DMAX2] = dmax2
    al = _t(alpha)
    cuda_small.fw_phase_full(_t(gtt), _t(bt), _t(gu[0]), _t(bu[0]), _t(ydy),
                             al, _t(purity), scal, steps, n_u)
    np.testing.assert_allclose(al.numpy(), al_w, rtol=0, atol=1e-12)
    np.testing.assert_allclose(float(scal[L_W]), float(lw_w), rtol=1e-10)
    assert cuda_small.fw_phase_full.launches == 0


def test_multi_glue_p40_matches_pallas():
    """K5 and K6 at p = 40, three members, the second inactive."""
    active = np.array([1.0, 0.0, 1.0])
    n_b = len(active)
    (gtt, bt, gu, bu, usq, ydy, alpha_b, alpha_prev_b, dmax2,
     rt_sq) = _glue_blocks(n_b, seed=23)
    n_ct, n_u = P40
    act = active > 0
    a = np.linspace(1.5, 2.5, n_b)
    l_h_prev, steps = 1.1 * (rt_sq + usq) * dmax2, 7
    j = jnp.asarray
    al_w, ap_w, _, _, lw_w, cost_w = (np.asarray(x) for x in j_k5(
        j(gtt), j(bt), j(gu), j(bu), j(usq), j(ydy), j(alpha_b),
        j(alpha_prev_b), j(a), j(l_h_prev), rt_sq, dmax2, steps, n_u))
    scal = np.zeros((n_b, N_SCAL_MULTI))
    scal[:, A_ALPHA], scal[:, L_H_PREV] = a, l_h_prev
    scal[:, RT_SQ], scal[:, DMAX2], scal[:, ACTIVE] = rt_sq, dmax2, active
    scal_t, al, ap = _t(scal), _t(alpha_b), _t(alpha_prev_b)
    cuda_small.alpha_phase_full_multi(_t(gtt), _t(bt), _t(gu), _t(bu),
                                      _t(usq), _t(ydy), al, ap, scal_t,
                                      steps, n_u)
    np.testing.assert_allclose(al[act].numpy(), al_w[act], **TOL64)
    np.testing.assert_allclose(ap[act].numpy(), ap_w[act], **TOL64)
    np.testing.assert_array_equal(al[~act].numpy(), alpha_b[~act])
    np.testing.assert_allclose(scal_t[act, L_W].numpy(), lw_w[act],
                               rtol=1e-10)

    purity = np.linspace(0.3, 0.9, alpha_b.shape[-1])
    fw_alpha = alpha_b.copy()
    fw_alpha[:, :n_ct] *= purity / fw_alpha[:, :n_ct].sum(1, keepdims=True)
    fw_alpha[:, n_ct:] *= (1 - purity) / fw_alpha[:, n_ct:].sum(
        1, keepdims=True)
    fw_w, fw_lw, _ = (np.asarray(x) for x in j_k6(
        j(gtt), j(bt), j(gu), j(bu), j(ydy), j(fw_alpha), j(purity), dmax2,
        20, n_u))
    scal = np.zeros((n_b, N_SCAL_MULTI))
    scal[:, DMAX2], scal[:, ACTIVE] = dmax2, active
    scal_t, al = _t(scal), _t(fw_alpha)
    cuda_small.fw_phase_full_multi(_t(gtt), _t(bt), _t(gu), _t(bu), _t(ydy),
                                   al, _t(purity), scal_t, 20, n_u)
    np.testing.assert_allclose(al[act].numpy(), fw_w[act], rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(al[~act].numpy(), fw_alpha[~act])
    assert cuda_small.alpha_phase_full_multi.launches == 0
    assert cuda_small.fw_phase_full_multi.launches == 0


# ------------------------------------------------------------ planning
def _parent_smem(itemsize, n_s, n_ct, n_u, direct, bf16c, weighted):
    """The one layout the kernels had before the wide one: everything
    resident (K1: + n_s direct rows, + n_u bf16_compute rows; K4: + n_u
    weighted rows)."""
    p = n_ct + n_u
    rows = (2 * n_s + p + (n_s if direct else 0)
            + (n_u if bf16c or weighted else 0))
    return itemsize * (rows * 129 + p * n_s)


@pytest.mark.parametrize("itemsize", [4, 8], ids=["4-byte", "8-byte"])
def test_layout_covers_the_cohort_shapes(itemsize):
    """Every n_s <= 512 at 25 + 4 (and 5 + 1) takes a layout, in both
    kernels and every form (bf16 storage has a 4-byte state), and n_u up
    to 16 at 25 known types. Where the old single layout fitted, the plan
    is that layout unless, in the gram form, the wide one fits at least
    twice as many blocks per SM (``chip_smoke.phase_narrow_bits`` holds
    the wide layout to the resident one's bits there)."""
    for n_s in range(1, 513):
        for n_ct, n_u in ((25, 4), (5, 1), (25, 9), (25, 16)):
            direct = not cuda_kernels.gram_form(n_u, n_s)
            for bf16c, weighted in ((False, False), (True, False),
                                    (False, True)):
                if weighted and direct:
                    continue                      # K4: gram form only
                bf16c = bf16c and itemsize == 4
                layout, smem = u_phase_layout(
                    "k", itemsize, n_s, n_ct, n_u, direct, bf16c, weighted)
                assert smem <= SMEM_LIMIT
                old = _parent_smem(itemsize, n_s, n_ct, n_u, direct,
                                   bf16c and not direct, weighted)
                wide = u_phase_smem("wide", itemsize, n_s, n_ct, n_u,
                                    direct, bf16c, weighted)
                faster = (not direct and blocks_per_sm(wide)
                          >= 2 * blocks_per_sm(old))
                if not (direct and bf16c) and n_u <= 8:
                    want = ("resident" if old <= SMEM_LIMIT and not faster
                            else "wide")
                    assert layout == want, (n_s, n_ct, n_u, direct, bf16c,
                                            weighted)
    assert u_phase_layout("k", 8, 500, 25, 4)[0] == "wide"
    assert u_phase_layout("k", 4, 100, 25, 4)[0] == "wide"
    assert u_phase_layout("k", 4, 10, 5, 1)[0] == "resident"   # main path
    assert u_phase_layout("k", 4, 50, 25, 4)[0] == "resident"
    assert u_phase_layout("k", 4, 16, 5, 8, direct=True)[0] == "resident"


def test_layout_raises_stating_the_shape():
    """Past the wide layout (2 x 10 rows of Y and D and 400 + 4 rows of
    [Rt | u], 129 float64 values each: 437,568 bytes) the plan no longer
    raises: the global layout keeps Y and D (2 x 10 rows), a ring of 2 x 44
    rows of Rt and the 4 u rows in shared memory, 112 rows, whatever p;
    before the steps the 108 rows below the u rows hold the known sums
    (10 rows) and all 400 rows of a1 (4000 values)."""
    assert u_phase_smem("wide", 8, 10, 400, 4) > SMEM_LIMIT
    assert u_phase_layout("u_phase_grams", 8, 10, 400, 4) == (
        "global", 8 * 112 * 129)
    assert cuda_kernels.global_plan(8, 10, 400, 4) == {
        "cs": 10, "q": 44, "depth": 2, "rows": 112, "res": 0, "kc": 400}
    assert u_phase_smem("global", 8, 10, 4000, 4) == 8 * 112 * 129
    # grows with n_s only up to one chunk of 32 samples
    assert u_phase_smem("wide", 8, 10_000, 25, 4) == u_phase_smem(
        "wide", 8, 32, 25, 4) > u_phase_smem("wide", 8, 10, 25, 4)


def test_partial_buffer_at_the_cohort_width():
    """K1's partial buffer (Gram entries x blocks of 128 sites) at 1M
    sites x 500 samples, 25 + 4, float64: at most half of Y + D."""
    n, n_s = 1_000_000, 500
    blocks = -(-n // cuda_kernels.SITES_PER_BLOCK)
    partial = gram_entries(n_s, 25, 4) * blocks * 8
    assert partial <= 0.5 * (2 * n_s * n * 8)
    # the n_u > 8 form's state region, rows of 129 values a block (no
    # longer a column per site in device memory): gram 3 u vectors + C +
    # M, direct 2 u vectors + a chunk of residuals (+ the gradient past one
    # chunk of 32 samples)
    assert state_rows(100, 8) == 0 and state_rows(100, 12) == 126
    assert state_rows(10, 12, True) == 34
    assert state_rows(80, 16, True) == 80


@pytest.mark.parametrize("p", [33, 40, 64])
def test_glue_smem_fits(p):
    """p = 33-64 takes the two-row form: a slab of p rows at an odd stride
    per column, at most 8 columns a block at n_s = 100; the wide form's
    slabs of p x p + 6 p values from p = 65."""
    for itemsize in (4, 8):
        n_warps, smem = cuda_small.glue_smem(itemsize, p, 100)
        assert 1 <= n_warps <= 8 and smem <= SMEM_LIMIT - 1024
        assert smem == n_warps * itemsize * p * (p | 1)
        n_warps, smem = cuda_small.glue_smem(itemsize, p + 32, 100)
        assert 1 <= n_warps <= 32 and smem <= SMEM_LIMIT - 1024
        q = p + 32
        assert smem == n_warps * itemsize * (q * q + 6 * q)
    assert cuda_small.glue_smem(8, 32, 10) == (10, 0)     # register form
    assert cuda_small.glue_smem(8, 200, 10)[0] == 0        # one slab: too big
