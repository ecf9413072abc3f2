"""The glue kernels' two-row form (32 < p <= 64 rows): its plan, and the
twins it is held to on the card against the JAX package's kernels.

- The plan (``cuda_small.alpha_plan``, ``glue_smem``, ``two_row_stride``;
  the kernels' ``dm_row_bucket``, ``dm_glue_smem``, ``dm_two_row_stride``):
  the padded row stride, the columns a block holds (one) and the shared
  bytes at p = 33, 40, 48 and 64 in both dtypes, pinned as hand-computed
  numbers; p = 65 still takes the wide form's plan.
- K2, K3, K5 and K6's twins (``alpha_phase_full``, ``fw_phase_full`` and
  their ``_multi`` forms on CPU tensors) against the JAX functions (Pallas
  in interpret mode) at p = 48 and 64, and at p = 40 with n_s = 100
  columns, float64, K5 and K6 with an inactive member.

Tolerances: float64 1e-10 absolute on alpha (K3, K6: 1e-12) and on the
cost relative to sum(ydy), 1e-10 relative on l_w (the two sides sum in
different orders). The CUDA kernels have no CPU mode; ``chip_smoke.py``
(``phase_wide_glue``) holds them to these same twins on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demethify_tpu.ops.gram import known_block_grams as j_known_grams
from demethify_tpu.ops.pallas_small import alpha_phase_full as j_k2
from demethify_tpu.ops.pallas_small import alpha_phase_full_multi as j_k5
from demethify_tpu.ops.pallas_small import fw_phase_full as j_k3
from demethify_tpu.ops.pallas_small import fw_phase_full_multi as j_k6
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
    SMEM_LIMIT,
)
from demethify_tpu_torch.ops.cuda_small import (
    alpha_plan,
    column_work,
    glue_smem,
    two_row_stride,
)

TOL64 = dict(rtol=0, atol=1e-10)
N = 1024

# (itemsize, p) -> bytes of a block's slab: itemsize x p x stride, the
# stride p rounded up to odd; a block holds one column at every n_s
PINNED = {
    (8, 33): 8_712, (8, 40): 13_120, (8, 48): 18_816, (8, 64): 33_280,
    (4, 33): 4_356, (4, 40): 6_560, (4, 48): 9_408, (4, 64): 16_640,
}


@pytest.mark.parametrize("p,stride", [(33, 33), (40, 41), (48, 49),
                                      (64, 65)])
def test_two_row_stride_is_odd(p, stride):
    """The slab's row stride: p rounded up to odd, so 32 lanes reading
    entry r of their rows hit 32 distinct banks in float32 (and 16
    distinct bank pairs a half-warp in float64)."""
    assert two_row_stride(p) == stride
    for itemsize in (4, 8):
        words = itemsize // 4
        banks = {(q * stride * words) % 32 for q in range(32 // words)}
        assert len(banks) == 32 // words


@pytest.mark.parametrize("key", sorted(PINNED), ids=lambda k: "-".join(
    f"{x}" for x in k))
@pytest.mark.parametrize("n_s", [10, 100])
def test_two_row_plan_is_pinned(key, n_s):
    """One column a block, n_s blocks a member, one slab of shared
    memory."""
    itemsize, p = key
    assert glue_smem(itemsize, p, n_s) == (1, PINNED[key])
    assert alpha_plan(p, n_s) == (64, 1, n_s)
    assert PINNED[key] <= SMEM_LIMIT - 1024
    assert column_work("alpha", itemsize, p, n_s) == 0
    assert column_work("fw", itemsize, p, n_s) == 0


def test_two_row_plan_covers_every_shape():
    """Every p in 33-64 and n_s up to 512: a block a column, the blocks
    covering the columns once, one slab under the card's limit."""
    for itemsize in (4, 8):
        for p in range(33, 65):
            for n_s in range(1, 513):
                assert alpha_plan(p, n_s) == (64, 1, n_s)
                n_w, smem = glue_smem(itemsize, p, n_s)
                assert n_w == 1 and smem == itemsize * p * two_row_stride(p)
                assert smem <= SMEM_LIMIT - 1024


def test_p65_keeps_the_wide_form():
    """Past 64 rows: no two-row plan, and the wide form's slabs of
    p x p + 6 p values (65 x 65 + 390 = 4,615), as many as fit, at most
    min(n_s, 32)."""
    with pytest.raises(ValueError):
        alpha_plan(65, 10)
    assert glue_smem(8, 65, 10) == (6, 221_520)       # 6 x 36,920 bytes
    assert glue_smem(4, 65, 10) == (10, 184_600)      # 10 x 18,460 bytes
    assert glue_smem(8, 64, 10) == (1, 8 * 64 * 65)
    assert alpha_plan(32, 10) == (32, 10, 1)          # register form


# ------------------------------------------------------ K2, K3, K5, K6
def _glue_blocks(n_ct, n_u, n_b, n_s, seed):
    """Known blocks and n_b members' new-u blocks (numpy float64) at
    p = n_ct + n_u rows, with alpha, alpha_prev, dmax^2 and ||Rt||^2."""
    rng = np.random.default_rng(seed)
    p = n_ct + n_u
    R = rng.uniform(size=(N, p))
    alpha = rng.dirichlet(np.ones(p), size=n_s).T
    d = rng.poisson(50, size=(N, n_s)) + 1.0
    y = np.clip(R @ alpha + 0.01 * rng.normal(size=(N, n_s)), 0, 1)
    Rt = R[:, :n_ct]
    gtt, bt, ydy = (np.asarray(x) for x in j_known_grams(
        jnp.asarray(Rt), jnp.asarray(d), jnp.asarray(y)))
    u = rng.uniform(size=(n_b, N, n_u))
    R_b = np.concatenate([np.broadcast_to(Rt, (n_b, N, n_ct)), u], axis=2)
    gu = np.einsum("is,biu,biq->bsuq", d, u, R_b)
    bu = np.einsum("biu,is->bus", u, d * y)
    usq = np.sum(u * u, axis=(1, 2))
    alpha_b = np.stack([rng.dirichlet(np.ones(p), size=n_s).T
                        for _ in range(n_b)])
    alpha_prev_b = np.stack([rng.dirichlet(np.ones(p), size=n_s).T
                             for _ in range(n_b)])
    return (gtt, bt, gu, bu, usq, ydy, alpha_b, alpha_prev_b, d.max() ** 2,
            np.sum(Rt ** 2))


def _t(x):
    return torch.tensor(np.ascontiguousarray(x))


def _at_purity(alpha, n_ct, purity):
    """alpha's known rows scaled to sum to purity, the unknown to 1 -
    purity (the Frank-Wolfe iterate's constraint), on the row axis -2."""
    out = alpha.copy()
    out[..., :n_ct, :] *= purity / out[..., :n_ct, :].sum(-2, keepdims=True)
    out[..., n_ct:, :] *= (1 - purity) / out[..., n_ct:, :].sum(
        -2, keepdims=True)
    return out


SHAPES = [(44, 4, 6), (60, 4, 6), (36, 4, 100)]
SHAPE_IDS = ["p48", "p64", "p40-n_s100"]


@pytest.mark.parametrize("n_ct,n_u,n_s", SHAPES, ids=SHAPE_IDS)
def test_alpha_phase_full_two_row_matches_pallas(n_ct, n_u, n_s):
    (gtt, bt, gu, bu, usq, ydy, alpha_b, alpha_prev_b, dmax2,
     rt_sq) = _glue_blocks(n_ct, n_u, 1, n_s, seed=n_ct + n_s)
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
    np.testing.assert_allclose(float(scal[A_ALPHA]), float(a_w), rtol=1e-12)
    np.testing.assert_allclose(float(scal[L_H_PREV]), float(lhp_w),
                               rtol=1e-12)
    np.testing.assert_allclose(float(scal[L_W]), float(lw_w), rtol=1e-10)
    scale = float(np.sum(ydy))
    np.testing.assert_allclose(float(scal[COST]) / scale,
                               float(cost_w) / scale, **TOL64)
    assert cuda_small.alpha_phase_full.launches == 0


@pytest.mark.parametrize("n_ct,n_u,n_s", SHAPES, ids=SHAPE_IDS)
def test_fw_phase_full_two_row_matches_pallas(n_ct, n_u, n_s):
    gtt, bt, gu, bu, _, ydy, alpha_b, _, dmax2, _ = _glue_blocks(
        n_ct, n_u, 1, n_s, seed=n_ct + n_s + 1)
    purity = np.linspace(0.3, 0.9, n_s)
    alpha = _at_purity(alpha_b[0], n_ct, purity)
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
    scale = float(np.sum(ydy))
    np.testing.assert_allclose(float(scal[COST]) / scale,
                               float(cost_w) / scale, **TOL64)
    assert cuda_small.fw_phase_full.launches == 0


@pytest.mark.parametrize("n_ct,n_u,n_s", SHAPES, ids=SHAPE_IDS)
def test_alpha_phase_full_multi_two_row_matches_pallas(n_ct, n_u, n_s):
    """K5, three members, the second inactive (left exactly as it was)."""
    active = np.array([1.0, 0.0, 1.0])
    n_b, act = len(active), active > 0
    (gtt, bt, gu, bu, usq, ydy, alpha_b, alpha_prev_b, dmax2,
     rt_sq) = _glue_blocks(n_ct, n_u, n_b, n_s, seed=n_ct + n_s + 2)
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
    np.testing.assert_array_equal(ap[~act].numpy(), alpha_prev_b[~act])
    np.testing.assert_allclose(scal_t[act, L_W].numpy(), lw_w[act],
                               rtol=1e-10)
    scale = float(np.sum(ydy))
    np.testing.assert_allclose(scal_t[act, COST].numpy() / scale,
                               cost_w[act] / scale, **TOL64)
    assert cuda_small.alpha_phase_full_multi.launches == 0


@pytest.mark.parametrize("n_ct,n_u,n_s", SHAPES, ids=SHAPE_IDS)
def test_fw_phase_full_multi_two_row_matches_pallas(n_ct, n_u, n_s):
    """K6, three members, the second inactive (left exactly as it was)."""
    active = np.array([1.0, 0.0, 1.0])
    n_b, act = len(active), active > 0
    gtt, bt, gu, bu, _, ydy, alpha_b, _, dmax2, _ = _glue_blocks(
        n_ct, n_u, n_b, n_s, seed=n_ct + n_s + 3)
    purity = np.linspace(0.3, 0.9, n_s)
    fw_alpha = _at_purity(alpha_b, n_ct, purity)
    steps = 20
    j = jnp.asarray
    fw_w, lw_w, cost_w = (np.asarray(x) for x in j_k6(
        j(gtt), j(bt), j(gu), j(bu), j(ydy), j(fw_alpha), j(purity), dmax2,
        steps, n_u))
    scal = np.zeros((n_b, N_SCAL_MULTI))
    scal[:, DMAX2], scal[:, ACTIVE] = dmax2, active
    scal_t, al = _t(scal), _t(fw_alpha)
    cuda_small.fw_phase_full_multi(_t(gtt), _t(bt), _t(gu), _t(bu), _t(ydy),
                                   al, _t(purity), scal_t, steps, n_u)
    np.testing.assert_allclose(al[act].numpy(), fw_w[act], rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(al[~act].numpy(), fw_alpha[~act])
    np.testing.assert_allclose(scal_t[act, L_W].numpy(), lw_w[act],
                               rtol=1e-10)
    scale = float(np.sum(ydy))
    np.testing.assert_allclose(scal_t[act, COST].numpy() / scale,
                               cost_w[act] / scale, **TOL64)
    assert cuda_small.fw_phase_full_multi.launches == 0
