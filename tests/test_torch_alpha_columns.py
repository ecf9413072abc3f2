"""K2's and K5's column-block form (p > 64 rows): its plan, the order of
its step, and the twins it is held to on the card against the JAX
package's kernels.

- The plan (``cuda_small.alpha_column_plan``; the kernels'
  ``dm_alpha_column_plan``, which ``chip_smoke.phase_layouts`` holds it to
  on the card): over p = 65-700 in both dtypes, at most 16 blocks a
  column, past that the device rows (G_s's rows in a work buffer the
  wrapper sizes), a block's bytes under the card's limit, every row owned
  by one thread of one block; a few shapes pinned to hand-computed
  numbers. The cost's groups (``alpha_column_groups``) are the warps of
  the one-block wide loop the form replaced, past the old edge of 8
  blocks too.
- A numpy transcription of the column blocks' step: rows dealt over C
  blocks of R threads, each row's v summed over r in index order, each
  row's stable rank from the gathered column, one chain of adds for the
  cumulative sum in rank order, the ranks' tests side by side and rho as
  their maximum. Over 20 steps it equals a numpy transcription of the
  one-warp wide loop (lane q over rows q, q + 32, ..., lane 0 running the
  cumulative sum and the tests in rank order) bit for bit, in float32 and
  float64, with forced ties, masked rows (ties at -1e30) and a column
  that turns NaN; and projection by projection on columns with a -0/+0
  tie and NaNs.
- K2's and K5's twins (``alpha_phase_full`` and ``alpha_phase_full_multi``
  on CPU tensors) against the JAX functions (Pallas in interpret mode) at
  p = 100 and 180 rows, float64, 10 steps: K2 with a row mask, K5 with an
  inactive member and with shared (p = 100) and per-member (p = 180)
  known blocks; and K2 on a column whose v holds a NaN, which both make
  NaN in every row.

Tolerances: float64 1e-12 absolute on alpha and alpha_prev, 1e-12 on the
cost relative to sum(ydy) and 1e-10 relative on l_w (the two sides sum
in different orders). The CUDA kernels have no CPU mode;
``chip_smoke.py`` (``phase_wide_glue``, ``phase_global_kernels``) holds
them to these same twins on the card, and ``save_outputs(...,
"columns")`` to the kernels they replaced, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demethify_tpu.ops.gram import known_block_grams as j_known_grams
from demethify_tpu.ops.pallas_small import alpha_phase_full as j_k2
from demethify_tpu.ops.pallas_small import alpha_phase_full_multi as j_k5
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
    ALPHA_SLAB_LOOP_WARPS,
    MAX_COLUMN_BLOCKS,
    alpha_column_groups,
    alpha_column_plan,
    column_work,
    glue_smem,
)

# the JAX kernels (Pallas in interpret mode), jitted: n_steps and n_u
# static
j_k2 = jax.jit(j_k2, static_argnums=(12, 13))
j_k5 = jax.jit(j_k5, static_argnums=(12, 13))

LIMIT = SMEM_LIMIT - 1024
THREADS = 256                    # the kernel's launch bound


# ------------------------------------------------------------------ plan
def _elems(rows, p):
    """A block's values: R rows of G_s and seven rows of p."""
    return rows * p + 7 * p


@pytest.mark.parametrize("itemsize", [4, 8])
def test_column_plan_covers_every_shape(itemsize):
    """p = 65-700: the fewest blocks (at most 16) whose shared memory holds
    the column, each owning a non-empty run of rows, every row owned once;
    past 16 blocks the device rows (16 blocks, G_s's rows in device
    memory, the seven rows of p in shared memory), whose work buffer the
    wrapper sizes."""
    for p in range(65, 701):
        plan = alpha_column_plan(itemsize, p)
        c = plan["blocks"]
        assert 1 <= c <= MAX_COLUMN_BLOCKS
        rows = -(-p // c)
        assert plan["rows"] == rows
        assert plan["threads"] == 32 * -(-rows // 32) <= THREADS
        if plan["device"]:
            assert c == MAX_COLUMN_BLOCKS and plan["device"] == 1
            assert itemsize * _elems(rows, p) > LIMIT
            assert plan["bytes"] == itemsize * 7 * p
            for n_s in (1, 10, 32, 500):
                assert column_work("alpha", itemsize, p, n_s) == (
                    n_s * c * rows * p)
        else:
            assert plan["bytes"] == itemsize * _elems(rows, p) <= LIMIT
            assert column_work("alpha", itemsize, p, 10) == 0
        if c > 1:
            assert itemsize * _elems(-(-p // (c - 1)), p) > LIMIT
        owned = [range(k * rows, min(k * rows + rows, p)) for k in range(c)]
        assert all(len(r) >= 1 for r in owned)
        assert [q for r in owned for q in r] == list(range(p))


# (itemsize, p) -> (blocks, rows, threads, device, bytes), worked out by
# hand: bytes = itemsize (R p + 7 p), R = ceil(p / C), C the fewest blocks
# under 232,448 - 1,024 = 231,424 bytes, at most 16; past 16 the device
# rows (device 1: bytes = itemsize 7 p, the rows of p in shared memory;
# device 2 where those pass the limit less 1 KB more, 230,400 bytes:
# bytes 0), threads R rounded up to warps, at most 1024
PINNED = {
    (8, 65): (1, 65, 96, 0, 37_440),          # 8 (4,225 + 455)
    (8, 100): (1, 100, 128, 0, 85_600),       # 8 (10,000 + 700)
    (8, 166): (1, 166, 192, 0, 229_744),      # 8 (27,556 + 1,162)
    (8, 167): (2, 84, 96, 0, 121_576),        # one block: 8 x 29,058 > limit
    (8, 200): (2, 100, 128, 0, 171_200),      # 8 (20,000 + 1,400)
    (8, 210): (2, 105, 128, 0, 188_160),      # 8 (22,050 + 1,470)
    (8, 452): (8, 57, 64, 0, 231_424),        # 8 (25,764 + 3,164): the limit
    (8, 453): (9, 51, 64, 0, 210_192),        # 8 blocks: 8 x 28,992 > limit
    (8, 460): (9, 52, 64, 0, 217_120),        # 8 (23,920 + 3,220)
    (8, 624): (16, 39, 64, 0, 229_632),       # 8 (24,336 + 4,368)
    (8, 625): (16, 40, 64, 1, 35_000),        # 16: 8 x 29,375 > limit
    (8, 4114): (16, 258, 288, 1, 230_384),    # 8 x 7 x 4,114
    (8, 4115): (16, 258, 288, 2, 0),          # 8 x 7 x 4,115 > limit - 1 KB
    (4, 65): (1, 65, 96, 0, 18_720),
    (4, 100): (1, 100, 128, 0, 42_800),
    (4, 237): (1, 237, 256, 0, 231_312),      # 4 (56,169 + 1,659)
    (4, 238): (2, 119, 128, 0, 119_952),      # one block: 4 x 58,310 > limit
    (4, 240): (2, 120, 128, 0, 121_920),      # 4 (28,800 + 1,680)
    (4, 650): (8, 82, 96, 0, 231_400),        # 4 (53,300 + 4,550)
    (4, 651): (9, 73, 96, 0, 208_320),        # 4 (47,523 + 4,557)
    (4, 904): (16, 57, 64, 0, 231_424),       # 4 (51,528 + 6,328): the limit
    (4, 905): (16, 57, 64, 1, 25_340),        # 4 x 7 x 905
    (4, 16484): (16, 1031, 1024, 2, 0),       # 4 x 7 x 16,484 > limit
}


@pytest.mark.parametrize("key", sorted(PINNED), ids=lambda k: "-".join(
    f"{x}" for x in k))
def test_column_plan_is_pinned(key):
    itemsize, p = key
    blocks, rows, threads, device, n_bytes = PINNED[key]
    assert alpha_column_plan(itemsize, p) == {
        "blocks": blocks, "rows": rows, "threads": threads,
        "device": device, "bytes": n_bytes}


@pytest.mark.parametrize("itemsize", [4, 8])
def test_column_groups_are_the_old_warps(itemsize):
    """The cost's groups at n_s = 1-500: the old loop's warps, min(n_s, 32)
    capped by the slabs its shared memory held, or past one slab by its
    device-slab kernel's registers (16 warps in float64, 20 in
    float32)."""
    regs = ALPHA_SLAB_LOOP_WARPS[itemsize]
    assert regs == {4: 20, 8: 16}[itemsize]
    for p in (65, 100, 166, 167, 168, 200, 238, 240, 452, 460, 700):
        slab = itemsize * (p * p + 6 * p)
        for n_s in range(1, 501):
            fit = min(n_s, 32, LIMIT // slab)
            want = fit if fit >= 1 else min(n_s, regs)
            got = alpha_column_groups(itemsize, p, n_s)
            assert got == want
            assert got == (glue_smem(itemsize, p, n_s)[0]
                           or min(n_s, regs))


@pytest.mark.parametrize("p", [453, 460, 624, 625, 905, 2000, 4115])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_column_groups_hold_past_the_old_edge(itemsize, p):
    """Past the old edge of 8 blocks (p = 453 in float64, 651 in float32),
    where the one-block loop kept its slabs in device memory, the column
    blocks and the device rows sum the columns in that loop's warps:
    min(n_s, 16) in float64, min(n_s, 20) in float32 (its kernels'
    registers, cudaFuncGetAttributes on an H100)."""
    cap = {8: 16, 4: 20}[itemsize]
    for n_s in (1, 10, 16, 17, 20, 21, 32, 100, 500):
        assert alpha_column_groups(itemsize, p, n_s) == min(n_s, cap)


# ------------------------------------------------- the step's order
def _row_dot(G, a, q):
    """(G a)_q summed over r in index order, as gram_row_dot and
    column_row_dot do: ``np.add.accumulate`` adds one term at a time, one
    rounding an addition (the kernels build without FMA contraction)."""
    terms = np.concatenate([np.zeros(1, a.dtype), G[q] * a])
    return np.add.accumulate(terms)[-1]


def _ranks(v):
    """Each row's stable descending rank by comparison with the column."""
    p = len(v)
    idx = np.arange(p)
    gt = v[None, :] > v[:, None]                  # [q, r]: v_r > v_q
    eq = (v[None, :] == v[:, None]) & (idx[None, :] < idx[:, None])
    return (gt | eq).sum(1)


def _theta_wide(v):
    """simplex_theta_wide: lane q ranks rows q, q + 32, ... and writes its
    value to srt[rank] (lane order, later rows last); lane 0 runs the
    cumulative sum in rank order with each rank's test and keeps the last
    rank that passes; a NaN in the column makes theta NaN."""
    p = len(v)
    dt = v.dtype.type
    rk = _ranks(v)
    srt = np.zeros(p, v.dtype)
    for k in range(-(-p // 32)):
        for lane in range(32):
            q = 32 * k + lane
            if q < p:
                srt[rk[q]] = v[q]
    csum, pi_rho, rho = dt(0), dt(0), 0
    for j in range(p):
        csum = csum + srt[j]
        pi = csum - dt(1)
        if j == 0:
            pi_rho = pi
        if (srt[j] - pi / dt(j + 1)) > 0:
            rho, pi_rho = j, pi
    theta = pi_rho / dt(rho + 1)
    return dt(np.nan) if np.isnan(v).any() else theta


def _theta_columns(v, plan):
    """The column blocks: block c holds rows [c R, c R + R), each row's
    rank from the gathered column and its value into that slot of the
    rank row (a NaN marks the step instead); one chain of adds for the
    prefix sums; every rank's test side by side, rho the largest rank
    that passes (0 when none does)."""
    p = len(v)
    dt = v.dtype.type
    rows = plan["rows"]
    srt = np.zeros(p, v.dtype)
    nan_step = False
    for c in range(plan["blocks"]):
        own = v[c * rows:c * rows + rows]
        gathered = np.concatenate([v[:c * rows], own, v[c * rows + rows:]])
        rk = _ranks(gathered)[c * rows:c * rows + len(own)]
        for t, x in enumerate(own):
            if x != x:
                nan_step = True
            else:
                srt[rk[t]] = x
    pi = np.add.accumulate(srt) - dt(1)
    tests = (srt - pi / np.arange(1, p + 1, dtype=v.dtype)) > 0
    passing = np.flatnonzero(tests)
    rho = int(passing.max()) if len(passing) else 0
    return dt(np.nan) if nan_step else pi[rho] / dt(rho + 1)


def _betas(a, l_prev, l_h, n_steps, dt):
    """The steps' momentum (the table's values, the Nesterov chain)."""
    out = []
    for _ in range(n_steps):
        a2 = (dt(1) + np.sqrt(dt(1) + dt(4) * a * a)) / dt(2)
        out.append(min((a - dt(1)) / a2, dt(0.9999) * np.sqrt(l_prev / l_h)))
        a, l_prev = a2, l_h
    return out


def _steps(G, b, al, ap, masked, l_h, betas, theta):
    """alpha FISTA steps with a given projection threshold ``theta(v)``:
    each row's v from its own sum over r in index order, -1e30 where
    masked, then v - theta clipped at 0."""
    p = len(al)
    dt = al.dtype.type
    for beta in betas:
        at = al + beta * (al - ap)
        v = np.array([at[q] + (b[q] - _row_dot(G, at, q)) / l_h
                      for q in range(p)], al.dtype)
        v[masked] = dt(-1e30)
        out = v - theta(v)
        ap, al = al, np.where(out < 0, dt(0), out)
    return al, ap


def _scenario(kind, p, dtype, seed):
    """G (p, p), b (p,), alpha, alpha_prev (p,), the masked rows and l_h
    of one column: "random"; "ties" (rows repeated across warps and
    blocks, so their v tie at every step); "masked" (rows masked, their v
    tied at -1e30); "nan" (an entry of G NaN)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(3 * p, p))
    G = X.T @ X / p
    b = rng.uniform(size=p) * G.sum(1)
    masked = np.zeros(p, bool)
    if kind == "ties":
        for src, dst in ((3, 40), (3, p - 1), (70, 71), (70, p // 2 + 5)):
            G[dst], b[dst] = G[src], b[src]
            G[:, dst] = G[:, src]
    elif kind == "masked":
        masked[[2, 33, 64, p - 1]] = True
    elif kind == "nan":
        G[7, 11] = G[11, 7] = np.nan
    al = rng.dirichlet(np.ones(p))
    ap = rng.dirichlet(np.ones(p))
    if kind == "ties":
        al[[40, p - 1]] = al[3]
        al[[71, p // 2 + 5]] = al[70]
        ap[[40, p - 1]] = ap[3]
        ap[[71, p // 2 + 5]] = ap[70]
    l_h = 1.1 * np.trace(G)
    return (G.astype(dtype), b.astype(dtype), al.astype(dtype),
            ap.astype(dtype), masked, dtype(l_h))


@pytest.mark.parametrize("args,groups", [
    ((8, 100, 10), 2), ((4, 100, 10), 5), ((8, 65, 10), 6),
    ((4, 65, 100), 12), ((8, 167, 100), 1), ((8, 168, 100), 16),
    ((8, 200, 10), 10), ((8, 200, 100), 16), ((4, 238, 100), 20),
    ((4, 237, 100), 1), ((8, 100, 1), 1)])
def test_column_groups_are_pinned(args, groups):
    assert alpha_column_groups(*args) == groups


# p -> the plan's blocks (float32, float64): one block at p = 100;
# K9's first cluster of two in float64 at p = 167 (one block in float32)
# and in float32 at p = 238 (three blocks in float64); clusters at 300
STEP_ORDER_BLOCKS = {100: (1, 1), 167: (1, 2), 238: (2, 3), 300: (2, 4)}


@pytest.mark.parametrize("kind", ["random", "ties", "masked", "nan"])
@pytest.mark.parametrize("p", [100, 167, 238, 300])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_column_step_order_is_the_wide_loops(kind, p, dtype):
    """20 steps, alpha and alpha_prev bit for bit, over the plan's blocks
    (STEP_ORDER_BLOCKS; p = 167 and 238 are K9's shapes on the card, whose
    column blocks run this same step)."""
    plan = alpha_column_plan(np.dtype(dtype).itemsize, p)
    assert plan["blocks"] == STEP_ORDER_BLOCKS[p][dtype == np.float64]
    G, b, al, ap, masked, l_h = _scenario(kind, p, dtype, seed=p + len(kind))
    dt = np.dtype(dtype).type
    betas = _betas(dt(1.8), dt(1.05) * l_h, l_h, 20, dt)
    wide = _steps(G, b, al, ap, masked, l_h, betas, _theta_wide)
    cols = _steps(G, b, al, ap, masked, l_h, betas,
                  lambda v: _theta_columns(v, plan))
    for x, y in zip(wide, cols):
        assert x.tobytes() == y.tobytes()
    if kind == "nan":                # the whole column is NaN
        assert np.isnan(wide[0]).all()
    elif kind == "masked":
        assert (wide[0][masked] == 0).all()
        assert abs(float(wide[0].sum()) - 1) < 1e-5
    else:
        assert np.isfinite(wide[0]).all()


@pytest.mark.parametrize("kind", ["zeros", "ties", "nan", "nans"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_column_projection_is_the_wide_loops(kind, dtype):
    """One projection threshold on constructed columns at p = 300 over 2
    or 4 blocks: a -0/+0 tie among the largest values (the rank keeps
    index order, the sign goes with its row), values tied across blocks,
    one NaN and several NaNs (theta NaN)."""
    p = 300
    plan = alpha_column_plan(np.dtype(dtype).itemsize, p)
    rng = np.random.default_rng(len(kind))
    v = (rng.uniform(-0.5, 0.02, size=p)).astype(dtype)
    if kind == "zeros":
        v[[5, 150, 299]] = [-0.0, 0.0, -0.0]
        v[v > 0] = -0.25
    elif kind == "ties":
        v[[1, 64, 120, 250]] = v.max()
        v[[2, 200]] = v[3]
    elif kind == "nan":
        v[180] = np.nan
    else:
        v[[0, 150, 299]] = np.nan
    wide, cols = _theta_wide(v), _theta_columns(v, plan)
    assert np.asarray(wide).tobytes() == np.asarray(cols).tobytes() or (
        np.isnan(wide) and np.isnan(cols))
    assert np.isnan(wide) == kind.startswith("nan")


# ------------------------------------------------------ K2, K5 vs JAX
N = 256
STEPS = 10
TOL = dict(rtol=0, atol=1e-12)


def _blocks(n_ct, n_u, n_b, n_s, seed, weighted=False):
    """Known blocks (shared, or with ``weighted`` one per member from its
    own row multiplicities) and n_b members' new-u blocks (numpy float64)
    at p = n_ct + n_u rows, the members' alpha and alpha_prev, and each
    member's ||Rt||^2 and dmax^2."""
    rng = np.random.default_rng(seed)
    p = n_ct + n_u
    R = rng.uniform(size=(N, p))
    d = rng.poisson(50, size=(N, n_s)) + 1.0
    y = np.clip(R @ rng.dirichlet(np.ones(p), size=n_s).T
                + 0.01 * rng.normal(size=(N, n_s)), 0, 1)
    Rt = R[:, :n_ct]
    if weighted:
        w = rng.multinomial(N, np.ones(N) / N, size=n_b).astype(float)
        known = [j_known_grams(jnp.asarray(Rt),
                               jnp.asarray(d * w[k][:, None]),
                               jnp.asarray(y)) for k in range(n_b)]
        gtt, bt, ydy = (np.stack([np.asarray(x[i]) for x in known])
                        for i in range(3))
        dmax2 = np.array([float((d * (w[k][:, None] > 0)).max()) ** 2
                          for k in range(n_b)])
        rt_sq = w @ np.sum(Rt * Rt, axis=1)
    else:
        gtt, bt, ydy = (np.asarray(x) for x in j_known_grams(
            jnp.asarray(Rt), jnp.asarray(d), jnp.asarray(y)))
        dmax2 = np.full(n_b, d.max() ** 2)
        rt_sq = np.full(n_b, np.sum(Rt * Rt))
    u = rng.uniform(size=(n_b, N, n_u))
    R_b = np.concatenate([np.broadcast_to(Rt, (n_b, N, n_ct)), u], axis=2)
    gu = np.einsum("is,biu,biq->bsuq", d, u, R_b)
    bu = np.einsum("biu,is->bus", u, d * y)
    usq = np.sum(u * u, axis=(1, 2))
    al = np.stack([rng.dirichlet(np.ones(p), size=n_s).T
                   for _ in range(2 * n_b)])
    return gtt, bt, gu, bu, usq, ydy, al[:n_b], al[n_b:], rt_sq, dmax2


def _t(x):
    return torch.tensor(np.ascontiguousarray(x))


@pytest.mark.parametrize("case", ["p100-masked", "p180", "p100-nan"])
def test_alpha_phase_full_columns_match_pallas(case):
    """K2's twin against the JAX kernel; "nan": G_s of column 1 holds a
    NaN pair, so its v does from the first step, and both make that
    column NaN in every row and leave the others finite."""
    n_ct, n_u, n_s = (96, 4, 4) if case.startswith("p100") else (176, 4, 3)
    p = n_ct + n_u
    gtt, bt, gu, bu, usq, ydy, al, ap, rt_sq, dmax2 = _blocks(
        n_ct, n_u, 1, n_s, seed=p + len(case))
    mask = None
    if case == "p100-masked":
        mask = np.ones(p)
        mask[[3, 50, p - 2]] = 0.0
    if case == "p100-nan":
        gu[0, 1, n_u - 1, 0] = np.nan             # G_1[p - 1, 0] and [0, p - 1]
    a, l_h_prev = 2.3, 1.1 * (rt_sq[0] + usq[0]) * dmax2[0]
    j = jnp.asarray
    kw = {} if mask is None else {"row_mask": j(mask)}
    al_w, ap_w, _, _, lw_w, cost_w = (np.asarray(x) for x in j_k2(
        j(gtt), j(bt), j(gu[0]), j(bu[0]), j(usq[0]), j(ydy), j(al[0]),
        j(ap[0]), j(a), j(l_h_prev), rt_sq[0], dmax2[0], STEPS, n_u, **kw))
    scal = torch.zeros(N_SCAL, dtype=torch.float64)
    scal[A_ALPHA], scal[L_H_PREV] = a, l_h_prev
    scal[RT_SQ], scal[DMAX2] = rt_sq[0], dmax2[0]
    alpha, alpha_prev = _t(al[0]), _t(ap[0])
    cuda_small.alpha_phase_full(
        _t(gtt), _t(bt), _t(gu[0]), _t(bu[0]), _t(usq[0]), _t(ydy), alpha,
        alpha_prev, scal, STEPS, n_u, None if mask is None else _t(mask))
    assert cuda_small.alpha_phase_full.launches == 0
    if case == "p100-nan":
        nan = np.isnan(al_w)
        assert nan[:, 1].all() and not nan[:, [0, 2, 3]].any()
        np.testing.assert_array_equal(np.isnan(alpha.numpy()), nan)
        np.testing.assert_array_equal(np.isnan(alpha_prev.numpy()),
                                      np.isnan(ap_w))
        keep = [0, 2, 3]
        np.testing.assert_allclose(alpha.numpy()[:, keep], al_w[:, keep],
                                   **TOL)
        assert np.isnan(float(scal[COST])) and np.isnan(float(cost_w))
        return
    np.testing.assert_allclose(alpha.numpy(), al_w, **TOL)
    np.testing.assert_allclose(alpha_prev.numpy(), ap_w, **TOL)
    if mask is not None:
        np.testing.assert_array_equal(alpha.numpy()[mask == 0], 0.0)
    np.testing.assert_allclose(float(scal[L_W]), float(lw_w), rtol=1e-10)
    scale = float(np.sum(ydy))
    np.testing.assert_allclose(float(scal[COST]) / scale,
                               float(cost_w) / scale, **TOL)


@pytest.mark.parametrize("n_ct,n_u,n_s,weighted",
                         [(96, 4, 2, False), (176, 4, 2, True)],
                         ids=["p100-shared", "p180-per-member"])
def test_alpha_phase_full_multi_columns_match_pallas(n_ct, n_u, n_s,
                                                     weighted):
    """K5, two members, the first inactive (left exactly as it was), with
    the known blocks shared (p = 100) or one per member (p = 180)."""
    active = np.array([0.0, 1.0])
    n_b, act = len(active), active > 0
    gtt, bt, gu, bu, usq, ydy, al, ap, rt_sq, dmax2 = _blocks(
        n_ct, n_u, n_b, n_s, seed=n_ct + n_s + 5, weighted=weighted)
    a = np.linspace(1.5, 2.5, n_b)
    l_h_prev = 1.1 * (rt_sq + usq) * dmax2
    j = jnp.asarray
    al_w, ap_w, _, _, lw_w, cost_w = (np.asarray(x) for x in j_k5(
        j(gtt), j(bt), j(gu), j(bu), j(usq), j(ydy), j(al), j(ap), j(a),
        j(l_h_prev), j(rt_sq), j(dmax2), STEPS, n_u))
    scal = np.zeros((n_b, N_SCAL_MULTI))
    scal[:, A_ALPHA], scal[:, L_H_PREV] = a, l_h_prev
    scal[:, RT_SQ], scal[:, DMAX2], scal[:, ACTIVE] = rt_sq, dmax2, active
    scal_t, alpha, alpha_prev = _t(scal), _t(al), _t(ap)
    cuda_small.alpha_phase_full_multi(_t(gtt), _t(bt), _t(gu), _t(bu),
                                      _t(usq), _t(ydy), alpha, alpha_prev,
                                      scal_t, STEPS, n_u)
    np.testing.assert_allclose(alpha[act].numpy(), al_w[act], **TOL)
    np.testing.assert_allclose(alpha_prev[act].numpy(), ap_w[act], **TOL)
    np.testing.assert_array_equal(alpha[~act].numpy(), al[~act])
    np.testing.assert_array_equal(alpha_prev[~act].numpy(), ap[~act])
    np.testing.assert_array_equal(scal_t[~act].numpy(), scal[~act])
    np.testing.assert_allclose(scal_t[act, L_W].numpy(), lw_w[act],
                               rtol=1e-10)
    scale = np.sum(ydy, axis=-1) * np.ones(n_b)
    np.testing.assert_allclose(scal_t[act, COST].numpy() / scale[act],
                               cost_w[act] / scale[act], **TOL)
    assert cuda_small.alpha_phase_full_multi.launches == 0
