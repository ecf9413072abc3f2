"""K3's and K6's column-block form (p > 64 rows): its plan, the order of
its step and of its cost, and the twins it is held to on the card
against the JAX package's kernels.

- The plan (``cuda_small.fw_column_plan``; the kernels'
  ``dm_fw_column_plan``, which ``chip_smoke.phase_layouts`` holds it to
  on the card): over p = 65-700 in both dtypes, at most 16 blocks a
  column or the device rows, a block's bytes under the card's limit, every row
  owned by one thread of one block; a few shapes pinned to hand-computed
  numbers. The cost's groups (``fw_column_groups``) are the warps of the
  one-block wide loop the form replaced.
- A numpy transcription of the column blocks' step: rows dealt over C
  blocks of R threads, each row's gradient summed over r in index order,
  each warp's minima by butterfly and first rows by ballot, the warps
  folded in block order. Over 500 steps it picks the vertices, and so
  reaches the alpha, of the one-warp wide loop (lane q over rows q,
  q + 32, ...) bit for bit, in float32 and float64, with forced ties, a
  -0/+0 tie and a NaN gradient row.
- The cost epilogue: the columns summed in groups of the old loop's
  warps equal ``block_cost``'s order bit for bit.
- K3's and K6's twins (``fw_phase_full`` and ``fw_phase_full_multi`` on
  CPU tensors) against the JAX functions (Pallas in interpret mode) at
  p = 100 and 180 rows, float64, 10 steps, K6 with an inactive member,
  with shared and with per-member known blocks.

Tolerances: float64 1e-12 absolute on alpha, 1e-10 on the cost relative
to sum(ydy), 1e-10 relative on l_w (the two sides sum in different
orders). The CUDA kernels have no CPU mode; ``chip_smoke.py``
(``phase_wide_glue``, ``phase_global_kernels``) holds them to these same
twins on the card, and ``save_outputs(..., "columns")`` to the kernels
they replaced, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demethify_tpu.ops.gram import known_block_grams as j_known_grams
from demethify_tpu.ops.pallas_small import fw_phase_full as j_k3
from demethify_tpu.ops.pallas_small import fw_phase_full_multi as j_k6
from demethify_tpu_torch.ops import cuda_small
from demethify_tpu_torch.ops.cuda_kernels import (
    ACTIVE,
    COST,
    DMAX2,
    L_W,
    N_SCAL,
    N_SCAL_MULTI,
    SMEM_LIMIT,
)
from demethify_tpu_torch.ops.cuda_small import (
    MAX_COLUMN_BLOCKS,
    fw_column_groups,
    fw_column_plan,
    column_work,
    glue_smem,
)

LIMIT = SMEM_LIMIT - 1024
THREADS = 256                    # the kernel's launch bound


# ------------------------------------------------------------------ plan
def _owned(plan, p):
    """The rows each block of a column owns."""
    rows = plan["rows"]
    return [range(c * rows, min(c * rows + rows, p))
            for c in range(plan["blocks"])]


@pytest.mark.parametrize("itemsize", [4, 8])
def test_column_plan_covers_every_shape(itemsize):
    """p = 65-700: the fewest blocks (at most 16) whose shared memory holds
    the column, each owning a non-empty run of rows, every row owned once;
    past 16 blocks the device rows (16 blocks, G_s's rows in device
    memory, alpha and the rows of R values in shared memory), whose work
    buffer the wrapper sizes."""
    for p in range(65, 701):
        plan = fw_column_plan(itemsize, p)
        c = plan["blocks"]
        assert 1 <= c <= MAX_COLUMN_BLOCKS
        rows = -(-p // c)
        assert plan["rows"] == rows
        assert plan["threads"] == 32 * -(-rows // 32) <= THREADS
        if plan["device"]:
            assert c == MAX_COLUMN_BLOCKS and plan["device"] == 1
            assert itemsize * (rows * p + p + 2 * rows) > LIMIT
            assert plan["bytes"] == itemsize * (p + 2 * rows)
            for n_s in (1, 10, 32, 500):
                assert column_work("fw", itemsize, p, n_s) == (
                    n_s * c * rows * p)
            continue
        assert column_work("fw", itemsize, p, 10) == 0
        assert plan["bytes"] == itemsize * (rows * p + p + 2 * rows) <= LIMIT
        if c > 1:
            fewer = -(-p // (c - 1))
            assert itemsize * (fewer * p + p + 2 * fewer) > LIMIT
        owned = _owned(plan, p)
        assert all(len(r) >= 1 for r in owned)
        assert [q for r in owned for q in r] == list(range(p))


# (itemsize, p) -> (blocks, rows, threads, device, bytes), worked out by
# hand: bytes = itemsize (R p + p + 2 R), R = ceil(p / C), C the fewest
# blocks under 232,448 - 1,024 = 231,424 bytes, at most 16; past 16 the
# device rows (device 1: bytes = itemsize (p + 2 R); device 2 where those
# pass the limit less 1 KB more, 230,400 bytes: bytes 0), threads R
# rounded up to warps, at most 1024
PINNED = {
    (8, 65): (1, 65, 96, 0, 35_360),          # 8 (4,225 + 65 + 130)
    (8, 100): (1, 100, 128, 0, 82_400),       # 8 (10,000 + 100 + 200)
    (8, 167): (1, 167, 192, 0, 227_120),      # 8 (27,889 + 167 + 334)
    (8, 168): (1, 168, 192, 0, 229_824),      # 8 (28,224 + 168 + 336)
    (8, 200): (2, 100, 128, 0, 163_200),      # one block: 8 x 40,600 > limit
    (8, 238): (2, 119, 128, 0, 230_384),      # 8 (28,322 + 238 + 238)
    (8, 480): (9, 54, 64, 0, 212_064),        # 8 blocks: 8 x 29,400 > limit
    (8, 670): (16, 42, 64, 0, 231_152),       # 8 (28,140 + 670 + 84)
    (8, 671): (16, 42, 64, 1, 6_040),         # 8 (671 + 84)
    (8, 25600): (16, 1600, 1024, 1, 230_400),  # 8 (25,600 + 3,200)
    (8, 25601): (16, 1601, 1024, 2, 0),       # 8 (25,601 + 3,202) > 230,400
    (4, 65): (1, 65, 96, 0, 17_680),
    (4, 100): (1, 100, 128, 0, 41_200),
    (4, 167): (1, 167, 192, 0, 113_560),
    (4, 168): (1, 168, 192, 0, 114_912),
    (4, 200): (1, 200, 224, 0, 162_400),      # 4 (40,000 + 200 + 400)
    (4, 238): (1, 238, 256, 0, 229_432),      # 4 (56,644 + 238 + 476)
    (4, 240): (2, 120, 128, 0, 117_120),      # one block: 4 x 58,320 > limit
    (4, 480): (5, 96, 96, 0, 187_008),        # 4 blocks: 4 x 58,320 > limit
    (4, 946): (16, 60, 64, 0, 231_304),       # 4 (56,760 + 946 + 120)
    (4, 947): (16, 60, 64, 1, 4_268),         # 4 (947 + 120)
    (4, 16484): (16, 1031, 1024, 1, 74_184),  # 4 (16,484 + 2,062)
}


@pytest.mark.parametrize("key", sorted(PINNED), ids=lambda k: "-".join(
    f"{x}" for x in k))
def test_column_plan_is_pinned(key):
    itemsize, p = key
    blocks, rows, threads, device, n_bytes = PINNED[key]
    assert fw_column_plan(itemsize, p) == {
        "blocks": blocks, "rows": rows, "threads": threads,
        "device": device, "bytes": n_bytes}


@pytest.mark.parametrize("itemsize", [4, 8])
def test_column_groups_are_the_old_warps(itemsize):
    """The cost's groups at n_s = 1-500: the old loop's warps, min(n_s, 32)
    capped by the slabs its shared memory held, or past one slab by its
    device-slab kernel's registers (28 warps in float64, 32 in float32)."""
    regs = {4: 32, 8: 28}[itemsize]
    for p in (65, 100, 167, 168, 200, 238, 240, 480, 700):
        slab = itemsize * (p * p + 6 * p)
        for n_s in range(1, 501):
            fit = min(n_s, 32, LIMIT // slab)
            want = fit if fit >= 1 else min(n_s, regs)
            got = fw_column_groups(itemsize, p, n_s)
            assert got == want
            assert got == (glue_smem(itemsize, p, n_s)[0] or min(n_s, regs))


@pytest.mark.parametrize("p", [473, 480, 490, 670, 671, 947, 2000, 25601])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_column_groups_hold_past_the_old_edge(itemsize, p):
    """Past the old edge of 8 blocks (p = 473 in float64, 673 in float32),
    where the one-block loop kept its slabs in device memory, the column
    blocks and the device rows sum the columns in that loop's warps:
    min(n_s, 28) in float64, min(n_s, 32) in float32, its kernels'
    registers' cap (cudaFuncGetAttributes on an H100)."""
    cap = {8: 28, 4: 32}[itemsize]
    for n_s in (1, 10, 27, 28, 29, 32, 33, 100, 500):
        assert fw_column_groups(itemsize, p, n_s) == min(n_s, cap)


@pytest.mark.parametrize("args,groups", [
    ((8, 100, 10), 2), ((4, 100, 10), 5), ((8, 65, 10), 6),
    ((4, 65, 10), 10), ((8, 200, 10), 10), ((8, 168, 100), 28),
    ((8, 200, 100), 28), ((4, 240, 100), 32), ((8, 100, 1), 1)])
def test_column_groups_are_pinned(args, groups):
    assert fw_column_groups(*args) == groups


# ------------------------------------------------- the step's order
BIG = 3.4e38                    # the TPU kernel's block mask


def _min_nan(x, y):
    """jnp.minimum elementwise: x where x < y or x is NaN, else y."""
    return np.where((x < y) | (x != x), x, y)


def _butterfly(x):
    """warp_min over the last axis (32 lanes): xor shuffles 16, ..., 1."""
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        x = _min_nan(x, x[..., lanes ^ off])
    return x


def _wide_argmin(g, p):
    """The one-warp wide loop: lane l takes rows l, l + 32, ... (its
    minimum from +inf), the butterfly, then the first row per lane whose
    value equals the minimum, the smallest over the lanes (p when none)."""
    k = -(-p // 32)
    vals = np.full(32 * k, np.inf, g.dtype)
    vals[:p] = g
    vals = vals.reshape(k, 32)
    m = np.full(32, np.inf, g.dtype)
    for j in range(k):
        m = _min_nan(m, vals[j])
    m = _butterfly(m)
    rows = np.arange(32 * k).reshape(k, 32)
    hit = (vals == m) & (rows < p)
    first = np.where(hit.any(0), np.where(hit, rows, p).min(0), p)
    return m[0], int(first.min())


def _column_argmin(g, p, plan):
    """The column blocks: thread t of block c holds row c R + t (+inf
    past the block's rows); each warp's butterfly and the lowest lane
    whose row holds its minimum; the warps folded in block order (a NaN
    stays, a smaller minimum replaces, an equal one keeps the smaller
    first row)."""
    rows, threads = plan["rows"], plan["threads"]
    best_m, best_i = np.array(np.inf, g.dtype), p
    for c in range(plan["blocks"]):
        vals = np.full(threads, np.inf, g.dtype)
        own = min(rows, p - c * rows)
        vals[:own] = g[c * rows:c * rows + own]
        for w in range(threads // 32):
            lane_vals = vals[32 * w:32 * w + 32]
            m = _butterfly(lane_vals)[0]
            hit = (lane_vals == m) & (np.arange(32) + 32 * w < own)
            i = c * rows + 32 * w + int(np.argmax(hit)) if hit.any() else p
            if best_m != best_m:
                continue
            if m != m or m < best_m:
                best_m, best_i = m, i
            elif m == best_m and i < best_i:
                best_i = i
    return best_m, best_i


def _gradient(G, b, a):
    """-(b - G a), each row's sum over r in index order from 0, one
    rounding an operation (the kernels build without FMA contraction):
    ``np.add.accumulate`` adds along the row one term at a time."""
    terms = np.concatenate([np.zeros((len(b), 1), b.dtype), G * a], axis=1)
    return -(b - np.add.accumulate(terms, axis=1)[:, -1])


def _fw_run(G, b, a, n_ct, pur, steps, argmin):
    """Frank-Wolfe steps with a given block argmin; the vertex indices of
    each step and the final alpha."""
    p = len(a)
    known = np.arange(p) < n_ct
    dt = a.dtype.type
    picks = []
    for k in range(steps):
        grad = _gradient(G, b, a)
        i1 = argmin(np.where(known, grad, dt(BIG)))[1]
        i2 = argmin(np.where(known, dt(BIG), grad))[1]
        picks.append((i1, i2))
        gamma = dt(2) / (dt(k) + dt(2))
        e1 = (np.arange(p) == i1).astype(a.dtype)
        e2 = (np.arange(p) == i2).astype(a.dtype)
        vert = e1 * dt(pur) + e2 * (dt(1) - dt(pur))
        a = (dt(1) - gamma) * a + gamma * vert
    return picks, a


def _scenario(kind, p, n_ct, dtype, seed):
    """G (p, p), b (p,), alpha (p,) of one column: "random"; "ties" (rows
    repeated across warps and blocks); "zeros" (the known rows' gradients
    are >= 0 with -0 and +0 minima); "nan" (a known row's gradient NaN)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(3 * p, p))
    G = X.T @ X / p
    b = rng.uniform(size=p) * G.sum(1)
    if kind == "ties":              # the blocks' smallest gradients
        b[3] = b[n_ct + 1] = 3 * b.max()
        for src, dst in ((3, 40), (3, n_ct - 1), (n_ct + 1, p - 1),
                         (n_ct + 1, n_ct + 33)):
            G[dst], b[dst] = G[src], b[src]
    elif kind == "zeros":
        b[:n_ct] = 0.0
        for q, sign in ((5, 1.0), (37, -1.0), (n_ct - 2, 1.0)):
            G[q], b[q] = 0.0, sign * 0.0
    elif kind == "nan":
        G[7, 11] = np.nan
    a = rng.dirichlet(np.ones(p))
    a[:n_ct] *= 0.6 / a[:n_ct].sum()
    a[n_ct:] *= 0.4 / a[n_ct:].sum()
    return G.astype(dtype), b.astype(dtype), a.astype(dtype)


# p -> the plan's blocks (float32, float64): one block at p = 100;
# K10's first cluster of two in float64 at p = 169 (one block in float32)
# and in float32 at p = 240 (three blocks in float64); clusters at 300
STEP_ORDER_BLOCKS = {100: (1, 1), 169: (1, 2), 240: (2, 3), 300: (2, 4)}


@pytest.mark.parametrize("kind", ["random", "ties", "zeros", "nan"])
@pytest.mark.parametrize("p", [100, 169, 240, 300])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_column_step_order_is_the_wide_loops(kind, p, dtype):
    """500 steps: the same vertex pair at every step, so alpha bit for
    bit, over the plan's blocks (STEP_ORDER_BLOCKS; p = 169 and 240 are
    K10's shapes on the card, whose column blocks run this same step)."""
    n_ct = p // 2
    plan = fw_column_plan(np.dtype(dtype).itemsize, p)
    assert plan["blocks"] == STEP_ORDER_BLOCKS[p][dtype == np.float64]
    G, b, a = _scenario(kind, p, n_ct, dtype, seed=p + len(kind))
    g0 = _gradient(G, b, a)
    if kind == "nan":
        assert np.isnan(g0[7])
    if kind == "zeros":
        assert np.signbit(g0[5]) and not np.signbit(g0[37])
    wide_picks, wide_a = _fw_run(G, b, a, n_ct, 0.6, 500,
                                 lambda g: _wide_argmin(g, p))
    col_picks, col_a = _fw_run(G, b, a, n_ct, 0.6, 500,
                               lambda g: _column_argmin(g, p, plan))
    assert col_picks == wide_picks
    assert col_a.tobytes() == wide_a.tobytes()
    if kind == "nan":              # a NaN minimum matches no known row
        assert all(i1 == p for i1, _ in wide_picks)
    if kind == "zeros":
        assert wide_picks[0][0] == 5


# ------------------------------------------------ the cost's order
def _lane_tree(terms):
    """One column's terms summed as add_column_sums_wide does: lane l over
    rows l, l + 32, ... in order from 0, then the shuffle-down tree
    (lanes past 31 - off add their own value), lane 0's sum."""
    lanes = np.zeros(32, terms.dtype)
    for q in range(len(terms)):
        lanes[q % 32] = lanes[q % 32] + terms[q]
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + np.concatenate([lanes[off:], lanes[32 - off:]])
    return lanes[0]


def _column_terms(rng, p, n_u, dtype):
    b, a, ga = (rng.uniform(size=p).astype(dtype) for _ in range(3))
    lw = np.where(np.arange(p) >= p - n_u, a * a, dtype(0))
    return _lane_tree(b * a), _lane_tree(a * (b - ga)), _lane_tree(lw)


@pytest.mark.parametrize("n_s", [1, 10, 33, 100])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cost_groups_keep_block_costs_order(n_s, dtype):
    """The old block of n_warps warps (warp w summing columns w,
    w + n_warps, ..., then block_cost over the warps in order) against
    column_cost's groups of the same count, for every count to
    min(n_s, 32): the same cost and l_w bits."""
    rng = np.random.default_rng(n_s)
    p, n_u = 120, 4
    cols = [_column_terms(rng, p, n_u, dtype) for _ in range(n_s)]
    ydy = rng.uniform(size=n_s).astype(dtype)
    s_ydy = dtype(0)
    for v in ydy:
        s_ydy = s_ydy + v
    for n_warps in range(1, min(n_s, 32) + 1):
        # the old loop: each warp's running sums, then the warps in order
        warp_sums = np.zeros((n_warps, 3), dtype)
        for s in range(n_s):
            warp_sums[s % n_warps] = warp_sums[s % n_warps] + cols[s]
        old = np.zeros(3, dtype)
        for w in range(n_warps):
            old = old + warp_sums[w]
        # column_cost: column s into group s mod groups, each group in
        # column order, then the groups in order
        new = np.zeros(3, dtype)
        for w in range(n_warps):
            group = np.zeros(3, dtype)
            for s in range(w, n_s, n_warps):
                group = group + np.asarray(cols[s])
            new = new + group
        assert (s_ydy - old[0] - old[1]).tobytes() == (
            s_ydy - new[0] - new[1]).tobytes()
        assert old[2].tobytes() == new[2].tobytes()


# ------------------------------------------------------ K3, K6 vs JAX
N = 512


def _blocks(n_ct, n_u, n_b, n_s, seed, weighted=False):
    """Known blocks (shared, or with ``weighted`` one per member from its
    own row multiplicities) and n_b members' new-u blocks (numpy float64)
    at p = n_ct + n_u rows, the members' alpha at purity and dmax^2."""
    rng = np.random.default_rng(seed)
    p = n_ct + n_u
    R = rng.uniform(size=(N, p))
    alpha = rng.dirichlet(np.ones(p), size=n_s).T
    d = rng.poisson(50, size=(N, n_s)) + 1.0
    y = np.clip(R @ alpha + 0.01 * rng.normal(size=(N, n_s)), 0, 1)
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
    else:
        gtt, bt, ydy = (np.asarray(x) for x in j_known_grams(
            jnp.asarray(Rt), jnp.asarray(d), jnp.asarray(y)))
        dmax2 = np.full(n_b, d.max() ** 2)
    u = rng.uniform(size=(n_b, N, n_u))
    R_b = np.concatenate([np.broadcast_to(Rt, (n_b, N, n_ct)), u], axis=2)
    gu = np.einsum("is,biu,biq->bsuq", d, u, R_b)
    bu = np.einsum("biu,is->bus", u, d * y)
    purity = np.linspace(0.3, 0.9, n_s)
    alpha_b = np.stack([rng.dirichlet(np.ones(p), size=n_s).T
                        for _ in range(n_b)])
    alpha_b[:, :n_ct] *= purity / alpha_b[:, :n_ct].sum(1, keepdims=True)
    alpha_b[:, n_ct:] *= (1 - purity) / alpha_b[:, n_ct:].sum(
        1, keepdims=True)
    return gtt, bt, gu, bu, ydy, alpha_b, purity, dmax2


def _t(x):
    return torch.tensor(np.ascontiguousarray(x))


TOL64 = dict(rtol=0, atol=1e-10)
STEPS = 10


@pytest.mark.parametrize("n_ct,n_u,n_s", [(99, 1, 6), (176, 4, 5)],
                         ids=["p100", "p180"])
def test_fw_phase_full_columns_match_pallas(n_ct, n_u, n_s):
    gtt, bt, gu, bu, ydy, alpha_b, purity, dmax2 = _blocks(
        n_ct, n_u, 1, n_s, seed=n_ct + n_s)
    j = jnp.asarray
    al_w, lw_w, cost_w = (np.asarray(x) for x in j_k3(
        j(gtt), j(bt), j(gu[0]), j(bu[0]), j(ydy), j(alpha_b[0]),
        j(purity), dmax2[0], STEPS, n_u))
    scal = torch.zeros(N_SCAL, dtype=torch.float64)
    scal[DMAX2] = dmax2[0]
    al = _t(alpha_b[0])
    cuda_small.fw_phase_full(_t(gtt), _t(bt), _t(gu[0]), _t(bu[0]), _t(ydy),
                             al, _t(purity), scal, STEPS, n_u)
    np.testing.assert_allclose(al.numpy(), al_w, rtol=0, atol=1e-12)
    np.testing.assert_allclose(float(scal[L_W]), float(lw_w), rtol=1e-10)
    scale = float(np.sum(ydy))
    np.testing.assert_allclose(float(scal[COST]) / scale,
                               float(cost_w) / scale, **TOL64)
    assert cuda_small.fw_phase_full.launches == 0


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["shared", "per-member"])
@pytest.mark.parametrize("n_ct,n_u,n_s", [(99, 1, 3), (176, 4, 3)],
                         ids=["p100", "p180"])
def test_fw_phase_full_multi_columns_match_pallas(n_ct, n_u, n_s, weighted):
    """K6, three members, the second inactive (left exactly as it was),
    with the known blocks shared or one per member."""
    active = np.array([1.0, 0.0, 1.0])
    n_b, act = len(active), active > 0
    gtt, bt, gu, bu, ydy, alpha_b, purity, dmax2 = _blocks(
        n_ct, n_u, n_b, n_s, seed=n_ct + n_s + 3, weighted=weighted)
    j = jnp.asarray
    fw_w, lw_w, cost_w = (np.asarray(x) for x in j_k6(
        j(gtt), j(bt), j(gu), j(bu), j(ydy), j(alpha_b), j(purity),
        j(dmax2), STEPS, n_u))
    scal = np.zeros((n_b, N_SCAL_MULTI))
    scal[:, DMAX2], scal[:, ACTIVE] = dmax2, active
    scal_t, al = _t(scal), _t(alpha_b)
    cuda_small.fw_phase_full_multi(_t(gtt), _t(bt), _t(gu), _t(bu), _t(ydy),
                                   al, _t(purity), scal_t, STEPS, n_u)
    np.testing.assert_allclose(al[act].numpy(), fw_w[act], rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(al[~act].numpy(), alpha_b[~act])
    np.testing.assert_array_equal(scal_t[~act].numpy(), scal[~act])
    np.testing.assert_allclose(scal_t[act, L_W].numpy(), lw_w[act],
                               rtol=1e-10)
    scale = np.sum(ydy, axis=-1) * np.ones(n_b)
    np.testing.assert_allclose(scal_t[act, COST].numpy() / scale[act],
                               cost_w[act] / scale[act], **TOL64)
    assert cuda_small.fw_phase_full_multi.launches == 0
