"""K1's and K4's global layout after its redesign: Rt streams through
shared memory in a ring of row chunks (``cuda_kernels.global_plan``,
``csrc/u_phase_common.cuh``: ``gram_partials_ring``; K4's
``group_grams_ring``) instead of being copied into a per-block device
buffer of [Rt | u] rows.

The kernels run only on the card, where ``chip_smoke.phase_global_kernels``
holds them to their twins and to the shared layouts bit for bit. Here:

- the plan over a grid of shapes that reach the global layout (p 162-420,
  n_s 10-500, n_u 1-25, float32, float64 and bf16 data, K4 weighted or
  not, B 1-32): its bytes fit one block, its rows hold the Gram stage
  below the u rows and never put a u row over the vectors the steps
  leave u in; the layout the rule picks, the state region's rows and
  where it lives are the ones pinned below, worked out with the functions
  as they were before the redesign;
- a numpy transcription of the ring's Gram stage (the rows it stages,
  the tiles it deals, the entry each tile writes) writes every Gram entry
  once, with the bits of the un-chunked entry order, in float32 and
  float64;
- with a stand-in library, the launchers read the ring from the
  ``dm_global_plan`` export and allocate no row buffer.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_global_stream.py
"""

import ctypes

import numpy as np
import pytest

from demethify_tpu_torch.ops import cuda_kernels, cuda_multi
from demethify_tpu_torch.ops.cuda_kernels import (
    GRAM_TILE_Q,
    SITES_PER_BLOCK,
    SMEM_LIMIT,
    global_plan,
    gram_form,
    gram_tile_plan,
    state_in_device,
    state_rows,
    u_phase_layout,
    u_phase_smem,
)

LD = SITES_PER_BLOCK + 1
P = (162, 170, 200, 240, 300, 387, 420)
NU = (1, 2, 4, 8, 9, 12, 17, 25)
NS = (10, 32, 64, 100, 500)
MEMBERS = (1, 2, 3, 4, 8, 10, 16, 32)
# data dtype: (the state's itemsize, bf16_compute tried)
DATA = {"float32": (4, False), "float64": (8, False), "bfloat16": (4, True)}
CODE = {"r": "resident", "w": "wide", "g": "global"}

# The layout u_phase_layout picked before the redesign, one letter a case
# in the order of _cases (K1, then K4 unweighted and weighted in the gram
# form; r resident, w wide, g global)
LAYOUTS = {
    ('float32', 10): (
        'rrrrrrrrrrwwwwrrrrrrrrrrwwwrwwwwwwwwwrrrrrrrrrrrrrrrrrrrrrrr'
        'rrrrrrrrrrrrrrrrrrrrwwwwwwwwwwwwwwwggg'
    ),
    ('float32', 32): (
        'rrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrr'
        'rrrrrrrrwwwwrrrrrrrrrrrrwwwwwwgggggggggggggggggggggggggggggg'
        'gggggg'
    ),
    ('float32', 64): (
        'rrrrrrrrrrrrwwwwwwwwrrrrrrrrrrrrwwwwwwwwrrrrrrrrrrrrwwwwwwww'
        'wwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwgggggggggggggggggggg'
        'gggggggggggggggggggg'
    ),
    ('float32', 100): (
        'wwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwww'
        'wwwwwwwwwwwwwwwwwwwwwwwwgggwwwwwwwwwwwwwwwwwwwgggwgggggggggg'
        'gggggggggggggggggggggggggggggggggg'
    ),
    ('float32', 500): (
        'wwwwwwwwwwwwwwwwwwwwwgggwwwwwwwwwwwwwwwwwwwwwgggwwwwwwwwwwww'
        'wwwwwwwwwgggwwwwwwwwwwwwwwwwwwggggggwwwwwwwwwwwwwwwwwwgggggg'
        'gggggggggggggggggggggggggggggggggggggggggggggggg'
    ),
    ('float64', 10): (
        'rrrrrrrrrrwwwwrrrrrrrrrrwwwgwwwwwwwwwwgggggggggggggggggggggg'
        'gggggggggggggggggggggggggggggggggggggg'
    ),
    ('float64', 32): (
        'gggggggggggggggggggggggggggggggggggggggggggggggggggggggggggg'
        'gggggggggggggggggggggggggggggggggggggggggggggggggggggggggggg'
        'gggggg'
    ),
    ('float64', 64): (
        'gggggggggggggggggggggggggggggggggggggggggggggggggggggggggggg'
        'gggggggggggggggggggggggggggggggggggggggggggggggggggggggggggg'
        'gggggggggggggggggggg'
    ),
    ('float64', 100): (
        'gggggggggggggggggggggggggggggggggggggggggggggggggggggggggggg'
        'gggggggggggggggggggggggggggggggggggggggggggggggggggggggggggg'
        'gggggggggggggggggggggggggggggggggg'
    ),
    ('float64', 500): (
        'gggggggggggggggggggggggggggggggggggggggggggggggggggggggggggg'
        'gggggggggggggggggggggggggggggggggggggggggggggggggggggggggggg'
        'gggggggggggggggggggggggggggggggggggggggggggggggg'
    ),
    ('bfloat16', 10): (
        'rrrrrrrrrrwwwwrrrrrrrrrrwwwrwwwwwwwwwrrrrrrrrrrrrrrrrrrrrrrr'
        'rrrrrrrrrrrrrrrrrrrrwwwwwwwwwwwwwwwggg'
    ),
    ('bfloat16', 32): (
        'rrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrrr'
        'rrrrrrwrwwwwrrrrrrrrrrrrwwwwwwgggggggggggggggggggggggggggggg'
        'gggggg'
    ),
    ('bfloat16', 64): (
        'rrrrrrrrrrrrwwwwwwwwrrrrrrrrrrrrwwwwwwwwrrrrrrrrrrrrwwwwwwww'
        'wwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwgggggggggggggggggggg'
        'gggggggggggggggggggg'
    ),
    ('bfloat16', 100): (
        'wwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwwww'
        'wwwwwwwwwwwwwwwwwwwwwwwwgggwwwwwwwwwwwwwwwwwwwgggwgggggggggg'
        'gggggggggggggggggggggggggggggggggg'
    ),
    ('bfloat16', 500): (
        'wwwwwwwwwwwwwwwwwwwwwgggwwwwwwwwwwwwwwwwwwwwwgggwwwwwwwwwwww'
        'wwwwwwwwwgggwwwwwwwwwwwwwwwwwwggggggwwwwwwwwwwwwwwwwwwgggggg'
        'gggggggggggggggggggggggggggggggggggggggggggggggg'
    ),
}

# state_rows(n_s, n_u, direct) by n_s, over NU, before the redesign
STATE_ROWS = {
    10: (0, 0, 0, 0, 28, 34, 44, 60),
    32: (0, 0, 0, 0, 81, 56, 66, 82),
    64: (0, 0, 0, 0, 81, 126, 83, 107),
    100: (0, 0, 0, 0, 81, 126, 221, 107),
    500: (0, 0, 0, 0, 81, 126, 221, 425),
}

# state_in_device(itemsize, n_s, n_u, direct) for itemsize 4, 8 (outer),
# n_s in NS, n_u in NU (inner), before the redesign
IN_DEVICE = "00000000000000000000000000000000000000000000000000000000000000000000000000000001"


def _cases(n_s):
    """(p, n_u, kind) in the order of LAYOUTS' letters."""
    for p in P:
        for n_u in NU:
            yield p, n_u, "K1"
            if gram_form(n_u, n_s):
                yield p, n_u, "K4"
                yield p, n_u, "K4w"


def _check_plan(itemsize, n_s, n_ct, n_u, direct, um, members):
    """The plan's rows hold what the kernels put in them."""
    g = global_plan(itemsize, n_s, n_ct, n_u, direct, um, members)
    rows = g["rows"]
    assert itemsize * LD * rows <= SMEM_LIMIT
    assert 1 <= g["cs"] <= min(32, n_s)
    assert g["q"] % GRAM_TILE_Q == 0 and (g["q"] == 0) == (n_ct == 0)
    assert g["q"] <= -(-n_ct // GRAM_TILE_Q) * GRAM_TILE_Q
    assert g["depth"] == (0 if not n_ct else (1 if g["q"] >= n_ct else 2))
    # the Gram stage's rows below the u rows
    assert 2 * g["cs"] + g["depth"] * g["q"] + members * um <= rows
    in_dev = state_in_device(itemsize, n_s, n_u, direct)
    region = 0 if in_dev else state_rows(n_s, n_u, direct)
    if region:
        # no u row over the vectors u is read from; members but the last
        # past the region (and the direct form's residual rows)
        assert rows - members * um >= (2 if direct else 3) * n_u
        assert rows - (members - 1) * um >= region + (n_s if g["res"]
                                                      else 0)
    assert g["res"] == int(direct and not in_dev
                           and itemsize * LD * (region + n_s) <= SMEM_LIMIT)
    if in_dev:
        assert rows == 2 * min(32, n_s)
    # the register forms' known sums: n_s rows and kc rows of a1 below the
    # u rows, at most all of a1, at least one row
    if g["kc"]:
        assert n_u <= 8 and 1 <= g["kc"] <= n_ct
        assert n_s * LD + g["kc"] * n_s <= (rows - members * um) * LD
    return g


@pytest.mark.parametrize("n_s", NS)
@pytest.mark.parametrize("data", list(DATA))
def test_plan_over_the_grid(data, n_s):
    itemsize, bf16c = DATA[data]
    want = iter(LAYOUTS[(data, n_s)])
    for p, n_u, kind in _cases(n_s):
        n_ct = p - n_u
        direct = not gram_form(n_u, n_s)
        weighted = kind == "K4w"
        layout, smem = u_phase_layout(kind, itemsize, n_s, n_ct, n_u, direct,
                                      bf16c and kind == "K1",
                                      weighted=weighted)
        assert layout == CODE[next(want)], (p, n_u, kind)
        assert smem <= SMEM_LIMIT
        glob = u_phase_smem("global", itemsize, n_s, n_ct, n_u, direct,
                            bf16c and kind == "K1", weighted)
        assert glob <= SMEM_LIMIT
        if kind == "K1":
            for x in (False, True) if bf16c and not direct else (False,):
                _check_plan(itemsize, n_s, n_ct, n_u, direct,
                            n_u * (2 if x else 1), 1)
            continue
        um = n_u * (2 if weighted else 1)
        assert glob == itemsize * LD * _check_plan(
            itemsize, n_s, n_ct, n_u, False, um, 1)["rows"]
        for n_b in MEMBERS:
            plan = cuda_multi.k4_member_plan(itemsize, n_s, n_ct, n_u, n_b,
                                             weighted, "global")
            assert 1 <= plan["group"] <= n_b
            assert plan["smem"] <= SMEM_LIMIT
            assert plan["smem"] == cuda_multi.k4_smem(
                itemsize, n_s, n_ct, n_u, weighted, "global", plan["group"])
            _check_plan(itemsize, n_s, n_ct, n_u, False, um, plan["group"])
    assert next(want, None) is None
    for j, n_u in enumerate(NU):
        direct = not gram_form(n_u, n_s)
        assert state_rows(n_s, n_u, direct) == STATE_ROWS[n_s][j]
        for k, it in enumerate((4, 8)):
            bit = IN_DEVICE[(k * len(NS) + NS.index(n_s)) * len(NU) + j]
            assert state_in_device(it, n_s, n_u, direct) == (bit == "1")


# ---- the ring's Gram stage in numpy -------------------------------------


class Smem:
    """A block's shared memory as rows of 128 sites, each row written at
    most once a stage (a row read before it is written raises)."""

    def __init__(self, rows, dtype):
        self.a = np.full((rows, SITES_PER_BLOCK), np.nan, dtype)

    def put(self, row, values):
        assert 0 <= row < self.a.shape[0]
        self.a[row] = values

    def get(self, row):
        assert 0 <= row < self.a.shape[0]
        assert not np.isnan(self.a[row]).any(), f"row {row} not staged"
        return self.a[row]


def _sum(terms):
    """sum_j terms[j] in site order from 0 in the terms' dtype, for a
    stack of rows: the order of every kernel sum."""
    acc = np.zeros(terms.shape[:-1], terms.dtype)
    for j in range(terms.shape[-1]):
        acc = acc + terms[..., j]
    return acc


def _k1_reference(y, d, rt, u):
    """{entry index: value} of [gu (n_s, n_u, p) | b_u (n_u, n_s) | usq] in
    the entry form's order: (d_s u_v) [Rt | u]_q, u_v (d_s y_s), and
    u_v u_v over the sites, then the unknowns."""
    rext = np.concatenate([rt, u])
    gu = _sum((d[:, None, None] * u[None, :, None]) * rext[None, None])
    b_u = _sum(u[:, None] * (d * y)[None])
    usq = _sum((u * u).T.reshape(1, -1))[0]
    return dict(enumerate([*gu.ravel(), *b_u.ravel(), usq]))


def _k1_ring(y, d, rt, u, g):
    """gram_partials_ring transcribed: the entries it writes (index into
    [gu | b_u | usq] -> value), reading every operand from the rows it
    staged."""
    n_s, n_ct, nu = y.shape[0], rt.shape[0], u.shape[0]
    p = n_ct + nu
    rv = 1 if nu == 1 else 2
    rs = 4 // rv
    um = nu
    sm = Smem(g["rows"], u.dtype)
    s_u = g["rows"] - um
    for v in range(nu):
        sm.put(s_u + v, u[v])
    ring = 2 * g["cs"]
    assert ring + g["depth"] * g["q"] <= s_u
    out = {}

    def write(e, value):
        assert e not in out, f"entry {e} written twice"
        out[e] = value

    def tile(s0, v0, q0, right, nq, qo, c0, n_c):
        ds = np.stack([sm.get(g["cs"] + min(s0 + a, n_c - 1))
                       for a in range(rs)])
        uv = np.stack([sm.get(s_u + min(v0 + b, nu - 1)) for b in range(rv)])
        rq = np.stack([sm.get(right + min(q0 + c, nq - 1))
                       for c in range(GRAM_TILE_Q)])
        acc = _sum((ds[:, None, None] * uv[None, :, None]) * rq[None, None])
        for a in range(rs):
            for b in range(rv):
                for c in range(GRAM_TILE_Q):
                    s, v, q = s0 + a, v0 + b, q0 + c
                    if s < n_c and v < nu and q < nq:
                        write((c0 + s) * nu * p + v * p + qo + q, acc[a, b, c])

    n_rc = -(-n_ct // g["q"]) if g["q"] else 0
    tv, tqu = -(-nu // rv), -(-nu // GRAM_TILE_Q)
    for c0 in range(0, n_s, g["cs"]):
        c1 = min(c0 + g["cs"], n_s)
        n_c = c1 - c0
        ts = -(-n_c // rs)
        for s in range(n_c):
            sm.put(s, y[c0 + s])
            sm.put(g["cs"] + s, d[c0 + s])
        n_ut = ts * tv * tqu
        for k in range(n_ut + nu * n_c + (c1 == n_s)):
            if k < n_ut:
                qt, vt, st = k % tqu, (k // tqu) % tv, k // (tqu * tv)
                tile(st * rs, vt * rv, qt * GRAM_TILE_Q, s_u, nu, n_ct, c0,
                     n_c)
            elif k < n_ut + nu * n_c:
                v, s = (k - n_ut) // n_c, (k - n_ut) % n_c
                ds, ys = sm.get(g["cs"] + s), sm.get(s)
                write(n_s * nu * p + v * n_s + c0 + s,
                      _sum((sm.get(s_u + v) * (ds * ys))[None])[0])
            else:
                x = np.stack([sm.get(s_u + v) for v in range(nu)])
                write(n_s * nu * p + nu * n_s,
                      _sum((x * x).T.reshape(1, -1))[0])
        for rc in range(n_rc):
            r0 = rc * g["q"]
            nq = min(g["q"], n_ct - r0)
            slot = ring + (rc % 2) * g["q"]
            assert rc % 2 < g["depth"]
            for r in range(nq):
                sm.put(slot + r, rt[r0 + r])
            tq = -(-nq // GRAM_TILE_Q)
            for k in range(ts * tv * tq):
                qt, vt, st = k % tq, (k // tq) % tv, k // (tq * tv)
                tile(st * rs, vt * rv, qt * GRAM_TILE_Q, slot, nq, r0, c0,
                     n_c)
    return out


def _k4_reference(y, d, rt, u, x):
    """Member k's entries in the entry form's order, keyed (k, e): left
    rows x[k] (u, or weighted w u), right rows [Rt | u[k]]."""
    out = {}
    for k in range(u.shape[0]):
        rext = np.concatenate([rt, u[k]])
        gu = _sum((d[:, None, None] * x[k][None, :, None]) * rext[None, None])
        b_u = _sum(x[k][:, None] * (d * y)[None])
        usq = _sum((x[k] * u[k]).T.reshape(1, -1))[0]
        out.update({(k, e): v for e, v in
                    enumerate([*gu.ravel(), *b_u.ravel(), usq])})
    return out


def _k4_ring(y, d, rt, u, x, weighted, group, g):
    """group_grams_ring transcribed for gm = len(u) active members of a
    group of ``group``: member k's rows at rows - (k + 1) um (u, then
    weighted its w u rows), stride ms = -um, as the kernel stacks them."""
    gm, nu, _ = u.shape
    n_s, n_ct = y.shape[0], rt.shape[0]
    p = n_ct + nu
    um = nu * (2 if weighted else 1)
    n_e = n_s * nu * p + nu * n_s + 1
    e_bu = n_s * nu * p
    n_l = gm * nu
    ms = -um
    sm = Smem(g["rows"], u.dtype)
    s_u = g["rows"] - um
    s_x = s_u + (nu if weighted else 0)
    for k in range(gm):
        for v in range(nu):
            sm.put(s_u + k * ms + v, u[k, v])
            if weighted:
                sm.put(s_x + k * ms + v, x[k, v])
    assert 2 * g["cs"] + g["depth"] * g["q"] <= g["rows"] - group * um
    out = {}

    def write(k, e, value):
        assert 0 <= e < n_e and (k, e) not in out, (k, e)
        out[(k, e)] = value

    def xrow(l):                                  # GroupRows.x
        l = min(l, n_l - 1)
        return sm.get(s_x + (l // nu) * ms + l % nu)

    def drow(s, n_c):
        return sm.get(g["cs"] + min(s, n_c - 1))

    n_rc = -(-n_ct // g["q"]) if g["q"] else 0
    tl, tp, tb = -(-n_l // 2), -(-(n_l * nu) // 4), -(-n_l // 4)
    ring = 2 * g["cs"]
    for c0 in range(0, n_s, g["cs"]):
        c1 = min(c0 + g["cs"], n_s)
        n_c = c1 - c0
        ts = -(-n_c // 2)
        for s in range(n_c):
            sm.put(s, y[c0 + s])
            sm.put(g["cs"] + s, d[c0 + s])
        for kk in range(ts * tp):                 # self tiles
            s0, e0 = (kk // tp) * 2, (kk % tp) * 4
            for a in range(2):
                for e in range(4):
                    pr = min(e0 + e, n_l * nu - 1)
                    l = pr // nu
                    r = sm.get(s_u + (l // nu) * ms + pr % nu)
                    acc = _sum(((drow(s0 + a, n_c) * xrow(l)) * r)[None])[0]
                    if s0 + a < n_c and e0 + e < n_l * nu:
                        write(l // nu, ((c0 + s0 + a) * nu + l % nu) * p
                              + n_ct + pr % nu, acc)
        for kk in range(ts * tb):                 # b_u tiles
            s0, l0 = (kk // tb) * 2, (kk % tb) * 4
            for a in range(2):
                dy = drow(s0 + a, n_c) * sm.get(min(s0 + a, n_c - 1))
                for b in range(4):
                    acc = _sum((xrow(l0 + b) * dy)[None])[0]
                    l = l0 + b
                    if s0 + a < n_c and l < n_l:
                        write(l // nu, e_bu + (l % nu) * n_s + c0 + s0 + a,
                              acc)
        if c1 == n_s:
            for kk in range(gm):                  # usq
                xk = np.stack([sm.get(s_x + kk * ms + v) for v in range(nu)])
                uk = np.stack([sm.get(s_u + kk * ms + v) for v in range(nu)])
                write(kk, n_e - 1, _sum((xk * uk).T.reshape(1, -1))[0])
        for rc in range(n_rc):
            r0 = rc * g["q"]
            nq = min(g["q"], n_ct - r0)
            slot = ring + (rc % 2) * g["q"]
            for r in range(nq):
                sm.put(slot + r, rt[r0 + r])
            tq = -(-nq // GRAM_TILE_Q)
            for k in range(ts * tl * tq):         # cross tiles
                q0 = (k % tq) * GRAM_TILE_Q
                l0 = ((k // tq) % tl) * 2
                s0 = (k // (tq * tl)) * 2
                for a in range(2):
                    for b in range(2):
                        lf = drow(s0 + a, n_c) * xrow(l0 + b)
                        for c in range(GRAM_TILE_Q):
                            r = sm.get(slot + min(q0 + c, nq - 1))
                            acc = _sum((lf * r)[None])[0]
                            s, l = s0 + a, l0 + b
                            if s < n_c and l < n_l and q0 + c < nq:
                                write(l // nu, ((c0 + s) * nu + l % nu) * p
                                      + r0 + q0 + c, acc)
    return out


def _data(n_s, n_ct, n_u, dtype, seed, members=0):
    rng = np.random.default_rng(seed)
    y = rng.random((n_s, SITES_PER_BLOCK)).astype(dtype)
    d = (rng.poisson(30, (n_s, SITES_PER_BLOCK)) + 1).astype(dtype)
    rt = rng.random((n_ct, SITES_PER_BLOCK)).astype(dtype)
    shape = (members, n_u, SITES_PER_BLOCK) if members else (
        n_u, SITES_PER_BLOCK)
    u = rng.random(shape).astype(dtype)
    w = rng.poisson(1.0, shape[:-2] + (1, SITES_PER_BLOCK)).astype(dtype)
    return y, d, rt, u, w


# (n_s, n_ct, n_u): two sample chunks with a ragged ring; one unknown
# (tiles of 4 samples); no known block; n_u > 8 with its state region;
# the state region in device memory (the chunk and the ring shrunk)
K1_RING = [(40, 21, 3), (10, 7, 1), (33, 0, 2), (70, 9, 9), (108, 5, 18)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("n_s,n_ct,n_u", K1_RING,
                         ids=[f"{a}x{b}+{c}" for a, b, c in K1_RING])
def test_k1_ring_writes_the_entry_order_bits(dtype, n_s, n_ct, n_u):
    y, d, rt, u, _ = _data(n_s, n_ct, n_u, dtype, 7 + n_s)
    g = global_plan(np.dtype(dtype).itemsize, n_s, n_ct, n_u)
    got = _k1_ring(y, d, rt, u, g)
    want = _k1_reference(y, d, rt, u)
    assert sorted(got) == sorted(want)
    assert all(got[e].tobytes() == want[e].tobytes() for e in want)
    if n_ct > 2 * g["q"] > 0:
        assert g["depth"] == 2            # the ring's two slots both used


# (n_s, n_ct, n_u, active members, group, weighted)
K4_RING = [(40, 21, 2, 2, 3, True), (10, 13, 4, 2, 2, False),
           (64, 6, 9, 2, 2, False), (12, 0, 1, 3, 3, True)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("n_s,n_ct,n_u,gm,group,weighted", K4_RING,
                         ids=[f"{a}x{b}+{c}-B{d}of{e}{'w' if f else ''}"
                              for a, b, c, d, e, f in K4_RING])
def test_k4_ring_writes_the_entry_order_bits(dtype, n_s, n_ct, n_u, gm,
                                             group, weighted):
    y, d, rt, u, w = _data(n_s, n_ct, n_u, dtype, 9 + n_s, members=gm)
    x = w * u if weighted else u
    g = global_plan(np.dtype(dtype).itemsize, n_s, n_ct, n_u, False,
                    n_u * (2 if weighted else 1), group)
    got = _k4_ring(y, d, rt, u, x, weighted, group, g)
    want = _k4_reference(y, d, rt, u, x)
    assert sorted(got) == sorted(want)
    assert all(got[e].tobytes() == want[e].tobytes() for e in want)


# (itemsize, n_s, n_u, n_ct): the ring's q and rows, and its tiles a slot
# dealt as gram_plan deals them (rs samples x rv unknowns x 4 rows):
# 128 at 160 + 4 (a tile a thread, two blocks an SM); at n_s = 10 in
# float64 110 at two blocks an SM, not 130 at one; at n_u = 1 in float64
# one block an SM with 128 tiles, not two with 40
RING_TILES = [((8, 64, 4, 160), 16, 100, 128), ((8, 10, 4, 205), 44, 112, 110),
              ((4, 10, 4, 205), 52, 128, 130), ((8, 64, 1, 300), 64, 193, 128),
              ((8, 100, 12, 200), 8, 126, 192)]


@pytest.mark.parametrize("shape,q,rows,tiles", RING_TILES)
def test_ring_tiles_a_slot(shape, q, rows, tiles):
    itemsize, n_s, n_u, n_ct = shape
    g = global_plan(itemsize, n_s, n_ct, n_u)
    assert (g["q"], g["rows"]) == (q, rows)
    assert itemsize * LD * rows <= SMEM_LIMIT
    tp = gram_tile_plan(g["cs"], n_u, g["q"], False)
    assert tp["tiled"] and tp["ts"] * tp["tv"] * tp["tq"] == tiles


def _known_rows(a1, rt, kc, group=8):
    """known_rows transcribed: a1 staged kc rows at a time, each sample's
    sum carried in its row from chunk to chunk, ``group`` samples a pass."""
    n_ct, n_s = a1.shape
    rows = np.full((n_s, rt.shape[1]), np.nan, a1.dtype)
    for c0 in range(0, n_ct, kc):
        staged = a1[c0:c0 + kc].copy()
        for s0 in range(0, n_s, group):
            sg = [min(s0 + g, n_s - 1) for g in range(group)]
            acc = (np.zeros((group, rt.shape[1]), a1.dtype) if c0 == 0
                   else rows[sg].copy())
            for c in range(c0, min(c0 + kc, n_ct)):
                acc = acc + staged[c - c0][sg][:, None] * rt[c][None]
            for g in range(group):
                if s0 + g < n_s:
                    rows[s0 + g] = acc[g]
    return rows


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("kc", [1, 3, 64, 160])
def test_known_rows_keep_the_sum_order(dtype, kc):
    """The known sums a1' rt formed through staged chunks of a1 equal
    known_resid's sums (over c in order from 0) bit for bit: a running sum,
    not chunk sums added afterwards (which would differ)."""
    rng = np.random.default_rng(kc)
    n_ct, n_s = 160, 13
    a1 = rng.random((n_ct, n_s)).astype(dtype)
    rt = rng.random((n_ct, SITES_PER_BLOCK)).astype(dtype)
    want = np.zeros((n_s, SITES_PER_BLOCK), dtype)
    for c in range(n_ct):
        want = want + a1[c][:, None] * rt[c][None]
    got = _known_rows(a1, rt, kc)
    assert got.tobytes() == want.tobytes()
    if 1 < kc < n_ct:
        parts = sum(_known_rows(a1[c0:c0 + kc], rt[c0:c0 + kc], kc)
                    for c0 in range(0, n_ct, kc))
        assert parts.tobytes() != want.tobytes()


# ---- the launchers read the ring from the library -----------------------


class _Library:
    """Stand-ins of the exports K1's and K4's launch plans read, answering
    from the Python plan and recording each call; any other name (such as
    the row-buffer sizes the global layout no longer has) raises."""

    def __init__(self):
        self.calls = []
        for kernel, nargs in (("dm_u_phase_grams", 6),
                              ("dm_u_phase_grams_multi", 5)):
            for sfx, layout in (("", "resident"), ("_wide", "wide"),
                                ("_global", "global")):
                setattr(self, f"{kernel}{sfx}_smem",
                        self._record(f"{kernel}{sfx}_smem",
                                     self._smem(layout, nargs)))

    def _record(self, name, fn):
        def call(*args):
            self.calls.append((name, tuple(
                list(a) if isinstance(a, ctypes.Array) else a
                for a in args)))
            return fn(*args)
        return call

    @staticmethod
    def _smem(layout, nargs):
        def smem(itemsize, n_s, n_ct, n_u, *flags):
            if nargs == 6:
                return u_phase_smem(layout, itemsize, n_s, n_ct, n_u,
                                    bool(flags[0]), bool(flags[1]))
            return u_phase_smem(layout, itemsize, n_s, n_ct, n_u,
                                weighted=bool(flags[0]))
        return smem

    def __getattr__(self, name):
        def global_plan_export(itemsize, n_s, n_ct, n_u, direct, um,
                               members, out):
            g = global_plan(itemsize, n_s, n_ct, n_u, bool(direct), um,
                            members)
            out[:] = [g[k] for k in cuda_kernels.GLOBAL_PLAN_KEYS]
            return 0

        def member_plan(itemsize, n_s, n_ct, n_u, n_b, weighted, code, out):
            plan = cuda_multi.k4_member_plan(
                itemsize, n_s, n_ct, n_u, n_b, bool(weighted),
                ("resident", "wide", "global")[code])
            out[:] = [plan["group"], plan["smem"], plan["blocks"]]
            return 0

        fns = {
            "dm_global_plan": global_plan_export,
            "dm_k4_member_plan": member_plan,
            "dm_u_phase_grams_blocks": lambda n: -(-n // SITES_PER_BLOCK),
            "dm_state_rows": lambda n_s, n_u, direct: state_rows(
                n_s, n_u, bool(direct)),
            "dm_state_in_device": lambda it, n_s, n_u, direct: int(
                state_in_device(it, n_s, n_u, bool(direct))),
        }
        if name not in fns:
            raise AttributeError(f"no export {name}")
        fn = self._record(name, fns[name])
        setattr(self, name, fn)
        return fn


# (itemsize, n, n_s, n_ct, n_u, bf16c): the global layout (gram form; in
# bf16_compute's, raw u rows too; the direct form; the state region in
# device memory) and, for contrast, the resident layout
K1_PLANS = [(8, 200_000, 64, 160, 4, False), (4, 200_000, 64, 400, 4, True),
            (8, 200_000, 10, 200, 12, False), (8, 50_000, 108, 5, 18, False),
            (4, 1_000_000, 10, 5, 1, False)]


@pytest.mark.parametrize("itemsize,n,n_s,n_ct,n_u,bf16c", K1_PLANS)
def test_k1_launch_reads_the_ring_and_allocates_no_row_buffer(
        itemsize, n, n_s, n_ct, n_u, bf16c):
    lib = _Library()
    direct = not gram_form(n_u, n_s)
    steps = 20
    plan = cuda_kernels.launch_plan(lib, itemsize, n, n_s, n_ct, n_u, steps,
                                    direct, bf16c)
    names = [c[0] for c in lib.calls]
    n_blocks = -(-n // SITES_PER_BLOCK)
    entries = cuda_kernels.gram_entries(n_s, n_ct, n_u)
    assert set(plan["sizes"]) == {"partials", "out", "state"}
    assert plan["sizes"]["partials"] == entries * n_blocks + steps + 1
    assert plan["sizes"]["out"] == entries
    in_device = state_in_device(itemsize, n_s, n_u, direct)
    assert plan["sizes"]["state"] == (
        n_blocks * state_rows(n_s, n_u, direct) * LD if in_device else 0)
    if plan["layout"] != "global":
        assert plan["ring"] is None and "dm_global_plan" not in names
        return
    um = n_u * (2 if bf16c and not direct else 1)
    args = (itemsize, n_s, n_ct, n_u, int(direct), um, 1)
    assert [c[1][:7] for c in lib.calls if c[0] == "dm_global_plan"] == [
        args]
    assert plan["ring"] == global_plan(itemsize, n_s, n_ct, n_u, direct, um)
    assert plan["smem"] == itemsize * LD * plan["ring"]["rows"]


@pytest.mark.parametrize("weighted", [False, True])
def test_k4_launch_reads_the_group_ring_and_allocates_no_row_buffer(
        weighted):
    lib = _Library()
    n, n_s, n_ct, n_u, n_b, steps = 200_000, 64, 160, 4, 10, 20
    plan = cuda_multi.launch_plan(lib, 8, n, n_s, n_ct, n_u, n_b, steps,
                                  weighted)
    assert plan["layout"] == "global" and not plan["in_device"]
    group = cuda_multi.k4_member_plan(8, n_s, n_ct, n_u, n_b, weighted,
                                      "global")["group"]
    um = n_u * (2 if weighted else 1)
    assert plan["ring"] == dict(global_plan(8, n_s, n_ct, n_u, False, um,
                                            group), group=group)
    assert [c[1][:7] for c in lib.calls if c[0] == "dm_global_plan"] == [
        (8, n_s, n_ct, n_u, 0, um, group)]
    n_blocks = -(-n // SITES_PER_BLOCK)
    entries = cuda_kernels.gram_entries(n_s, n_ct, n_u)
    n_part = n_b * entries * n_blocks
    assert plan["sizes"] == {
        "partials": n_part + n_b * (steps + 1) + -(-4 * (n_b + 1) // 8),
        "tab": n_part, "list": n_part + n_b * (steps + 1), "out": entries,
        "state": 0}
