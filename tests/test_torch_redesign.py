"""The Python pieces of K1's and K2's redesign for the H100, on the CPU.

- ``cuda_kernels.momentum_table_plain`` / ``momentum_table``: the
  momentum table that K1, K4 and K7 compute once per launch (their
  prologue kernel) so that no thread replays the chain. Held bit for bit
  to the betas the twins' own step loop forms (``ops/fista.py``
  ``nesterov_step`` / ``momentum`` inside ``fista_u_gram``, recorded as it
  runs), in float32 and float64, at 0, 1, 20 and 500 steps, with l_w = 0
  and NaN.
- ``cuda_kernels.gram_tile_plan``: K1/K4's Gram stage plan (one entry
  per thread, or register micro-tiles): by the kernels' mapping from
  items to entries (``gram_plan_items`` below), every entry of
  [gu | b_u | usq] is written exactly once at the main, cohort (both
  layouts) and n_u > 8 shapes.
- ``cuda_small.alpha_plan``: K2/K5's row bucket and column grid.

The card checks the kernels themselves against these (``chip_smoke.py``,
``phase_redesign``).
"""

import numpy as np
import pytest
import torch

from demethify_tpu_torch.ops import cuda_kernels as ck
from demethify_tpu_torch.ops import fista
from demethify_tpu_torch.ops.cuda_small import (
    BLOCK_COLUMNS,
    ONE_BLOCK_COLUMNS,
    ROW_BUCKETS,
    alpha_plan,
)

DTYPES = (torch.float32, torch.float64)
STEPS = (0, 1, 20, 500)
# (a, l_prev, l_w): a regular chain, l_w = 0 (0/0 from step 1), NaN
SCALARS = {"regular": (2.5, 0.9, 1.0), "l_w=0": (2.5, 0.9, 0.0),
           "l_w=nan": (2.5, 0.9, float("nan")),
           "l_prev=0": (1.0, 0.0, 3.0)}


def _bits_equal(x, y):
    """The same values bit for bit, NaN for NaN."""
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    nan = torch.isnan(x)
    if not torch.equal(nan, torch.isnan(y)):
        return False
    iv = {torch.float32: torch.int32, torch.float64: torch.int64}[x.dtype]
    return torch.equal(x.reshape(-1).view(iv)[~nan.reshape(-1)],
                       y.reshape(-1).view(iv)[~nan.reshape(-1)])


def _twin_betas(a, l_prev, l_w, n_steps, monkeypatch):
    """The betas, the advanced a and l_w_prev of the twins' U loop
    (``fista_u_gram`` on a one-site problem), recorded from its own calls
    of ``momentum``."""
    seen = []
    real = fista.momentum

    def recording(a0, a1, lp, lc):
        beta = real(a0, a1, lp, lc)
        seen.append(beta.clone())
        return beta

    monkeypatch.setattr(fista, "momentum", recording)
    dt = a.dtype
    u = torch.full((1, 1), 0.5, dtype=dt)
    C = torch.full((1, 1), 0.25, dtype=dt)
    M = torch.full((1, 1, 1), 0.5, dtype=dt)
    _, _, a_out, lp_out = fista.fista_u_gram(u, u.clone(), a, l_prev, l_w,
                                             C, M, n_steps)
    monkeypatch.setattr(fista, "momentum", real)
    return seen, a_out, lp_out


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("n_steps", STEPS)
@pytest.mark.parametrize("case", list(SCALARS))
def test_momentum_table_is_the_twins_betas(dtype, n_steps, case,
                                           monkeypatch):
    a, l_prev, l_w = (torch.tensor(x, dtype=dtype) for x in SCALARS[case])
    tab = ck.momentum_table_plain(a, l_prev, l_w, n_steps)
    betas, a_out, lp_out = _twin_betas(a, l_prev, l_w, n_steps, monkeypatch)
    assert tab.shape == (n_steps + 1,) and tab.dtype == dtype
    assert len(betas) == n_steps
    for k, beta in enumerate(betas):
        assert _bits_equal(tab[k], beta), (k, tab[k], beta)
    assert _bits_equal(tab[-1], a_out)
    assert _bits_equal(lp_out, l_w if n_steps else l_prev)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("n_steps", (0, 20))
def test_momentum_table_reads_each_kernels_slots(dtype, n_steps):
    """K1's vector, K4's member rows and K7's single-phase vector: each
    row's table from its own slots."""
    a, lp, lw = 2.5, 0.9, 1.0
    k1 = torch.zeros(ck.N_SCAL, dtype=dtype)
    k1[ck.A_U], k1[ck.L_W_PREV], k1[ck.L_W] = a, lp, lw
    want = ck.momentum_table_plain(*(torch.tensor(x, dtype=dtype)
                                     for x in (a, lp, lw)), n_steps)
    assert _bits_equal(ck.momentum_table(k1, n_steps), want)
    rows = torch.zeros((3, ck.N_SCAL_MULTI), dtype=dtype)
    rows[:, ck.A_U] = torch.tensor([a, 1.0, 4.0], dtype=dtype)
    rows[:, ck.L_W_PREV] = torch.tensor([lp, 0.5, 2.0], dtype=dtype)
    rows[:, ck.L_W] = torch.tensor([lw, 0.25, 3.0], dtype=dtype)
    tabs = ck.momentum_table(rows, n_steps)
    assert tabs.shape == (3, n_steps + 1)
    for b in range(3):
        assert _bits_equal(tabs[b], ck.momentum_table_plain(
            rows[b, ck.A_U], rows[b, ck.L_W_PREV], rows[b, ck.L_W],
            n_steps))
    ph = ck.phase_scalars(torch.zeros(1, dtype=dtype), a, lw, lp)
    assert _bits_equal(ck.momentum_table(ph, n_steps, phase=True), want)


def gram_plan_items(n_s: int, c0: int, c1: int, n_u: int, p: int,
                    usq: bool):
    """The entries of [gu (n_s, n_u, p) | b_u (n_u, n_s) | usq] that each
    item of ``gram_tile_plan(c1 - c0, n_u, p, usq)`` writes, for the
    samples [c0, c1): a list of lists of entry indices, by the kernels'
    mapping (``csrc/u_phase_common.cuh``, ``gram_partials``: a tile's
    clamped rows write nothing)."""
    n_c = c1 - c0
    plan = ck.gram_tile_plan(n_c, n_u, p, usq)
    e_gu = n_s * n_u * p
    l_gu = n_c * n_u * p

    def entry(l):
        if l < l_gu:
            return c0 * n_u * p + l
        if l < l_gu + n_u * n_c:
            v, s = divmod(l - l_gu, n_c)
            return e_gu + v * n_s + c0 + s
        return e_gu + n_u * n_s

    if not plan["tiled"]:
        return [[entry(l)] for l in range(plan["n_items"])]
    rs, rv, tv, tq = plan["rs"], plan["rv"], plan["tv"], plan["tq"]
    items = []
    for k in range(plan["n_items"]):
        if k >= plan["n_tiles"]:
            items.append([entry(l_gu + k - plan["n_tiles"])])
            continue
        qt, vt, st = k % tq, (k // tq) % tv, k // (tq * tv)
        items.append([(c0 + s) * n_u * p + v * p + q
                      for s in range(st * rs, st * rs + rs) if s < n_c
                      for v in range(vt * rv, vt * rv + rv) if v < n_u
                      for q in range(qt * ck.GRAM_TILE_Q,
                                     qt * ck.GRAM_TILE_Q + ck.GRAM_TILE_Q)
                      if q < p])
    return items


def _covered(n_s, n_u, p, chunks):
    """How many times each entry of [gu | b_u | usq] is written when the
    Gram stage runs over ``chunks`` ((c0, c1) ranges, usq with the last)."""
    count = np.zeros(ck.gram_entries(n_s, p - n_u, n_u), dtype=int)
    for c0, c1 in chunks:
        for item in gram_plan_items(n_s, c0, c1, n_u, p, c1 == n_s):
            for e in item:
                count[e] += 1
    return count


def _chunks(n_s, layout):
    if layout == "resident":
        return [(0, n_s)]
    return [(c0, min(c0 + 32, n_s)) for c0 in range(0, n_s, 32)]


# (n_s, n_ct, n_u): the main shape, the cohort shape, n_u > 8, odd shapes
GRAM_SHAPES = {"main": (10, 5, 1), "cohort": (100, 25, 4),
               "n_u>8": (100, 5, 12), "n_u>8 narrow": (10, 5, 12),
               "unsupervised": (10, 0, 3), "one sample": (1, 5, 2),
               "odd": (37, 7, 3)}


@pytest.mark.parametrize("layout", ["resident", "wide"])
@pytest.mark.parametrize("shape", list(GRAM_SHAPES))
def test_gram_plan_writes_every_entry_once(shape, layout):
    n_s, n_ct, n_u = GRAM_SHAPES[shape]
    p = n_ct + n_u
    count = _covered(n_s, n_u, p, _chunks(n_s, layout))
    assert (count == 1).all(), np.flatnonzero(count != 1)[:10]


def test_gram_plan_follows_the_entry_count():
    """One entry per thread at the main shape (71 entries); micro-tiles
    at the cohort shape, 4 left factors x 4 rows each, at most one tile's
    rows clamped per edge."""
    main = ck.gram_tile_plan(10, 1, 6, True)
    assert not main["tiled"] and main["n_items"] == 71
    cohort = ck.gram_tile_plan(100, 4, 29, True)
    assert cohort["tiled"] and (cohort["rs"], cohort["rv"]) == (2, 2)
    assert cohort["n_tiles"] == 50 * 2 * 8
    assert cohort["n_items"] == 800 + 400 + 1
    one = ck.gram_tile_plan(100, 1, 26, True)
    assert one["tiled"] and (one["rs"], one["rv"]) == (4, 1)
    wide = ck.gram_tile_plan(32, 4, 29, False)
    assert wide["n_items"] == wide["n_tiles"] + 4 * 32
    for n_c, n_u, p in ((10, 1, 6), (100, 4, 29), (100, 12, 17)):
        plan = ck.gram_tile_plan(n_c, n_u, p, True)
        entries = n_c * n_u * p + n_u * n_c + 1
        assert plan["tiled"] == (entries > ck.SITES_PER_BLOCK)


@pytest.mark.parametrize("p", [1, 6, 8, 9, 16, 17, 29, 32])
@pytest.mark.parametrize("n_s", [1, 10, 16, 17, 32, 33, 100, 500])
def test_alpha_plan_gives_each_column_its_warp(p, n_s):
    bucket, cols, blocks = alpha_plan(p, n_s)
    assert bucket == min(b for b in ROW_BUCKETS if b >= p)
    assert 1 <= cols <= max(ONE_BLOCK_COLUMNS, BLOCK_COLUMNS)
    assert cols == (n_s if n_s <= ONE_BLOCK_COLUMNS else BLOCK_COLUMNS)
    seen = [x * cols + w for x in range(blocks) for w in range(cols)
            if x * cols + w < n_s]
    assert seen == list(range(n_s))
    assert blocks * cols - n_s < cols
