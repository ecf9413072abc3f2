"""The Python pieces of K4's and K3's redesign for the H100, on the CPU.

- ``cuda_multi.k4_member_plan``: K4's member groups. Each group's alpha
  blocks and u rows fit the shared-memory budget the plan gives it; the
  group is every member where they fit and at least one otherwise; the
  groups and their Gram stages (``k4_gram_plan``, by the kernel's mapping
  from items to entries, ``k4_items`` below) write every (member, entry)
  of [gu | b_u | usq] exactly once in both layouts; the tiles of each
  kind write their own block (cross tiles gu's Rt columns, self tiles its
  u columns, b_u tiles b_u, one usq item per member); and the mapping,
  evaluated on one block's sites, gives the twin's Gram sums.
- The K3 row bucket (``cuda_small.alpha_plan``, the kernels'
  ``dm_row_bucket``): the smallest of 8, 16 and 32 lanes holding p rows.
- The twins the card holds the redesigned kernels to, against the JAX
  package's functions: K4's (``u_phase_grams_multi`` under interpret) at
  more members than one group of the main shape's plan would take and
  with weights, and K3's (``fw_phase_full``) at each row bucket and past
  16 columns, where the kernel spreads a member's columns over blocks.
  Tolerances as tests/test_torch_multi.py and tests/test_torch_purity.py.

The card checks the kernels themselves against these (``chip_smoke.py``,
``phase_redesign_k4k3``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demethify_tpu.ops.pallas_kernels import u_phase_grams_multi as j_k4
from demethify_tpu_torch.ops import cuda_kernels as ck
from demethify_tpu_torch.ops import cuda_multi, cuda_small
from demethify_tpu_torch.ops.cuda_multi import (
    K4_GROUP_BLOCKS,
    K4_TILE_B,
    K4_TILE_L,
    K4_TILE_P,
    K4_TILE_S,
    k4_gram_plan,
    k4_member_plan,
    k4_smem,
)
from demethify_tpu_torch.ops.cuda_small import ROW_BUCKETS, alpha_plan
from tests.test_torch_multi import TILE, _pad
from tests.test_torch_purity import _grams, _k3_both, _t

LAYOUTS = ("resident", "wide")
# (itemsize, n_s, n_ct, n_u, weighted): the restart and bootstrap paths'
# shape in both dtypes, the unsupervised shape, n_u = 8 and 12, the cohort
# shape, odd shapes
PLAN_SHAPES = {"main f32": (4, 10, 5, 1, False), "main f64": (8, 10, 5, 1,
                                                             False),
               "weighted f32": (4, 10, 5, 1, True),
               "weighted f64": (8, 10, 5, 1, True),
               "unsupervised": (4, 10, 0, 3, False),
               "n_u8": (4, 16, 5, 8, False), "n_u12": (8, 10, 5, 12, True),
               "cohort": (4, 100, 25, 4, False),
               "cohort f64 w": (8, 100, 25, 4, True),
               "odd": (8, 37, 7, 3, True), "one sample": (4, 1, 5, 2, False)}
MEMBERS = (1, 2, 3, 16, 17, 32)


def _budget(plan):
    """The bytes a group may take at the plan's blocks per SM."""
    return min(ck.SMEM_PER_SM // plan["blocks"] - 1024, ck.SMEM_LIMIT)


def k4_items(n_s, c0, c1, n_ct, n_u, gm, usq):
    """What each item of ``k4_gram_plan(c1 - c0, n_ct, n_u, gm, usq)``
    writes for the samples [c0, c1), by the kernel's mapping
    (``csrc/u_phase_grams_multi.cuh``, ``group_grams`` and
    ``group_entry``; clamped rows and the idle items between the kinds
    write nothing): per item a list of (kind, member slot, sample, v, q)
    with kind "gu" (the entry gu[s, v, q]), "bu" (b_u[v, s]) or "usq"."""
    n_c = c1 - c0
    g = k4_gram_plan(n_c, n_ct, n_u, gm, usq)
    n_l = gm * n_u
    p = n_ct + n_u
    items = []
    if not g["tiled"]:
        n_loc = g["n_items"] // gm
        for k in range(g["n_items"]):
            m, le = divmod(k, n_loc)
            if le < n_c * n_u * p:
                items.append([("gu", m, c0 + le // (n_u * p),
                               le // p % n_u, le % p)])
            elif le < n_c * n_u * p + n_u * n_c:
                v, s = divmod(le - n_c * n_u * p, n_c)
                items.append([("bu", m, c0 + s, v, None)])
            else:
                items.append([("usq", m, None, None, None)])
        return items
    for k in range(g["n_items"]):
        if k < g["n_x"]:
            q0 = (k % g["tq"]) * ck.GRAM_TILE_Q
            l0 = ((k // g["tq"]) % g["tl"]) * K4_TILE_L
            s0 = (k // (g["tq"] * g["tl"])) * K4_TILE_S
            items.append([("gu", l // n_u, c0 + s, l % n_u, q)
                          for s in range(s0, s0 + K4_TILE_S) if s < n_c
                          for l in range(l0, l0 + K4_TILE_L) if l < n_l
                          for q in range(q0, q0 + ck.GRAM_TILE_Q)
                          if q < n_ct])
        elif g["o_self"] <= k < g["o_self"] + g["n_self"]:
            kk = k - g["o_self"]
            e0 = (kk % g["tp"]) * K4_TILE_P
            s0 = (kk // g["tp"]) * K4_TILE_S
            items.append([("gu", e // n_u // n_u, c0 + s, e // n_u % n_u,
                           n_ct + e % n_u)
                          for s in range(s0, s0 + K4_TILE_S) if s < n_c
                          for e in range(e0, e0 + K4_TILE_P)
                          if e < n_l * n_u])
        elif g["o_bu"] <= k < g["o_bu"] + g["n_bu"]:
            kk = k - g["o_bu"]
            l0 = (kk % g["tb"]) * K4_TILE_B
            s0 = (kk // g["tb"]) * K4_TILE_S
            items.append([("bu", l // n_u, c0 + s, l % n_u, None)
                          for s in range(s0, s0 + K4_TILE_S) if s < n_c
                          for l in range(l0, l0 + K4_TILE_B) if l < n_l])
        elif k >= g["o_usq"]:
            items.append([("usq", k - g["o_usq"], None, None, None)])
        else:
            items.append([])
    return items


def _entry(w, n_s, n_ct, n_u):
    """The index of a written entry in [gu (n_s, n_u, p) | b_u | usq]."""
    kind, _, s, v, q = w
    p = n_ct + n_u
    if kind == "gu":
        return (s * n_u + v) * p + q
    if kind == "bu":
        return n_s * n_u * p + v * n_s + s
    return ck.gram_entries(n_s, n_ct, n_u) - 1


def _chunks(n_s, layout):
    if layout == "resident":
        return [(0, n_s)]
    return [(c0, min(c0 + 32, n_s)) for c0 in range(0, n_s, 32)]


def _groups(n_b, group):
    return [(k0, min(group, n_b - k0)) for k0 in range(0, n_b, group)]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", list(PLAN_SHAPES))
def test_k4_member_plan_fits_its_budget(shape, layout):
    """The group's bytes are k4_smem's, within the budget that keeps the
    plan's blocks per SM, and the group is the largest that fits (or all
    B members); one member's bytes are the layout rule's."""
    it, n_s, n_ct, n_u, w = PLAN_SHAPES[shape]
    one = k4_smem(it, n_s, n_ct, n_u, w, layout, 1)
    assert one == ck.u_phase_smem(layout, it, n_s, n_ct, n_u, weighted=w)
    for n_b in MEMBERS:
        plan = k4_member_plan(it, n_s, n_ct, n_u, n_b, w, layout)
        group = plan["group"]
        assert 1 <= group <= n_b
        assert plan["smem"] == k4_smem(it, n_s, n_ct, n_u, w, layout, group)
        assert plan["blocks"] == max(1, min(ck.blocks_per_sm(one),
                                            K4_GROUP_BLOCKS))
        if one <= ck.SMEM_LIMIT:
            assert plan["smem"] <= _budget(plan)
            assert ck.blocks_per_sm(plan["smem"]) >= plan["blocks"]
        if group < n_b:
            assert k4_smem(it, n_s, n_ct, n_u, w, layout,
                           group + 1) > _budget(plan)


def test_k4_member_plan_takes_every_member_where_they_fit():
    """G = B at the restart and bootstrap paths' float32 shapes (B = 16,
    weighted B = 32); where they do not fit (weighted float64 B = 32, the
    cohort's n_u = 12 in the wide layout) G >= 1, and a group never grows
    with B past what fits."""
    assert k4_member_plan(4, 10, 5, 1, 16, False, "resident")["group"] == 16
    assert k4_member_plan(4, 10, 5, 1, 32, True, "resident")["group"] == 32
    assert k4_member_plan(4, 10, 0, 3, 8, False, "resident")["group"] == 8
    f64w = k4_member_plan(8, 10, 5, 1, 32, True, "resident")
    assert 1 <= f64w["group"] < 32
    big = [k4_member_plan(8, 100, 5, 12, n_b, False, "wide")["group"]
           for n_b in (4, 64, 2048)]
    assert big[0] >= 1 and big[1] == big[2]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", list(PLAN_SHAPES))
def test_k4_groups_write_every_member_entry_once(shape, layout):
    it, n_s, n_ct, n_u, w = PLAN_SHAPES[shape]
    n_e = ck.gram_entries(n_s, n_ct, n_u)
    for n_b in (1, 3, 17):
        group = k4_member_plan(it, n_s, n_ct, n_u, n_b, w, layout)["group"]
        count = np.zeros((n_b, n_e), dtype=int)
        for k0, gm in _groups(n_b, group):
            for c0, c1 in _chunks(n_s, layout):
                for item in k4_items(n_s, c0, c1, n_ct, n_u, gm, c1 == n_s):
                    for wr in item:
                        count[k0 + wr[1], _entry(wr, n_s, n_ct, n_u)] += 1
        assert (count == 1).all(), np.argwhere(count != 1)[:10]


@pytest.mark.parametrize("shape", ["main f32", "unsupervised", "n_u12",
                                   "cohort"])
def test_k4_tile_kinds_cover_their_blocks(shape):
    """Cross tiles write gu's Rt columns (q < n_ct) alone, self tiles its
    u columns, b_u tiles b_u, and there is one usq item per member."""
    _, n_s, n_ct, n_u, _ = PLAN_SHAPES[shape]
    gm = 17
    g = k4_gram_plan(n_s, n_ct, n_u, gm, True)
    assert g["tiled"]
    items = k4_items(n_s, 0, n_s, n_ct, n_u, gm, True)
    kinds = [items[o:o + n] for o, n in ((0, g["n_x"]),
                                         (g["o_self"], g["n_self"]),
                                         (g["o_bu"], g["n_bu"]),
                                         (g["o_usq"], g["n_usq"]))]
    for o in (g["o_self"], g["o_bu"], g["o_usq"]):
        assert o % 32 == 0                        # each kind on its warps
    writes = [[wr for item in part for wr in item] for part in kinds]
    assert all(wr[0] == "gu" and wr[4] < n_ct for wr in writes[0])
    assert len(writes[0]) == gm * n_s * n_u * n_ct
    assert all(wr[0] == "gu" and wr[4] >= n_ct for wr in writes[1])
    assert len(writes[1]) == gm * n_s * n_u * n_u
    assert all(wr[0] == "bu" for wr in writes[2])
    assert len(writes[2]) == gm * n_u * n_s
    assert sorted(wr[1] for wr in writes[3]) == list(range(gm))
    assert g["n_items"] == len(items)
    assert sum(map(len, writes)) == sum(map(len, items))   # idle items


def test_k4_gram_plan_tiles_only_with_an_item_per_thread():
    """Entries one per item at the main shape up to the group where the
    tiles reach 128 items (B = 16: 136 items), as K1's stage takes tiles
    only above 128 entries."""
    for gm in (1, 2, 8):
        g = k4_gram_plan(10, 5, 1, gm, True)
        assert not g["tiled"] and g["n_items"] == 71 * gm
    g = k4_gram_plan(10, 5, 1, 16, True)
    assert g["tiled"] and g["n_x"] + g["n_self"] + g["n_bu"] + 16 == 136


@pytest.mark.parametrize("gm", [5, 24], ids=["entries", "tiles"])
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "w"])
@pytest.mark.parametrize("n_ct,n_u", [(5, 1), (0, 3), (4, 2)])
def test_k4_group_mapping_gives_the_twins_sums(n_ct, n_u, weighted, gm):
    """The kernel's mapping, in its entry form (5 members) and its tiled
    form (24), evaluated on one block of 128 sites (each entry's products
    as the kernel forms them, summed over the sites) equals the twin's
    Gram blocks of every member of a group."""
    rng = np.random.default_rng(7 + n_u)
    n_s, n = 6, ck.SITES_PER_BLOCK
    assert k4_gram_plan(n_s, n_ct, n_u, gm, True)["tiled"] == (gm == 24)
    d = rng.uniform(1, 60, size=(n_s, n))
    y = rng.uniform(size=(n_s, n))
    rt = rng.uniform(size=(n_ct, n))
    u = rng.uniform(size=(gm, n_u, n))
    wgt = rng.integers(0, 4, size=(gm, n)) if weighted else np.ones((gm, n))
    x = wgt[:, None, :] * u                           # the left u rows
    out = np.full((gm, ck.gram_entries(n_s, n_ct, n_u)), np.nan)
    for item in k4_items(n_s, 0, n_s, n_ct, n_u, gm, True):
        for wr in item:
            kind, k, s, v, q = wr
            if kind == "gu":
                r = rt[q] if q < n_ct else u[k, q - n_ct]
                val = np.sum((d[s] * x[k, v]) * r)
            elif kind == "bu":
                val = np.sum(x[k, v] * (d[s] * y[s]))
            else:
                val = np.sum(x[k] * u[k])
            out[k, _entry(wr, n_s, n_ct, n_u)] = val
    rext = np.concatenate([np.broadcast_to(rt, (gm, n_ct, n)), u], axis=1)
    gu = np.einsum("sn,bun,bqn->bsuq", d, x, rext).reshape(gm, -1)
    bu = np.einsum("bun,sn->bus", x, d * y).reshape(gm, -1)
    usq = np.sum(x * u, axis=(1, 2))[:, None]
    np.testing.assert_allclose(out, np.concatenate([gu, bu, usq], axis=1),
                               rtol=1e-12)


@pytest.mark.parametrize("p", list(range(1, 33)))
def test_k3_row_bucket_is_the_smallest_that_holds_p(p):
    bucket = alpha_plan(p, 10)[0]
    assert bucket == min(b for b in ROW_BUCKETS if b >= p)
    assert bucket == (8 if p <= 8 else 16 if p <= 16 else 32)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n_ct,n_u,n_s", [(2, 1, 6), (10, 2, 6), (27, 2, 20)],
                         ids=["p3-bucket8", "p12-bucket16",
                              "p29-bucket32-20cols"])
def test_k3_twin_matches_pallas_at_each_bucket(n_ct, n_u, n_s, dtype):
    """K3's twin (``fw_phase_full`` on CPU tensors) against the JAX
    ``fw_phase_full`` at each row bucket, and past 16 columns (the
    kernel's blocks of 8 columns with the ticketed cost)."""
    blocks = _grams(120, n_s, n_ct, n_u, dtype, seed=n_ct + n_s)
    (al_w, lw_w, cost_w), alpha_t, scal = _k3_both(*blocks, 12, n_u)
    atol = 1e-12 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(alpha_t.numpy(), al_w, rtol=0, atol=atol)
    np.testing.assert_allclose(float(scal[ck.L_W]), float(lw_w),
                               rtol=100 * atol)
    scale = float(np.sum(blocks[4]))
    np.testing.assert_allclose(float(scal[ck.COST]) / scale,
                               float(cost_w) / scale, rtol=0, atol=atol)
    assert alpha_plan(n_ct + n_u, n_s)[2] == (1 if n_s <= 16 else 3)
    assert cuda_small.fw_phase_full.launches == 0


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_k4_twin_matches_pallas_past_one_group(dtype):
    """K4's twin against the JAX K4 (interpret mode) with weights at
    B = 20, n_u = 2: more members than one group takes at the plan's
    budget in float64, with two members inactive."""
    rng = np.random.default_rng(33)
    n, n_s, n_ct, n_u, n_b = 150, 6, 4, 2, 20
    assert k4_member_plan(8, n_s, n_ct, n_u, n_b, True,
                          "resident")["group"] < n_b
    p = n_ct + n_u
    R = rng.uniform(size=(n, p))
    d = rng.poisson(50, size=(n, n_s)) + 1.0
    y = np.clip(R @ rng.dirichlet(np.ones(p), size=n_s).T
                + 0.01 * rng.normal(size=(n, n_s)), 0, 1)
    alpha_b = np.stack([rng.dirichlet(np.ones(p), size=n_s).T
                        for _ in range(n_b)])
    u_b = rng.uniform(size=(n_b, n_u, n))
    up_b = np.clip(u_b + 0.05 * rng.normal(size=u_b.shape), 0, 1)
    w = rng.integers(0, 4, size=(n_b, n)).astype(np.float64)
    y, d, R, alpha_b, u_b, up_b, w = (np.asarray(x, dtype) for x in
                                      (y, d, R, alpha_b, u_b, up_b, w))
    active = np.ones(n_b, dtype)
    active[[4, 13]] = 0
    l_w = (np.sum(alpha_b[:, -n_u:] ** 2, axis=(1, 2))
           * d.max() ** 2).astype(dtype)
    a = np.linspace(1.2, 2.4, n_b).astype(dtype)
    j = jnp.asarray
    want = j_k4(j(_pad(y.T)), j(_pad(d.T)), j(_pad(R[:, :n_ct].T)),
                j(alpha_b[:, :n_ct]), j(alpha_b[:, n_ct:]), j(_pad(u_b)),
                j(_pad(up_b)), j(a), j(l_w), j((0.9 * l_w).astype(dtype)), 4,
                active=j(active), weights=j(_pad(w)), tile=TILE)
    u_w, up_w, _, _, gu_w, bu_w, usq_w = (np.asarray(x) for x in want)

    scal_b = np.zeros((n_b, ck.N_SCAL_MULTI), dtype)
    scal_b[:, ck.A_U], scal_b[:, ck.L_W] = a, l_w
    scal_b[:, ck.L_W_PREV], scal_b[:, ck.ACTIVE] = 0.9 * l_w, active
    uut_b = _t(np.concatenate([u_b, up_b], axis=1))
    uut_0 = uut_b.clone()
    alpha_t = _t(alpha_b)
    gu, bu, usq = cuda_multi.u_phase_grams_multi(
        _t(np.concatenate([y.T, d.T])), _t(R[:, :n_ct].T),
        alpha_t[:, :n_ct], alpha_t[:, n_ct:], uut_b, _t(scal_b), 4,
        weights=_t(w))
    tol = (dict(rtol=0, atol=1e-10) if dtype == np.float64
           else dict(rtol=1e-5, atol=1e-5))
    act = active > 0
    np.testing.assert_allclose(uut_b[act, :n_u].numpy(), u_w[act, :, :n],
                               **tol)
    np.testing.assert_allclose(uut_b[act, n_u:].numpy(), up_w[act, :, :n],
                               **tol)
    assert torch.equal(uut_b[~act], uut_0[~act])
    scale = np.abs(gu_w[act]).max(axis=(1, 2, 3))[:, None, None, None]
    np.testing.assert_allclose(gu.numpy()[act] / scale, gu_w[act] / scale,
                               **tol)
    np.testing.assert_allclose(bu.numpy()[act] / scale[..., 0],
                               bu_w[act] / scale[..., 0], **tol)
    np.testing.assert_allclose(usq.numpy()[act], usq_w[act],
                               rtol=max(tol["rtol"], 1e-12))
    assert cuda_multi.u_phase_grams_multi.launches == 0
