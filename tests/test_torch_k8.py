"""K8 ``grams`` on the tensor cores (``csrc/grams.cu``), what the CPU can
hold of it: the launch plan (every site in whole tiles, every sample and
column in a block, shared memory under the card's limit, the raise
naming shape and bytes), the kernel's output map mirrored in numpy
(every entry of the partial buffer written by exactly one lane and
register, every G, b and ydy entry by the second pass), a plain
emulation of the float32 route's arithmetic (TF32 rounding by bit
masking, the 3xTF32 pair-form sums one tile of sites at a time, carried
in float32) held to the twin ``grams_plain`` within the float32 Gram
tolerance, and the wrapper's CPU route (the twin itself). The kernel runs
only on the card (``chip_smoke.py`` phase 9).
"""

import numpy as np
import pytest
import torch

from demethify_tpu_torch.ops import cuda_kernels
from demethify_tpu_torch.ops.cuda_kernels import (
    grams, grams_entries, grams_plain, grams_plan, grams_smem)

GRAM_TOL32 = 5e-5      # chip_smoke.TOL["float32"]["gram"]
KINDS = (0, 1, 2)      # float32, float64, bf16 data
SHAPES = ((1_000_000, 10, 6), (1_000_000, 100, 29), (1_000_003, 10, 6),
          (200, 10, 6), (1_000_000, 1, 1), (1_000_000, 13, 11),
          (70_000, 500, 64), (20_000, 100, 29), (5_000, 33, 40))
MR, WM, ACC = (16, 8, 16), (2, 4, 2), (4, 2, 4)


def _inputs(n, n_s, p, seed):
    """Yt, Dt (n_s, n), Rt (p, n) float32, as ``chip_smoke._grams_inputs``
    draws them: R uniform, D Poisson(50) + 1, Y a clamped mixture of R."""
    rng = np.random.default_rng(seed)
    rt = rng.random((p, n), dtype=np.float32)
    d = (rng.poisson(50.0, (n_s, n)) + 1).astype(np.float32)
    e = rng.exponential(size=(p, n_s)).astype(np.float32)
    y = np.clip((e / e.sum(0)).T @ rt, 0, 1).astype(np.float32)
    return (torch.from_numpy(np.ascontiguousarray(x)) for x in (y, d, rt))


# --------------------------------------------------------------- the plan

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,n_s,p", SHAPES)
def test_plan_covers_sites_samples_columns(n, n_s, p, kind):
    plan = grams_plan(n, n_s, p, kind)
    assert plan.chunk_sites % plan.tile == 0
    assert (plan.n_chunks - 1) * plan.chunk_sites < n <= (
        plan.n_chunks * plan.chunk_sites)
    assert ((plan.n_groups - 1) * plan.group_samples < n_s
            <= plan.n_groups * plan.group_samples)
    assert 1 <= plan.slices <= 8 and plan.items * plan.slices <= 16
    assert plan.slices <= plan.tile // (8, 4, 16)[kind]
    assert plan.smem == grams_smem(kind, p, plan.group_samples, plan.tile,
                                   plan.stages, plan.items, plan.slices)
    assert plan.smem <= cuda_kernels.SMEM_LIMIT
    # the partial buffer stays a few columns per SM (tens of MB at most)
    width = n_s * grams_entries(p, kind)
    assert plan.n_chunks * width * (8 if kind == 1 else 4) < 64e6
    if kind == 2:
        mts, nts = -(-(p + 1) // 16), -(-(p + 1) // 8)
        tps = -(-mts // 2) * -(-nts // 4)
        assert plan.col_groups == 1
        assert plan.items == plan.group_samples * tps
    else:
        assert plan.group_samples <= WM[kind] * MR[kind]
        ranges = -(-(p * (p + 1) // 2) // 32) + -(-p // 32)
        assert plan.col_groups * plan.items >= ranges


def test_plan_raises_naming_shape_and_bytes():
    with pytest.raises(NotImplementedError, match=r"n_s = 100, p = 250.*"
                                                  r"bytes"):
        grams_plan(1_000_000, 100, 250, 1)
    with pytest.raises(NotImplementedError, match="p = 128"):
        grams_plan(1_000_000, 10, 128, 2)
    assert grams_plan(1_000_000, 10, 127, 2).items == 16


# ------------------------------------------------------- the output map

def _pair_rows(c, p):
    q = 0
    while c >= p - q:
        c -= p - q
        q += 1
    return q, q + c


def _partial_writes(n_s, p, kind, plan):
    """Every (sample, entry) the main pass writes, one per lane and
    register, as ``grams_kernel`` maps its accumulators (csrc/grams.cu):
    float32 c0..c3 at (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
    of each 16 x 8 tile, float64 c0, c1 at (g, 2t), (g, 2t + 1) of each
    8 x 8; ydy from the first column group's threads."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    e_s = grams_entries(p, kind)
    writes = []
    np_ = p * (p + 1) // 2
    for sgi in range(plan.n_groups):
        s0 = sgi * plan.group_samples
        gs = min(plan.group_samples, n_s - s0)
        for cg in range(plan.col_groups):
            if kind != 2 and cg == 0:
                writes += [(s0 + s) * e_s + e_s - 1 for s in range(gs)]
            for item in range(plan.items):
                writes += _warp_writes(n_s, p, kind, plan, s0, gs, cg,
                                       item, g, t, np_, e_s)
    return writes


def _warp_writes(n_s, p, kind, plan, s0, gs, cg, item, g, t, np_, e_s):
    out = []
    wm = WM[kind]
    if kind != 2:
        # warp tiles of G's pair columns, then of b's
        nrp, nrb = -(-np_ // 32), -(-p // 32)
        nr = cg * plan.items + item
        if nr >= nrp + nrb:
            return out
        wb = nr >= nrp
        t0 = (nr - nrp if wb else nr) * 4
        mts = -(-gs // MR[kind])
        for m in range(min(wm, mts)):
            for i in range(4):
                for a in range(ACC[kind]):
                    row = m * MR[kind] + g + (8 if ACC[kind] == 4 and a >= 2
                                              else 0)
                    c = (t0 + i) * 8 + 2 * t + (a & 1)
                    for rw, cc in zip(row, c):
                        if rw >= gs or cc >= (p if wb else np_):
                            continue
                        out.append((s0 + rw) * e_s + (np_ + cc if wb else cc))
        return out
    mts_s, nts = -(-(p + 1) // 16), -(-(p + 1) // 8)
    nrs = -(-nts // 4)
    tps = -(-mts_s // wm) * nrs
    sb, tl = divmod(item, tps)
    if sb >= gs:
        return out
    mt0, nt0 = tl // nrs * wm, tl % nrs * 4
    for m in range(min(wm, mts_s - mt0)):
        for i in range(4):
            for a in range(4):
                q = (mt0 + m) * 16 + g + (8 if a >= 2 else 0)
                r = (nt0 + i) * 8 + 2 * t + (a & 1)
                for qq, rr in zip(q, r):
                    if qq > p or rr > p or (qq < p and rr == p):
                        continue
                    k = (qq * p + rr if qq < p
                         else (p * p + rr if rr < p else p * p + p))
                    out.append((s0 + sb) * e_s + k)
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n_s,p", ((10, 6), (100, 29), (1, 1), (13, 11),
                                   (3, 1), (33, 40), (500, 64)))
def test_every_entry_written_once(n_s, p, kind):
    plan = grams_plan(70_000, n_s, p, kind)
    writes = np.asarray(_partial_writes(n_s, p, kind, plan))
    e_s = grams_entries(p, kind)
    counts = np.bincount(writes, minlength=n_s * e_s)
    assert counts.shape == (n_s * e_s,) and (counts == 1).all()
    # the second pass: each entry to G (and its mirror), b or ydy
    G = np.zeros((n_s, p, p), int)
    b = np.zeros((p, n_s), int)
    ydy = np.zeros(n_s, int)
    n_g = p * p if kind == 2 else p * (p + 1) // 2
    for e in range(n_s * e_s):
        s, k = divmod(e, e_s)
        if k < n_g:
            q, r = divmod(k, p) if kind == 2 else _pair_rows(k, p)
            G[s, q, r] += 1
            if kind != 2 and q != r:
                G[s, r, q] += 1
        elif k < n_g + p:
            b[k - n_g, s] += 1
        else:
            ydy[s] += 1
    assert (G == 1).all() and (b == 1).all() and (ydy == 1).all()


# ------------------------------------------- the float32 route, emulated

def _tf32(x):
    """cvt.rna.tf32.f32: round to nearest, ties away from zero, on the 13
    low mantissa bits (non-negative and negative alike: the bit pattern's
    magnitude gains half a TF32 ulp, then loses the low bits)."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    """hi = x rounded to TF32, lo = x - hi (exact) cut to TF32 (its low 13
    bits cleared), as ``split`` in csrc/grams.cu."""
    hi = _tf32(x)
    return hi, ((x - hi).view(torch.int32) & ~0x1FFF).view(torch.float32)


def grams_3xtf32(yt, dt, rt, k_sites=64, chunk=1024):
    """The kernel's float32 route in plain ops: the pair products r_q r_r
    (q <= r) and d y rounded once in float32; every factor split into TF32
    hi and lo; per tile of 64 sites the terms hi hi + hi lo + lo hi summed
    in float32 (products of TF32 values are exact in float32), the tiles'
    sums carried in float32; b on [R; 1] pairs against d y, ydy
    elementwise; G mirrored from its pairs."""
    n_s, n = yt.shape
    p = rt.shape[0]
    q, r = torch.triu_indices(p, p)
    dy = dt * yt
    ydy = torch.sum(dy * yt, dim=1)
    Gp = torch.zeros((n_s, q.numel()), dtype=torch.float32)
    b = torch.zeros((n_s, p), dtype=torch.float32)

    def ksteps(a, w):
        """(n_s, m) sites -> (n_s, w rows) summed per tile, then carried."""
        ah, al = _split(a.reshape(n_s, -1, k_sites))
        bh, bl = _split(w.reshape(w.shape[0], -1, k_sites))
        per = (torch.einsum("skj,ckj->ksc", ah, bl)
               + torch.einsum("skj,ckj->ksc", al, bh)
               + torch.einsum("skj,ckj->ksc", ah, bh))
        return per.sum(dim=0)

    pad = -n % k_sites
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        extra = pad if hi == n else 0

        def cut(x):
            x = x[:, lo:hi]
            return torch.nn.functional.pad(x, (0, extra)) if extra else x
        rc = cut(rt)
        Gp += ksteps(cut(dt), rc[q] * rc[r])
        b += ksteps(cut(dy), rc)
    G = torch.empty((n_s, p, p), dtype=torch.float32)
    G[:, q, r] = Gp
    G[:, r, q] = Gp
    return G, b.T.contiguous(), ydy


def test_tf32_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -12, 1.0 + 3 * 2 ** -12,
                      -(1.0 + 2 ** -11), 1.0 + 2 ** -11 + 2 ** -23])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -10,
                         -(1.0 + 2 ** -10), 1.0 + 2 ** -10])
    assert torch.equal(_tf32(x), want)
    hi, lo = _split(torch.tensor([1.0 / 3.0]))
    assert abs(float(hi) + float(lo) - 1.0 / 3.0) < 2 ** -22


@pytest.mark.parametrize("n,n_s,p", ((200_000, 10, 6), (20_000, 100, 29),
                                     (1_003, 13, 11)))
def test_3xtf32_route_within_the_float32_gram_bound(n, n_s, p):
    """The split products and short float32 runs stay within 5e-5 of each
    output's largest entry against the twin, the bound the kernel is held
    to on the card."""
    yt, dt, rt = _inputs(n, n_s, p, seed=n + p)
    want = grams_plain(yt, dt, rt)
    got = grams_3xtf32(yt, dt, rt)
    rel = [float((g - w).abs().max() / w.abs().max())
           for g, w in zip(got, want)]
    assert max(rel) <= GRAM_TOL32, rel


# ---------------------------------------------------------- the CPU route

def test_cpu_tensors_take_the_twin():
    yt, dt, rt = _inputs(3_000, 5, 4, seed=3)
    before = (grams.launches, grams.launches_bf16)
    for x in ((yt, dt, rt), tuple(v.double() for v in (yt, dt, rt)),
              tuple(v.to(torch.bfloat16) for v in (yt, dt, rt))):
        got, want = grams(*x), grams_plain(*x)
        assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert (grams.launches, grams.launches_bf16) == before
