"""K9's and K10's plan (``cuda_small.phase_plan``; the kernels'
``dm_alpha_phase_plan`` and ``dm_fw_phase_plan``, which
``chip_smoke.phase_layouts`` holds it to on the card): the form each
takes at p rows, which since the column blocks is every p.

- p = 1-1000 in both dtypes: a form for every p, none refused: the
  register form to 32 rows (the row bucket 8, 16 or 32), the two-row form
  to 64 (its slab under the card's limit), above 64 K2's column plan for
  K9 and K3's for K10 (``alpha_column_plan``, ``fw_column_plan``),
  equal entry by entry; the device rows exactly where those plans keep
  G_s's rows in device memory (past 16 blocks), with ``column_work`` > 0
  there.
- p = 65-20000 in both dtypes: every plan launchable (at most 16 blocks
  of at most 1024 threads, the bytes under the card's limit, every row
  owned by one thread of one block), and every p has a form.
- The pinned edges: the last single block, the first cluster of two, the
  last cluster of 16 and the first device-rows shape of each kernel in
  each dtype.
- The wrappers count a launch under its plan's form
  (``_count_phase``), and on CPU tensors run their twins at every form's
  shapes (no refusal past one block's shared memory).

The CUDA kernels have no CPU mode; ``chip_smoke.py``
(``phase_wide_glue``) holds them to their twins and to K2's and K3's
bits on the card.
"""

import numpy as np
import pytest
import torch

from demethify_tpu_torch.ops import cuda_small
from demethify_tpu_torch.ops.cuda_kernels import SMEM_LIMIT
from demethify_tpu_torch.ops.cuda_small import (
    DEVICE_ROW_THREADS,
    MAX_COLUMN_BLOCKS,
    PHASE_FORMS,
    alpha_column_plan,
    column_work,
    fw_column_plan,
    phase_plan,
)

LIMIT = SMEM_LIMIT - 1024
COLUMN_PLANS = {"alpha": alpha_column_plan, "fw": fw_column_plan}


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("kernel", ["alpha", "fw"])
def test_phase_plan_has_a_form_for_every_p(kernel, itemsize):
    for p in range(1, 1001):
        plan = phase_plan(kernel, itemsize, p)
        assert plan["form"] in PHASE_FORMS
        if p <= 32:
            assert plan["form"] == "register"
            assert plan["bucket"] == min(b for b in (8, 16, 32) if b >= p)
            assert plan["bytes"] == 0
            continue
        if p <= 64:
            assert plan["form"] == "two_row"
            assert plan["bucket"] == 64
            assert plan["bytes"] == itemsize * p * (p | 1) <= LIMIT
            continue
        cols = COLUMN_PLANS[kernel](itemsize, p)
        assert {k: plan[k] for k in cols} == cols
        assert plan["bucket"] == 0
        assert cols["bytes"] <= LIMIT
        assert 1 <= cols["blocks"] <= MAX_COLUMN_BLOCKS
        if cols["device"] == 0:
            assert plan["form"] == "column_blocks"
            assert column_work(kernel, itemsize, p, 10) == 0
        else:
            assert plan["form"] == "device_rows"
            assert cols["blocks"] == MAX_COLUMN_BLOCKS
            for n_s in (1, 10, 32, 100):
                assert column_work(kernel, itemsize, p, n_s) == (
                    n_s * MAX_COLUMN_BLOCKS * cols["rows"] * p) > 0


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("kernel", ["alpha", "fw"])
def test_device_rows_plan_launches_every_p(kernel, itemsize):
    """p = 65-20000: a launchable plan at every p (at most 16 blocks a
    cluster, a block at most 1024 threads in whole warps and its bytes
    under the card's limit, rows dealt so that each is one thread's of
    one block), the device rows past the last cluster of 16, the rows of
    p values in device memory too only where they pass the limit; the
    work buffer holds each block's rows."""
    p_rows, r_rows = {"alpha": (7, 0), "fw": (1, 2)}[kernel]
    plans = {"alpha": alpha_column_plan, "fw": fw_column_plan}[kernel]
    for p in range(65, 20001):
        plan = phase_plan(kernel, itemsize, p)
        assert plan["form"] in ("column_blocks", "device_rows")
        c, rows, threads = plan["blocks"], plan["rows"], plan["threads"]
        assert 1 <= c <= MAX_COLUMN_BLOCKS and rows == -(-p // c)
        assert threads % 32 == 0 and threads <= DEVICE_ROW_THREADS
        assert threads >= min(rows, DEVICE_ROW_THREADS)
        assert (c - 1) * rows < p <= c * rows    # no block without rows
        assert 0 <= plan["bytes"] <= LIMIT
        line = itemsize * (p_rows * p + r_rows * rows)
        if plan["form"] == "column_blocks":
            assert plan["device"] == 0 and threads <= 256
            assert plan["bytes"] == itemsize * rows * p + line
            continue
        assert c == MAX_COLUMN_BLOCKS
        assert itemsize * rows * p + line > LIMIT   # 16 blocks do not hold it
        block = rows * p
        if line <= LIMIT - 1024:      # 1 KB more for static shared memory
            assert plan["device"] == 1 and plan["bytes"] == line
        else:
            assert plan["device"] == 2 and plan["bytes"] == 0
            block += p_rows * p + r_rows * rows
        assert column_work(kernel, itemsize, p, 3) == 3 * c * block
        assert plans(itemsize, p) == {k: plan[k] for k in (
            "blocks", "rows", "threads", "device", "bytes")}


# (kernel, itemsize) -> (the last single block, the first device rows)
EDGES = {("alpha", 8): (166, 625), ("alpha", 4): (237, 905),
         ("fw", 8): (168, 671), ("fw", 4): (239, 947)}


@pytest.mark.parametrize("key", sorted(EDGES), ids=lambda k: f"{k[0]}-{k[1]}")
def test_phase_plan_edges_are_pinned(key):
    kernel, itemsize = key
    last_one, first_rows = EDGES[key]
    assert phase_plan(kernel, itemsize, last_one)["blocks"] == 1
    assert phase_plan(kernel, itemsize, last_one + 1)["blocks"] == 2
    assert phase_plan(kernel, itemsize, first_rows - 1)["blocks"] == 16
    assert phase_plan(kernel, itemsize, first_rows)["form"] == "device_rows"
    assert phase_plan(kernel, itemsize, first_rows)["blocks"] == 16
    forms = [phase_plan(kernel, itemsize, p)["form"] for p in range(65, 1001)]
    assert forms == (["column_blocks"] * (first_rows - 65)
                     + ["device_rows"] * (1001 - first_rows))


@pytest.mark.parametrize("p,form", [(6, "register"), (40, "two_row"),
                                    (100, "column_blocks"),
                                    (490, "column_blocks"),
                                    (700, "device_rows")])
def test_launches_count_under_their_form(p, form):
    forms = {}
    cuda_small._count_phase(forms, phase_plan("alpha", 8, p), masked=True)
    cuda_small._count_phase(forms, phase_plan("fw", 8, p))
    want = {"masked": 1}
    if form != "register":
        want[form] = 2
    assert forms == want


@pytest.mark.parametrize("p", [168, 238, 460, 700])
def test_wrappers_take_every_shape_on_the_cpu(p):
    """Past one block's shared memory (p = 168 in float64, 238 in float32)
    and past 16 column blocks (700) the wrappers run their twins, which a
    launch on the card is held to."""
    rng = np.random.default_rng(p)
    n_s, steps = 2, 3
    X = rng.uniform(size=(n_s, p + 4, p))
    G = torch.as_tensor(np.einsum("sip,siq->spq", X, X))
    b = torch.as_tensor(rng.uniform(size=(p, n_s)))
    alpha = torch.as_tensor(rng.dirichlet(np.ones(p), size=n_s).T.copy())
    l_h = float(torch.linalg.matrix_norm(G, ord=2).max())
    got = cuda_small.alpha_phase(G, b, alpha, alpha, 1.0, l_h, l_h, steps)
    want = cuda_small.alpha_phase_plain(
        G, b, alpha, alpha, torch.tensor(1.0, dtype=torch.float64),
        torch.tensor(l_h, dtype=torch.float64),
        torch.tensor(l_h, dtype=torch.float64), steps)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.isfinite(got[0]).all()
    np.testing.assert_allclose(got[0].sum(0).numpy(), 1.0, atol=1e-12)
    purity = torch.full((n_s,), 0.7, dtype=torch.float64)
    a1 = (alpha[:p - 1] / alpha[:p - 1].sum(0) * 0.7).contiguous()
    a2 = (alpha[p - 1:] / alpha[p - 1:].sum(0) * 0.3).contiguous()
    k1, k2 = cuda_small.fw_phase(G, b, a1, a2, purity, steps)
    np.testing.assert_allclose(k1.sum(0).numpy(), 0.7, atol=1e-12)
    np.testing.assert_allclose(k2.sum(0).numpy(), 0.3, atol=1e-12)
    assert cuda_small.alpha_phase.launches == 0
    assert cuda_small.fw_phase.launches == 0
