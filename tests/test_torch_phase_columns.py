"""K9's and K10's plan (``cuda_small.phase_plan``; the kernels'
``dm_alpha_phase_plan`` and ``dm_fw_phase_plan``, which
``chip_smoke.phase_layouts`` holds it to on the card): the form each
takes at p rows, which since the column blocks is every p.

- p = 1-1000 in both dtypes: a form for every p, none refused: the
  register form to 32 rows (the row bucket 8, 16 or 32), the two-row form
  to 64 (its slab under the card's limit), above 64 K2's column plan for
  K9 and K3's for K10 (``alpha_column_plan``, ``fw_column_plan``),
  equal entry by entry; the device slabs exactly where those plans give
  no block (past 8), with ``glue_work`` > 0 there.
- The pinned edges: the last single block, the first cluster of two and
  the first device-slab shape of each kernel in each dtype.
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
    MAX_COLUMN_BLOCKS,
    PHASE_FORMS,
    alpha_column_plan,
    fw_column_plan,
    glue_work,
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
        if cols["blocks"]:
            assert plan["form"] == "column_blocks"
            assert 1 <= cols["blocks"] <= MAX_COLUMN_BLOCKS
            assert cols["bytes"] <= LIMIT
        else:
            assert plan["form"] == "device_slabs"
            for n_s in (1, 10, 32, 100):
                assert glue_work(itemsize, p, n_s) == min(n_s, 32) * (
                    p * p + 6 * p) > 0


# (kernel, itemsize) -> (the last single block, the first device slabs)
EDGES = {("alpha", 8): (166, 453), ("alpha", 4): (237, 651),
         ("fw", 8): (168, 473), ("fw", 4): (239, 673)}


@pytest.mark.parametrize("key", sorted(EDGES), ids=lambda k: f"{k[0]}-{k[1]}")
def test_phase_plan_edges_are_pinned(key):
    kernel, itemsize = key
    last_one, first_slabs = EDGES[key]
    assert phase_plan(kernel, itemsize, last_one)["blocks"] == 1
    assert phase_plan(kernel, itemsize, last_one + 1)["blocks"] == 2
    assert phase_plan(kernel, itemsize, first_slabs - 1)["blocks"] == 8
    assert phase_plan(kernel, itemsize,
                      first_slabs)["form"] == "device_slabs"
    forms = [phase_plan(kernel, itemsize, p)["form"] for p in range(65, 1001)]
    assert forms == (["column_blocks"] * (first_slabs - 65)
                     + ["device_slabs"] * (1001 - first_slabs))


@pytest.mark.parametrize("p,form", [(6, "register"), (40, "two_row"),
                                    (100, "column_blocks"),
                                    (490, "device_slabs")])
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
    and past 8 column blocks the wrappers run their twins, which a launch
    on the card is held to."""
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
