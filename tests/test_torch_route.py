"""The kernels' plans past one block's shared memory: K1/K4 take the
global layout (the [Rt | u] rows in device memory) where even the wide
layout would not fit, and K2/K3/K5/K6 keep G_s's rows in device memory
(the device rows) where a cluster of 16 blocks would not hold them, so a
CUDA tensor of any shape runs the kernels (``solvers.api`` has no other
route on the card). The plans are plain Python, so they are tested here
at the boundary shapes, float32, float64 and bf16 storage (a float32
state): where the rows stay in shared memory, and where they go to
device memory, nothing raises.

The boundaries, from the bytes of shared memory a block may use (232,448
on an H100; the glue kernels keep 1 KB of it):
- K2/K5 hold R = ceil(p / C) rows of G_s and seven rows of p in each of
  C <= 16 blocks: p <= 624 in float64, 904 in float32 (K3/K6 with alpha
  and two rows of R: 670 and 946); the one-block wide loop they replaced
  held one p x p + 6 p slab to p = 167 in float64, 237 in float32, whose
  warps the cost's groups keep;
- K1/K4's wide layout holds 2 min(n_s, 32) + p rows of 129 values (n_u
  more for K4's weights): at n_s >= 32, p <= 161 in float64 (159 with
  two weighted unknowns), 386 in float32.
"""

import pytest
import torch

from demethify_tpu_torch.ops.cuda_kernels import (
    SMEM_LIMIT,
    u_phase_layout,
    u_phase_smem,
)
from demethify_tpu_torch.ops.cuda_multi import k4_member_plan
from demethify_tpu_torch.ops.cuda_small import column_work, glue_smem
from demethify_tpu_torch.solvers import api

F64, F32, BF16 = torch.float64, torch.float32, torch.bfloat16


@pytest.mark.parametrize("dtype,n_s,n_ct,n_u,weighted,want", [
    (F64, 10, 166, 1, False, "shared"),      # p = 167: one old slab's last
    (F64, 10, 167, 1, False, "shared"),      # p = 168: a cluster of two
    (F32, 10, 236, 1, False, "shared"),      # p = 237
    (F32, 10, 237, 1, False, "shared"),      # p = 238
    (BF16, 10, 236, 1, False, "shared"),     # a float32 state
    (BF16, 10, 237, 1, False, "shared"),
    (F64, 10, 623, 1, False, "device"),      # p = 624: K1 global; the
    (F64, 10, 624, 1, False, "device"),      # glue's last cluster and
    (F32, 10, 903, 1, False, "device"),      # its first device rows
    (F32, 10, 904, 1, False, "device"),      # (p = 905)
    (F64, 64, 160, 1, False, "shared"),      # p = 161: K1 wide, last
    (F64, 64, 161, 1, False, "device"),      # p = 162: K1 global
    (F32, 64, 236, 1, False, "shared"),      # K1 wide, the glue in two
    (F32, 64, 237, 1, False, "shared"),      # blocks a column
    (F64, 10, 157, 10, False, "shared"),     # direct form (100 > 30)
    (F64, 10, 158, 10, False, "shared"),
    (F64, 64, 157, 2, True, "shared"),       # K4 weighted: p = 159
    (F64, 64, 158, 2, True, "device"),       # p = 160 weighted ...
    (F64, 64, 158, 2, False, "shared"),      # ... but not unweighted
    (F32, 10, 5, 1, False, "shared"),        # the main path
    (F32, 100, 25, 4, False, "shared"),      # the cohort
])
def test_solver_route_at_the_plans_boundaries(dtype, n_s, n_ct, n_u,
                                              weighted, want):
    state = 8 if dtype == F64 else 4
    p = n_ct + n_u
    direct = n_u * n_u > 3 * n_s
    layout, smem = u_phase_layout("k", state, n_s, n_ct, n_u, direct,
                                  weighted=weighted)
    assert smem <= SMEM_LIMIT
    wide = u_phase_smem("wide", state, n_s, n_ct, n_u, direct,
                        weighted=weighted)
    assert (layout == "global") == (wide > SMEM_LIMIT)
    n_warps, _ = glue_smem(state, p, n_s)
    assert (n_warps == 0) == (p > (167 if state == 8 else 237))
    work = column_work("alpha", state, p, n_s)
    assert (work > 0) == (p > (624 if state == 8 else 904))
    if work:
        assert work == n_s * 16 * -(-p // 16) * p
    if weighted and layout == "global":
        # 16 members in groups of 10: 2 x 32 rows of Y and D, the ring's
        # 2 slots of 4 rows of Rt and 10 x 2 x 2 u and w u rows, 112 rows
        # of 129 float64 values, two blocks an SM (one member: 108 rows)
        plan = k4_member_plan(state, n_s, n_ct, n_u, 16, True, layout)
        assert plan["group"] == 10 and plan["smem"] == 8 * 112 * 129
        assert smem == 8 * 108 * 129
    got = "device" if layout == "global" or work else "shared"
    assert got == want


@pytest.mark.parametrize("args,kw,want", [
    (("cuda", 1, 10, 4), {}, "batch"),
    (("cuda", 5, 10, 4), {}, "batch"),             # gram form: 25 <= 30
    (("cuda", 6, 10, 4), {}, "sequential"),        # direct form: 36 > 30
    (("cpu", 1, 10, 4), {}, "sequential"),         # the plain solvers
    (("cuda", 1, 10, 4), {"init": "SVD"}, "sequential"),   # one solve
    (("cuda", 1, 10, 4), {"init": "ICA"}, "sequential"),
    (("cuda", 1, 10, 4), {"init": "beta"}, "batch"),
])
def test_restart_route_takes_the_shape_route(args, kw, want):
    assert api.restart_route(*args, **kw) == want
