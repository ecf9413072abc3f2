"""The n_u > 8 form's state plan: where K1's and K4's per-site FISTA state
lives above eight unknowns, and how many bytes it takes.

The state (u, u_prev, the step vectors, C and the curvature terms M of
the gram form; the residual and gradient rows of the direct form) lives
in a per-thread column of a state region of shared memory,
``cuda_kernels.state_rows`` rows of 129 values a block
(``csrc/u_phase_common.cuh``). These tests hold the plan at the shapes
users run it at: the model-selection sweep's ranks 9-25 at 10 samples
with 5 known types (the direct form), and the cohort's n_s = 100 with
n_u 9-17 (the gram form, 5 and 25 known types), in float32 and float64:
the region fits one block's shared memory there (no device memory), the
planned layout's bytes are within ``SMEM_LIMIT``, and K4's member plan
takes the same region once a block. The CUDA kernels cannot run here;
``chip_smoke.phase_layouts`` holds these formulas to the kernels'
exports on the card.
"""

import pytest

from demethify_tpu_torch.ops import cuda_kernels, cuda_multi
from demethify_tpu_torch.ops.cuda_kernels import (
    REG_N_U,
    SMEM_LIMIT,
    SMEM_PER_SM,
    blocks_per_sm,
    gram_form,
    state_in_device,
    state_rows,
    u_phase_layout,
    u_phase_smem,
)

LD = cuda_kernels.SITES_PER_BLOCK + 1
SWEEP = [(10, 5, n_u) for n_u in range(REG_N_U + 1, 26)]
COHORT = [(100, n_ct, n_u) for n_ct in (5, 25)
          for n_u in range(REG_N_U + 1, 18)]


def test_no_state_region_at_eight_unknowns_or_fewer():
    """The register forms keep their layouts' bytes: no region rows."""
    for n_u in range(1, REG_N_U + 1):
        for n_s in (1, 10, 100, 500):
            assert state_rows(n_s, n_u) == 0
            assert state_rows(n_s, n_u, True) == 0
            assert not state_in_device(8, n_s, n_u, not gram_form(n_u, n_s))


@pytest.mark.parametrize("itemsize", [4, 8], ids=["float32", "float64"])
@pytest.mark.parametrize("n_s,n_ct,n_u", SWEEP,
                         ids=[f"sweep-5+{s[2]}" for s in SWEEP])
def test_sweep_ranks_keep_the_state_on_the_chip(itemsize, n_s, n_ct, n_u):
    """The sweep's ranks past 8 (direct form at n_s = 10): two u vectors,
    the ten residual rows, no gradient rows (one chunk of samples); the
    planned layout holds it all, in float32 (the sweep's default) the
    resident layout with room for several blocks an SM."""
    assert not gram_form(n_u, n_s)
    rows = state_rows(n_s, n_u, True)
    assert rows == 2 * n_u + n_s
    assert not state_in_device(itemsize, n_s, n_u, True)
    layout, smem = u_phase_layout("K1", itemsize, n_s, n_ct, n_u, True)
    assert smem <= SMEM_LIMIT
    p = n_ct + n_u
    if layout == "resident":
        # a2 as a table of rows padded to 12 values (16-byte loads)
        assert smem == itemsize * ((3 * n_s + p + rows) * LD + n_ct * n_s
                                   + n_u * 12)
    else:
        assert layout == "wide" and itemsize == 8
        assert smem == itemsize * (max(2 * n_s, rows) + p) * LD
    # the region is 2 n_u + n_s rows of 129 values: at n_u = 25 31.0 KB
    # in float32 (three blocks an SM), 61.9 KB in float64
    assert blocks_per_sm(smem) >= (3 if itemsize == 4 else 1)
    if itemsize == 4:
        assert layout == "resident"


@pytest.mark.parametrize("itemsize", [4, 8], ids=["float32", "float64"])
@pytest.mark.parametrize("n_s,n_ct,n_u", COHORT,
                         ids=[f"cohort-{s[1]}+{s[2]}" for s in COHORT])
def test_cohort_widths_keep_the_state_on_the_chip(itemsize, n_s, n_ct, n_u):
    """The gram form at n_s = 100 (n_u up to 17, the widest gram shape
    there): M, C and three u vectors in the region, which overlays the
    wide and global layouts' chunk rows; the planned layout fits one
    block, and only the global layout's device rows ([Rt | u]) leave the
    chip, never the state."""
    assert gram_form(n_u, n_s)
    rows = state_rows(n_s, n_u)
    assert rows == 4 * n_u + n_u * (n_u + 1) // 2
    assert not state_in_device(itemsize, n_s, n_u)
    layout, smem = u_phase_layout("K1", itemsize, n_s, n_ct, n_u)
    assert smem <= SMEM_LIMIT
    assert smem == u_phase_smem(layout, itemsize, n_s, n_ct, n_u)
    lead = max(2 * 32, rows)
    if layout == "wide":
        assert smem == itemsize * (lead + n_ct + n_u) * LD
    elif layout == "global":
        assert smem == itemsize * lead * LD
    # M alone at n_u = 17: 153 rows, 158 KB in float64
    if n_u == 17 and itemsize == 8:
        assert itemsize * (n_u * (n_u + 1) // 2) * LD == 157_896


@pytest.mark.parametrize("itemsize", [4, 8], ids=["float32", "float64"])
@pytest.mark.parametrize("n_u", [9, 12, 16, 17])
def test_k4_takes_one_state_region_a_block(itemsize, n_u):
    """K4's member groups share one region (each member's loop reuses
    it): the group's bytes grow by its u rows and alpha blocks only, and
    the group keeps within one block's shared memory."""
    n_s, n_ct = 100, 5
    layout = u_phase_layout("K4", itemsize, n_s, n_ct, n_u)[0]
    rows = state_rows(n_s, n_u)
    one = cuda_multi.k4_smem(itemsize, n_s, n_ct, n_u, False, layout, 1)
    two = cuda_multi.k4_smem(itemsize, n_s, n_ct, n_u, False, layout, 2)
    assert one == u_phase_smem(layout, itemsize, n_s, n_ct, n_u)
    if layout != "global":
        per_member = itemsize * n_u * LD + (
            0 if layout == "wide" else itemsize * (n_ct + n_u) * n_s)
        assert two - one == per_member
    plan = cuda_multi.k4_member_plan(itemsize, n_s, n_ct, n_u, 16, False,
                                     layout)
    assert 1 <= plan["group"] <= 16 and plan["smem"] <= SMEM_LIMIT
    assert plan["blocks"] * (plan["smem"] + 1024) <= SMEM_PER_SM or (
        plan["blocks"] == 1)
    assert rows * LD * itemsize <= plan["smem"] or layout == "resident"


@pytest.mark.parametrize("itemsize,n_s,n_u", [
    (8, 108, 18), (8, 500, 30), (4, 226, 26), (4, 1000, 40)])
def test_state_past_the_chip_goes_to_device_memory(itemsize, n_s, n_u):
    """Past one block's shared memory in every layout (the gram form at
    n_u >= 18 in float64, 26 in float32) the region lives in device
    memory: the global layout then holds one chunk of Y and D alone, and
    the wrapper allocates ``state_rows`` x 129 values a block."""
    assert gram_form(n_u, n_s)
    assert state_in_device(itemsize, n_s, n_u)
    for layout in ("resident", "wide"):
        assert u_phase_smem(layout, itemsize, n_s, 5, n_u) > SMEM_LIMIT
    assert u_phase_layout("K1", itemsize, n_s, 5, n_u) == (
        "global", itemsize * 2 * 32 * LD)
    assert cuda_multi.k4_smem(itemsize, n_s, 5, n_u, False, "global",
                              1) == itemsize * 2 * 32 * LD


# Byte counts worked out by hand from the kernels' layout (rows of 129
# values), so that a change to the Python formulas shows here and not
# only against the kernels' exports on the card:
#   rank 25 (float32, 1M x 10, 5 + 25, direct, resident): Y, D, the
#     residual rows (3 x 10), [Rt | u] staged (30) and the region
#     (2 x 25 + 10 = 60): 120 rows = 15480 values, plus the alpha table
#     5 x 10 + 25 x 12 = 350 values: 15830 x 4 = 63320 bytes, 3 blocks
#     an SM;
#   n_u = 17 (float64, n_s = 100, gram): the region 4 x 17 + 153 = 221
#     rows = 228072 bytes in the global layout, 1 block an SM; the wide
#     layout's 221 + 22 rows (250776 bytes) pass the limit;
#   n_u = 18 (float64, n_s = 108, gram): the region 4 x 18 + 171 = 243
#     rows, 250776 bytes a block in device memory; the global layout
#     keeps 2 x 32 rows of Y and D, 66048 bytes;
#   n_u = 12 (float64, n_s = 40, direct, two chunks): 2 x 12 + 32 + 12
#     = 68 rows; resident 2 x 40 + 40 + 17 + 68 = 205 rows and
#     5 x 40 + 12 x 40 = 680 alpha values, 27125 x 8 = 217000 bytes, one
#     block an SM, so the wide layout: max(2 x 32, 68) + 17 = 85 rows,
#     87720 bytes, 2 blocks an SM.
PINNED = [
    # (state bytes, n_s, n_ct, n_u, direct, region rows, in device,
    #  layout, layout bytes, blocks per SM)
    (4, 10, 5, 25, True, 60, False, "resident", 63_320, 3),
    (8, 100, 5, 17, False, 221, False, "global", 228_072, 1),
    (8, 108, 5, 18, False, 243, True, "global", 66_048, 3),
    (8, 40, 5, 12, True, 68, False, "wide", 87_720, 2)]


@pytest.mark.parametrize(
    "itemsize,n_s,n_ct,n_u,direct,rows,device,layout,smem,per_sm", PINNED,
    ids=["rank25-f32", "gram17-f64", "gram18-f64-device",
         "direct12-f64-n_s40"])
def test_pinned_bytes(itemsize, n_s, n_ct, n_u, direct, rows, device,
                      layout, smem, per_sm):
    """The region's rows, where it lives, the planned layout, its bytes and
    its blocks per SM at four shapes, against numbers worked out by hand
    (above), not against the formulas themselves."""
    assert state_rows(n_s, n_u, direct) == rows
    assert state_in_device(itemsize, n_s, n_u, direct) is device
    assert u_phase_layout("K1", itemsize, n_s, n_ct, n_u, direct) == (
        layout, smem)
    assert blocks_per_sm(smem) == per_sm
    if device:
        assert itemsize * rows * LD == 250_776
    if (itemsize, n_s, n_u) == (8, 40, 12):
        assert u_phase_smem("resident", 8, 40, 5, 12, True) == 217_000


def test_widest_shapes_on_the_chip():
    """The largest n_u whose gram-form region fits one block: 17 in
    float64, 25 in float32 (the bounds PERF.md names)."""
    def widest(itemsize):
        return max(n_u for n_u in range(REG_N_U + 1, 64)
                   if not state_in_device(itemsize, 3 * n_u * n_u, n_u))
    assert widest(8) == 17
    assert widest(4) == 25


# The layout rule above n_u = 8, at the shapes it was fitted to on an H100
# (``chip_smoke.time_layouts``: each layout forced, 1M sites): the
# layout it plans was measured fastest in K1 at all of them but one (the
# gram form at n_u = 17 in float32, where the global layout took 12% less
# time in K1 and 3% more in K4; the rule keeps the global layout for
# shapes the wide one cannot hold).
RULE = [
    # (state bytes, n_s, n_u, planned layout)
    (4, 10, 9, "resident"), (4, 10, 12, "resident"), (4, 10, 16, "resident"),
    (4, 10, 25, "resident"), (8, 10, 9, "resident"), (8, 10, 12, "resident"),
    (8, 10, 16, "resident"), (8, 10, 25, "wide"), (4, 100, 9, "wide"),
    (4, 100, 12, "wide"), (4, 100, 17, "wide"), (8, 100, 9, "wide"),
    (8, 100, 12, "wide"), (8, 100, 17, "global")]


@pytest.mark.parametrize("itemsize,n_s,n_u,want", RULE,
                         ids=[f"{'f32' if r[0] == 4 else 'f64'}-n_s{r[1]}"
                              f"-5+{r[2]}" for r in RULE])
def test_layout_rule_above_eight_unknowns(itemsize, n_s, n_u, want):
    """Above n_u = 8 the resident layout gives way to the wide one where it
    does not fit, or fits one block per SM and the wide one two or more;
    the global layout takes what the wide one cannot hold. K4 plans with
    the same rule."""
    direct = not gram_form(n_u, n_s)
    layout, smem = u_phase_layout("K1", itemsize, n_s, 5, n_u, direct)
    assert layout == want
    res = u_phase_smem("resident", itemsize, n_s, 5, n_u, direct)
    wide = u_phase_smem("wide", itemsize, n_s, 5, n_u, direct)
    if want == "resident":
        assert blocks_per_sm(res) >= 2 or blocks_per_sm(wide) < 2
    elif want == "wide":
        assert res > SMEM_LIMIT or (
            blocks_per_sm(res) == 1 and blocks_per_sm(wide) >= 2)
    else:
        assert wide > SMEM_LIMIT
    if not direct:
        assert u_phase_layout("K4", itemsize, n_s, 5, n_u)[0] == want


def test_direct_form_at_eight_unknowns_stays_resident():
    """The rule's change is the n_u > 8 form's alone: at n_u <= 8 the
    direct form keeps the resident layout wherever it fits, even where
    the wide one would fit twice its blocks (measured up to 2.1x slower
    there)."""
    for itemsize in (4, 8):
        for n_u in range(2, REG_N_U + 1):
            for n_s in range(1, (n_u * n_u - 1) // 3 + 1):
                res = u_phase_smem("resident", itemsize, n_s, 25, n_u, True)
                if res <= SMEM_LIMIT:
                    assert u_phase_layout("K1", itemsize, n_s, 25, n_u,
                                          True)[0] == "resident"
