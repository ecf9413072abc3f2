"""K4, the multi-member U megakernel: wrapper, launch count and plain twin.

``u_phase_grams_multi`` replaces the Pallas kernel
``demethify_tpu/ops/pallas_kernels.py::_u_phase_grams_multi_kernel``
(through its wrapper ``u_phase_grams_multi``). The kernel is
``csrc/u_phase_grams_multi.cu``; its source note says what bounds it on
an H100 (instruction issue: B members' FISTA loops per site, against one
read of Y, D and Rt for all of them) and what the design does about it.

B restart members share Y, D and Rt. Each has its own alpha blocks, its
own ``[u.T; u_prev.T]`` rows and its own row of the multi-member scalar
matrix (``cuda_kernels.N_SCAL_MULTI`` slots: A_U, L_W, L_W_PREV read,
ACTIVE the solver's per-member termination flag). Members whose ACTIVE
slot is 0 are frozen: u, u_prev, A_U and L_W_PREV stay as they are, and
the kernel does not write their Gram blocks (the solver does not read
them; the twin computes them with the frozen u, as the JAX kernel does).
Gram form only, as the JAX kernel: the solver routes the direct form
(n_u^2 > 3 n_s) to sequential single-member solves.

``weights`` (B, N), the JAX kernel's operand of the same name (the
weighted bootstrap: one resample replicate per member, w its row
multiplicities), folds each member's weight row into its Gram sums only:
it multiplies the left u of every u-involved sum exactly once
(gu = sum w u d [Rt | u], b_u = sum w u d y, usq = sum w u^2); the FISTA
steps stay raw, so a row with w = 0 still moves.

Dtypes as K1's (``cuda_kernels.check_dtypes``): ydt and rtt float32,
float64 or bfloat16; the members' state and ``weights`` float32 or
float64, float32 with bf16 data. bf16 data are converted once at load and
the arithmetic is float32 from there on, as the JAX kernel's
(``pallas_kernels.py:835-836, 853``); the weight rows keep the state
dtype.

The kernel takes the active members in groups (``k4_member_plan``): the
group's alpha blocks and u rows share the block's shared memory with the
staged Y, D and Rt, each thread runs its site's steps for every member of
the group, and one Gram stage sums the group's entries in register tiles
whose rows run across the members (``k4_gram_plan``); every entry keeps
K1's products and site order, so each member's outputs are K1's bits.
``csrc/u_phase_grams_multi.cuh`` exports the same plans
(``dm_k4_member_plan``, ``dm_k4_gram_plan``), which ``chip_smoke.py``
holds these to. In K1's global layout (``cuda_kernels.u_phase_layout``)
the group's u rows sit at the top of shared memory and Rt streams through
the ring (``cuda_kernels.global_plan`` with the group's rows), and the
group is the largest that keeps the one-member layout's blocks per SM.

On a CUDA tensor the wrapper launches the kernel or raises; only CPU
tensors take the plain PyTorch twin ``u_phase_grams_multi_plain``, the
same function with the member axis written out as a batch dimension.
"""

import ctypes

import torch

from demethify_tpu_torch.ops import _build, cuda_kernels
from demethify_tpu_torch.ops.cuda_kernels import (
    _CHUNK,
    _LD,
    A_U,
    ACTIVE,
    GRAM_TILE_Q,
    L_W,
    L_W_PREV,
    N_SCAL_MULTI,
    REG_N_U,
    SITES_PER_BLOCK,
    SMEM_LIMIT,
    SMEM_PER_SM,
    blocks_per_sm,
    check_dtypes,
    count_forms,
    global_plan,
    gram_entries,
    gram_form,
    known_block,
    launch_case,
    lib_smem,
    member_stride,
    state_rows,
)
from demethify_tpu_torch.ops.fista import momentum, nesterov_step


# blocks per SM a member group keeps, where one member's layout fits as
# many (kGroupBlocks)
K4_GROUP_BLOCKS = 4
# the layout codes of dm_k4_member_plan
_LAYOUT_CODE = {"resident": 0, "wide": 1, "global": 2}
# the group Gram stage's tiles (kGS, kGL, kGP, kGB): samples per tile,
# left rows (member, unknown) per cross tile (x GRAM_TILE_Q rows of Rt),
# (member, v, w) pairs per self tile, left rows per b_u tile
K4_TILE_S, K4_TILE_L, K4_TILE_P, K4_TILE_B = 2, 2, 4, 4


def k4_smem(itemsize: int, n_s: int, n_ct: int, n_u: int, weighted: bool,
            layout: str, group: int) -> int:
    """K4's shared memory in bytes for a group of ``group`` members:
    the staged Y and D rows (n_s, or one chunk of 32 in the wide layout)
    and Rt's n_ct rows, each member's n_u u rows (and, ``weighted``, n_u
    rows of w u), and in the resident layout each member's (p, n_s) alpha
    block; in the global layout ``cuda_kernels.global_plan``'s rows for
    the group. Above n_u = 8 the block's one state region
    (``cuda_kernels.state_rows`` of the gram form, which each member's loop
    reuses) adds its rows: after the resident layout's, over the chunk
    rows of the wide layout, at the bottom of the global one (in device
    memory where ``cuda_kernels.state_in_device``). At group 1 it is
    ``cuda_kernels.u_phase_smem(..., weighted=)``, the bytes the layout
    rule compares."""
    if layout == "global":
        return itemsize * _LD * global_plan(
            itemsize, n_s, n_ct, n_u, False, n_u * (2 if weighted else 1),
            group)["rows"]
    lead = max(2 * min(_CHUNK, n_s), state_rows(n_s, n_u))
    rows = lead if layout == "wide" else 2 * n_s + state_rows(n_s, n_u)
    u_rows = group * n_u * (2 if weighted else 1)
    alpha = 0 if layout == "wide" else group * (n_ct + n_u) * n_s
    return itemsize * ((rows + n_ct + u_rows) * _LD + alpha)


def k4_member_plan(itemsize: int, n_s: int, n_ct: int, n_u: int, n_b: int,
                   weighted: bool, layout: str) -> dict:
    """K4's member groups (``csrc/u_phase_grams_multi.cuh``,
    ``k4_member_plan``; the kernels' ``dm_k4_member_plan``): the group size
    G is the most members, at most n_b and at least 1, whose alpha blocks
    and u rows (``k4_smem``) leave the block min(K4_GROUP_BLOCKS, the
    one-member layout's blocks per SM) blocks on an SM, so a group keeps
    the occupancy the layout rule counted wherever that was at most
    K4_GROUP_BLOCKS. Returns {"group", "smem", "blocks"}.
    The cap comes from shared memory, never from B; in the global layout,
    whose ring rows shrink as the group grows, every G is tried. Above
    n_u = 8 the members' per-site state (K1's n_u > 8 form: C, M and the
    u vectors) lives on the chip, in one state region a block that each
    member's loop reuses: ``k4_smem`` counts it once, in the base bytes,
    so it moves the group size but does not grow with it. The layout is
    ``cuda_kernels.u_phase_layout``'s, one rule for K1 and K4 (fitted above
    n_u = 8 with both, ``chip_smoke.time_layouts``)."""
    one = k4_smem(itemsize, n_s, n_ct, n_u, weighted, layout, 1)
    blocks = max(1, min(blocks_per_sm(one), K4_GROUP_BLOCKS))
    budget = min(SMEM_PER_SM // blocks - 1024, SMEM_LIMIT)
    if layout == "global":
        plan = {"group": 1, "smem": one, "blocks": blocks}
        um = itemsize * _LD * n_u * (2 if weighted else 1)
        for gm in range(2, n_b + 1):
            if gm * um > budget:
                break
            nbytes = k4_smem(itemsize, n_s, n_ct, n_u, weighted, layout, gm)
            if nbytes <= budget:
                plan.update(group=gm, smem=nbytes)
        return plan
    base = k4_smem(itemsize, n_s, n_ct, n_u, weighted, layout, 0)
    group = max(1, min(n_b, (budget - base) // (one - base)))
    return {"group": group,
            "smem": k4_smem(itemsize, n_s, n_ct, n_u, weighted, layout,
                            group),
            "blocks": blocks}


def k4_gram_plan(n_c: int, n_ct: int, n_u: int, gm: int, usq: bool) -> dict:
    """The items of K4's Gram stage for a group of ``gm`` members and n_c
    staged samples (``csrc/u_phase_grams_multi.cuh``, ``k4_gram_plan``;
    ``dm_k4_gram_plan``), dealt to the block's 128 threads, item k to
    thread k mod 128. "tiled" when the tiles give every thread one at
    least:

    - n_x cross tiles in items [0, n_x), ts x tl x tq: K4_TILE_S samples x
      K4_TILE_L left rows (member, unknown) x GRAM_TILE_Q rows of Rt
      (item k: q-tile k mod tq, row tile (k // tq) mod tl, sample tile
      k // (tq tl));
    - n_self self tiles from item o_self, ts x tp: K4_TILE_S samples x
      K4_TILE_P pairs (member, v, w) of the u u' block (pair tile first);
    - n_bu b_u tiles from o_bu, ts x tb: K4_TILE_S samples x K4_TILE_B
      left rows (row tile first);
    - with ``usq`` one item per member from o_usq;

    each kind from a warp boundary (the items between are idle), so a
    warp runs one kind; n_items = o_usq + n_usq. Rows past the edge are
    clamped and write nothing. Otherwise (fewer tiles than threads) one
    item per entry, member by member, K1's local order for each
    ([gu (n_c, n_u, p) | b_u (n_u, n_c) | usq])."""
    n_l = gm * n_u
    ts = -(-n_c // K4_TILE_S)
    tl = -(-n_l // K4_TILE_L)
    tq = -(-n_ct // GRAM_TILE_Q)
    tp = -(-(n_l * n_u) // K4_TILE_P)
    tb = -(-n_l // K4_TILE_B)
    plan = {"ts": ts, "tl": tl, "tq": tq, "tp": tp, "tb": tb,
            "n_x": ts * tl * tq, "n_self": ts * tp, "n_bu": ts * tb,
            "n_usq": gm if usq else 0}
    n_tiles = plan["n_x"] + plan["n_self"] + plan["n_bu"] + plan["n_usq"]
    plan["tiled"] = n_tiles >= SITES_PER_BLOCK
    if not plan["tiled"]:
        plan.update(o_self=0, o_bu=0, o_usq=0, n_items=gm * (
            n_c * n_u * (n_ct + n_u) + n_u * n_c + int(usq)))
        return plan

    def warp_up(x):
        return -(-x // 32) * 32

    plan["o_self"] = warp_up(plan["n_x"])
    plan["o_bu"] = plan["o_self"] + warp_up(plan["n_self"])
    plan["o_usq"] = plan["o_bu"] + warp_up(plan["n_bu"])
    plan["n_items"] = plan["o_usq"] + plan["n_usq"]
    return plan


def _check_args(ydt, rtt, a1_b, a2_b, uut_b, scal_b, weights):
    dev = ydt.device
    given = [t for t in (weights,) if t is not None]
    check_dtypes("u_phase_grams_multi", (ydt, rtt),
                 (a1_b, a2_b, uut_b, scal_b, *given))
    for t in (ydt, rtt, uut_b, scal_b, *given):
        if not t.is_contiguous():
            raise ValueError("u_phase_grams_multi: operands must be "
                             "contiguous")
    n_b, n_u, n_s = a2_b.shape
    n_ct = a1_b.shape[1]
    n = ydt.shape[1]
    if (n_b < 1 or ydt.shape != (2 * n_s, n) or rtt.shape != (n_ct, n)
            or a1_b.shape != (n_b, n_ct, n_s)
            or uut_b.shape != (n_b, 2 * n_u, n)
            or scal_b.shape != (n_b, N_SCAL_MULTI)
            or any(t.shape != (n_b, n) for t in given)):
        raise ValueError(
            f"u_phase_grams_multi: inconsistent shapes ydt "
            f"{tuple(ydt.shape)}, rtt {tuple(rtt.shape)}, a1_b "
            f"{tuple(a1_b.shape)}, a2_b {tuple(a2_b.shape)}, uut_b "
            f"{tuple(uut_b.shape)}, scal_b {tuple(scal_b.shape)}, weights "
            f"{None if weights is None else tuple(weights.shape)}")
    if n == 0:
        raise ValueError("u_phase_grams_multi: no CpG sites")
    if dev.type == "cuda":
        for t, name in ((a1_b, "a1_b"), (a2_b, "a2_b")):
            member_stride(t, f"u_phase_grams_multi: {name}")
    if n_u < 1:
        raise ValueError("u_phase_grams_multi: no unknown rows")
    if not gram_form(n_u, n_s):
        raise ValueError(
            f"u_phase_grams_multi has the gram form only (n_u^2 <= 3 n_s), "
            f"as the JAX kernel; with n_u = {n_u}, n_s = {n_s} restarts run "
            f"as sequential single-member solves")
    return n, n_b, n_s, n_ct, n_u


def _split(out, n_s, n_u, p):
    """(B, E) flat Gram rows -> gu (B, n_s, n_u, p), b_u (B, n_u, n_s),
    usq (B,), views of ``out``."""
    n_b = out.shape[0]
    g = n_s * n_u * p
    return (out[:, :g].view(n_b, n_s, n_u, p),
            out[:, g:g + n_u * n_s].view(n_b, n_u, n_s), out[:, -1])


def launch_plan(lib, itemsize: int, n: int, n_s: int, n_ct: int, n_u: int,
                n_b: int, n_steps: int, weighted: bool = False) -> dict:
    """K4's launch plan from the library's exports (the kernels' own copy
    of the plan, ``lib``): {"layout", "smem" (one member's bytes, what the
    layout rule compares), "in_device", "ring" (the global layout's
    ``global_plan`` for the group the kernel takes, with "group"; else
    None), "sizes": the values of the state type of each buffer the
    wrapper allocates ("partials": the partial sums, then from offset
    "tab" the members' momentum tables and from "list" the list of active
    members, B + 1 int32; "out" a member's entries; "state" the n_u > 8
    region, 0 when on the chip)}. The global layout allocates nothing of
    its own."""
    layout, smem = cuda_kernels.u_phase_layout(
        "u_phase_grams_multi", itemsize, n_s, n_ct, n_u, weighted=weighted,
        smem=lib_smem(lib, "dm_u_phase_grams_multi", itemsize, n_s, n_ct,
                      n_u, weighted))
    in_device = layout == "global" and bool(
        lib.dm_state_in_device(itemsize, n_s, n_u, 0))
    ring = None
    if layout == "global":
        group = (ctypes.c_longlong * 3)()
        lib.dm_k4_member_plan(itemsize, n_s, n_ct, n_u, n_b, int(weighted),
                              _LAYOUT_CODE[layout], group)
        ring = cuda_kernels.lib_global_plan(
            lib, itemsize, n_s, n_ct, n_u, False,
            n_u * (2 if weighted else 1), group[0])
        ring["group"] = group[0]
    n_entries = gram_entries(n_s, n_ct, n_u)
    n_blocks = lib.dm_u_phase_grams_blocks(n)
    n_part, n_tab = n_b * n_entries * n_blocks, n_b * (n_steps + 1)
    n_list = -(-4 * (n_b + 1) // itemsize)
    state = (n_blocks * lib.dm_state_rows(n_s, n_u, 0) * _LD if in_device
             else 0)
    return {"layout": layout, "smem": smem, "in_device": in_device,
            "ring": ring,
            "sizes": {"partials": n_part + n_tab + n_list, "tab": n_part,
                      "list": n_part + n_tab, "out": n_entries,
                      "state": state}}


def u_phase_grams_multi(ydt, rtt, a1_b, a2_b, uut_b, scal_b, n_steps: int,
                        lagged: bool = False, weights=None):
    """One outer iteration's U phase for B members: each active member's
    whole n_steps FISTA loop on U, then its new-u Gram blocks.

    ydt (2 n_s, N) = [Y.T; D.T] and rtt (n_ct, N) = Rt.T are shared
    (rtt None, or n_ct = 0, without a known block); a1_b (B, n_ct, n_s)
    and a2_b (B, n_u, n_s) are the members' known and unknown alpha rows
    (each member's block contiguous, e.g. slices of a (B, p, n_s) stack;
    a1_b None without a known block); uut_b (B, 2 n_u, N) the members'
    [u.T; u_prev.T]; scal_b (B, N_SCAL_MULTI) the members' scalar rows;
    weights (B, N) the members' row weights, or None. ``lagged`` as for
    ``u_phase_grams`` (the layouts and the n_u > 8 form are K1's:
    ``cuda_kernels.u_phase_layout``).

    Updates the active members' ``uut_b`` rows and their A_U and L_W_PREV
    slots in place and returns (gu (B, n_s, n_u, p), b_u (B, n_u, n_s),
    usq (B,)); an inactive member's entries are unspecified on the card.
    """
    n_b, n_u, n_s = a2_b.shape
    ydt, rtt, a1_b = known_block(ydt, rtt, a1_b, (n_b, 0, n_s), uut_b)
    n, n_b, n_s, n_ct, n_u = _check_args(ydt, rtt, a1_b, a2_b, uut_b,
                                         scal_b, weights)
    if ydt.device.type == "cpu":
        return u_phase_grams_multi_plain(ydt, rtt, a1_b, a2_b, uut_b, scal_b,
                                         n_steps, lagged, weights)
    if ydt.device.type != "cuda":
        raise ValueError(f"u_phase_grams_multi: unsupported device "
                         f"{ydt.device}")
    lib = _build.load().lib
    weighted = weights is not None
    plan = launch_plan(lib, uut_b.element_size(), n, n_s, n_ct, n_u, n_b,
                       n_steps, weighted)
    layout, smem, in_device = plan["layout"], plan["smem"], plan["in_device"]
    prefix = "dm_u_phase_grams_multi" + cuda_kernels._LAYOUT_SUFFIX[layout]
    p = n_ct + n_u
    size = plan["sizes"]
    partials = uut_b.new_empty((size["partials"],))
    tab = partials[size["tab"]:]
    member_list = partials[size["list"]:]
    out = uut_b.new_empty((n_b, size["out"]))
    state = uut_b.new_empty((size["state"],)) if in_device else None
    fn = getattr(lib, prefix + {torch.float32: "_f32", torch.float64: "_f64",
                                torch.bfloat16: "_bf16"}[ydt.dtype])
    with torch.cuda.device(ydt.device):
        stream = torch.cuda.current_stream(ydt.device).cuda_stream
        err = fn(ydt.data_ptr(), rtt.data_ptr(), a1_b.data_ptr(),
                 a1_b.stride(0), a2_b.data_ptr(), a2_b.stride(0),
                 uut_b.data_ptr(),
                 None if weights is None else weights.data_ptr(),
                 0 if weights is None else weights.stride(0),
                 scal_b.data_ptr(), N_SCAL_MULTI, tab.data_ptr(),
                 member_list.data_ptr(), partials.data_ptr(), out.data_ptr(),
                 None if state is None else state.data_ptr(), n, n_s, n_ct,
                 n_u, n_steps, n_b, int(lagged), stream)
    _build.check(err, "u_phase_grams_multi", launch_case(
        n, n_s, n_ct, n_u, n_b, ydt.dtype, uut_b.dtype, layout, in_device,
        smem, plan["ring"], weighted=weighted, lagged=lagged))
    if ydt.dtype == torch.bfloat16:
        u_phase_grams_multi.launches_bf16 += 1
    else:
        u_phase_grams_multi.launches += 1
    count_forms(u_phase_grams_multi.forms, wide=layout == "wide",
                global_layout=layout == "global",
                state_on_chip=n_u > REG_N_U and state is None,
                state_in_device=state is not None)
    return _split(out, n_s, n_u, p)


# launches per form: float32/float64 data, and bf16 data (float32 state);
# with or without weights
u_phase_grams_multi.launches = 0
u_phase_grams_multi.launches_bf16 = 0
u_phase_grams_multi.forms = {}      # as u_phase_grams.forms


def u_phase_grams_multi_plain(ydt, rtt, a1_b, a2_b, uut_b, scal_b,
                              n_steps: int, lagged: bool = False,
                              weights=None):
    """The same function as ``u_phase_grams_multi`` in ordinary tensor ops,
    the member axis a batch dimension (the kernel's twin: the CPU path,
    and what the kernel is checked against on the card). The Grams of an
    inactive member are computed with its frozen u. bf16 data are upcast
    to the state dtype."""
    n_b, n_u, n_s = a2_b.shape
    ydt, rtt, a1_b = known_block(ydt, rtt, a1_b, (n_b, 0, n_s), uut_b)
    st = uut_b.dtype
    yt, dt, rtt = ydt[:n_s].to(st), ydt[n_s:].to(st), rtt.to(st)
    dy = dt * yt
    dresid = (dy if rtt.shape[0] == 0
              else dy - dt * (a1_b.transpose(1, 2) @ rtt))   # (B|1, n_s, N)
    C = a2_b @ dresid                                        # (B, n_u, N)
    w2 = (a2_b[:, :, None, :] * a2_b[:, None, :, :]).reshape(
        n_b, n_u * n_u, n_s)
    M = (w2 @ dt).reshape(n_b, n_u, n_u, -1)

    def col(x):
        return x[:, None, None]

    u, u_prev = uut_b[:, :n_u].clone(), uut_b[:, n_u:].clone()
    a, l_w, l_prev = (scal_b[:, k].clone() for k in (A_U, L_W, L_W_PREV))
    for _ in range(n_steps):
        a1 = nesterov_step(a)
        beta = momentum(a, a1, l_prev, l_w)
        u_t = u + col(beta) * (u - u_prev)
        g = u if lagged else u_t
        step = C - torch.einsum("buvn,bvn->bun", M, g)
        u, u_prev = torch.clamp(u_t + step / col(l_w), 0.0, 1.0), u
        a, l_prev = a1, l_w
    act = scal_b[:, ACTIVE] != 0
    u = torch.where(col(act), u, uut_b[:, :n_u])
    u_prev = torch.where(col(act), u_prev, uut_b[:, n_u:])
    rext = torch.cat([rtt.expand(n_b, -1, -1), u], dim=1)
    u_w = u if weights is None else weights[:, None, :] * u
    gu = torch.einsum("sn,bun,bqn->bsuq", dt, u_w, rext)
    b_u = u_w @ dy.T
    usq = torch.sum(u_w * u, dim=(1, 2))
    uut_b[:, :n_u] = u
    uut_b[:, n_u:] = u_prev
    scal_b[:, A_U] = torch.where(act, a, scal_b[:, A_U])
    scal_b[:, L_W_PREV] = torch.where(act, l_prev, scal_b[:, L_W_PREV])
    return gu, b_u, usq
