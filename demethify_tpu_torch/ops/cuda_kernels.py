"""K1, the U-phase megakernel, and K7 and K8, the single-phase U kernel
and the one-pass Gram system: wrappers, launch counts and plain twins.

``u_phase_grams`` replaces the Pallas kernel
``demethify_tpu/ops/pallas_kernels.py::_u_phase_grams_kernel`` (through
its wrappers ``u_phase_grams_packed`` and ``u_phase_grams``). The kernel
is ``csrc/u_phase_grams.cu``; its source note says what bounds it on an
H100 (memory traffic: one read of Y, D, Rt, u, u_prev and one write of u,
u_prev per outer iteration; the Gram stage at wide shapes) and what the
design does about it. Two of its pieces have Python counterparts here:
the momentum table its prologue computes once per launch
(``momentum_table``, twin ``momentum_table_plain``; the wrapper gives it
room behind the partial sums) and the Gram stage's plan
(``gram_tile_plan``: one entry per thread, or register micro-tiles).

Forms, as the JAX kernel has them: with or without a known block (the
unsupervised solve has none), the gradient at u_t or, ``lagged``, at the
old u (the reference's unsupervised quirk), and the gram or the direct
dataflow, chosen by ``gram_form`` (the JAX kernel's rule).

Dtypes: the data operands ``ydt`` and ``rtt`` are float32, float64 or
bfloat16 (storage); the state operands (``a1_block``, ``a2_block``,
``uut``, ``scal``) are float32 or float64, the same as the data except
that bfloat16 data goes with a float32 state (the JAX kernel's bf16
storage: the data converted once at load, float32 arithmetic from there
on). ``bf16_compute`` (bf16 data only) rounds the products the JAX
kernel's ``bf16_compute`` branch forms in bf16: in the gram form
(``pallas_kernels.py:263-334, 464-479``) d y, d rt, the alpha operands
a2, a2 a1 and a2 a2 of the C and M sums, and u and d u in the Gram sums;
in the direct form d y alone, as the JAX kernel's direct-form fallback
(``pallas_kernels.py:299-311``). Every sum stays float32. With float32
data the flag does nothing, as in the JAX kernel.

Shapes: any n_s, n_ct and n_u >= 1. The kernel has three layouts
(``csrc/u_phase_common.cuh``) that give the same bits: the resident one
(Y, D and alpha staged once), the wide one (Y and D staged in chunks of
samples; the same sums in the same orders), whose shared memory stops
growing at 32 samples, and the global one, whose shared memory does not
grow with p: the steps read Y, D and Rt where they lie in device memory,
and the Gram stage streams Y and D a chunk of samples at a time and Rt a
few rows at a time through a ring of two slots, the u rows at the top of
shared memory (``global_plan``). ``u_phase_layout`` picks by the measured
crossover: resident, unless it does not fit or the wide one fits at least
twice as many blocks on an SM; global where neither fits.
n_u <= 8 keeps the per-site state in registers; above, one form keeps it
on the chip, in a per-thread column of a state region of shared memory
(``state_rows`` rows a block; in the wide and global layouts over the
rows that the Gram stage stages after the steps). Where even the global
layout cannot hold the region (``state_in_device``: the gram
form past n_u = 17 in float64, 25 in float32), it lives in a per-block
part of a device buffer the wrapper allocates.

Rt may also arrive folded into the data block, ydt = [Y.T; D.T; Rt.T]
(2 n_s + n_ct, N) with ``rtt`` None and ``a1_block`` given, as the JAX
wrapper's ``rt_folded`` layout (``pallas_kernels.py:650-674``); the
wrapper then points the kernel's Rt operand at row 2 n_s of the same
buffer (a view, not a copy).

On a CUDA tensor the wrapper launches the kernel or raises; only CPU
tensors take the plain PyTorch twin ``u_phase_grams_plain``, which
computes the same function with ordinary tensor ops.

Device scalars: the solver keeps its scalars in one small vector on the
data's device (slots below), which the kernels read and advance, so an
outer iteration needs no host sync apart from the termination test. The
multi-member solves keep one row of N_SCAL_MULTI slots per restart
member: the same slots plus the member's tolerance TOL and its ACTIVE
flag (``csrc/small_common.cuh`` names the same slots).

K7 ``u_phase`` replaces ``_u_phase_kernel`` (through ``u_phase``,
``pallas_kernels.py:65, 117``): K1's U phase without its Gram stage, in
the JAX kernel's association (``csrc/u_phase.cu``). K8 ``grams``
replaces ``_gram_kernel`` (through ``grams``, ``pallas_kernels.py:743,
776``): G, b and ydy in one pass over the sites (``csrc/grams.cu``). No
solver runs either, in the JAX package or here; they take the JAX
functions' operands (less the TPU lane ``tile``) and return new arrays,
their scalars as 0-d tensors advanced on the device (slots PH_*), so a
call reads nothing back. ``chip_smoke.composed_solve`` composes K7, K8
and K9 (``cuda_small.alpha_phase``) into the plain solver's outer
iteration.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from demethify_tpu_torch.device import state_dtype
from demethify_tpu_torch.ops import _build
from demethify_tpu_torch.ops.fista import momentum, nesterov_step

# slots of the solver's device scalar vector `scal`
A_U, L_W, L_W_PREV, A_ALPHA, L_H_PREV, COST, RT_SQ, DMAX2, TOL, ACTIVE = (
    range(10))
N_SCAL = 8
N_SCAL_MULTI = 10

SITES_PER_BLOCK = 128    # K1's and K4's sites per block (u_phase_common.cuh)
SMEM_LIMIT = 232448      # bytes of shared memory a block may opt into (H100)
SMEM_PER_SM = 233472     # bytes of shared memory of one SM (H100)
_LD = SITES_PER_BLOCK + 1    # shared row stride (kLd)
_CHUNK = 32                  # samples per staged chunk, wide layout (kChunk)
REG_N_U = 8              # n_u above this keeps its state in a state region


def gram_form(n_u: int, n_s: int) -> bool:
    """The JAX kernel's choice of dataflow (``pallas_kernels.py:298``):
    the gram form keeps n_u^2 curvature terms per site, the direct form
    redoes two small products over the n_s samples each step."""
    return n_u * n_u <= 3 * n_s


def state_rows(n_s: int, n_u: int, direct: bool = False) -> int:
    """Rows (129 values each) of the n_u > REG_N_U form's state region, 0
    below (``csrc/u_phase_common.cuh``, ``state_rows``; the kernels'
    ``dm_state_rows``): in the gram form three u vectors, C and the
    n_u (n_u + 1) / 2 curvature terms M; in the direct form two u vectors,
    the residuals of a chunk of min(32, n_s) samples and, past one chunk,
    the gradient. One region a block (K4's members reuse it)."""
    if n_u <= REG_N_U:
        return 0
    if direct:
        ch = min(n_s, _CHUNK)
        return 2 * n_u + ch + (n_u if n_s > ch else 0)
    return 4 * n_u + n_u * (n_u + 1) // 2


def _lead_rows(n_s: int, n_u: int, direct: bool) -> int:
    """Rows leading the wide and global layouts' shared memory: one chunk
    of Y and D for the Gram stage, overlaid by the state region."""
    return max(2 * min(_CHUNK, n_s), state_rows(n_s, n_u, direct))


def state_in_device(itemsize: int, n_s: int, n_u: int,
                    direct: bool = False) -> bool:
    """True where the state region passes one block's shared memory even
    in the global layout (``dm_state_in_device``): it then lives in
    device memory, ``state_rows`` x 129 values a block."""
    return (state_rows(n_s, n_u, direct) > 0
            and itemsize * _lead_rows(n_s, n_u, direct) * _LD > SMEM_LIMIT)


def u_phase_smem(layout: str, itemsize: int, n_s: int, n_ct: int, n_u: int,
                 direct: bool = False, bf16c: bool = False,
                 weighted: bool = False) -> int:
    """Shared memory of K1's (and, ``weighted`` or not, K4's one-member)
    main pass in bytes, for the "resident", "wide" or "global" layout;
    ``itemsize`` is the state's (staged rows are of the state type). The
    same formula as the kernels' ``*_smem`` exports
    (``csrc/u_phase_grams.cuh``, ``u_phase_grams_multi.cuh``), which
    ``chip_smoke.py`` holds it to: resident: (2 n_s + p [+ n_s direct]
    [+ n_u] + state_rows) rows of 129 plus the (p, n_s) alpha block (above
    n_u = 8 in the direct form with a2's rows padded to a multiple of 4);
    wide: (max(2 min(32, n_s), state_rows) + p [+ n_u]) rows; the n_u
    more rows hold the raw u of bf16_compute's gram form, or K4's weighted
    u; global: ``global_plan``'s rows (one member of n_u [+ n_u] u
    rows)."""
    p = n_ct + n_u
    x_rows = n_u if (bf16c and not direct) or weighted else 0
    if layout == "global":
        return itemsize * _LD * global_plan(itemsize, n_s, n_ct, n_u, direct,
                                            n_u + x_rows)["rows"]
    lead = _lead_rows(n_s, n_u, direct)
    if layout == "wide":
        return itemsize * (lead + p + x_rows) * _LD
    if layout != "resident":
        raise ValueError(f"unknown layout {layout!r}")
    rows = (2 * n_s + p + (n_s if direct else 0) + x_rows
            + state_rows(n_s, n_u, direct))
    # the alpha blocks; above n_u = 8 the direct form keeps a2 as a table
    # of rows padded to a multiple of 4 values (16-byte loads)
    alpha = (n_ct * n_s + n_u * -(-n_s // 4) * 4
             if direct and n_u > REG_N_U else p * n_s)
    return itemsize * (rows * _LD + alpha)


def blocks_per_sm(smem: int) -> int:
    """Blocks of SITES_PER_BLOCK threads that fit one SM by shared memory
    (``smem`` bytes each, plus the 1 KB the card reserves per block) and
    by threads (2048)."""
    return min(2048 // SITES_PER_BLOCK, SMEM_PER_SM // (smem + 1024))


RING_SLOTS = 2    # slots of the global layout's ring of Rt rows (kRingSlots)


def global_plan(itemsize: int, n_s: int, n_ct: int, n_u: int,
                direct: bool = False, um: int = None,
                members: int = 1) -> dict:
    """The global layout's plan (``csrc/u_phase_common.cuh``,
    ``global_plan``; the kernels' ``dm_global_plan`` export, which
    ``chip_smoke.py`` holds this to), for ``members`` blocks of ``um`` u
    rows (K1: n_u, or 2 n_u in bf16_compute's gram form, one member; K4:
    n_u, or 2 n_u weighted, a member group). Rows of 129 values, from the
    bottom of the block's shared memory: the n_u > 8 state region (unless
    it lives in device memory) and, in the direct form, the residual rows
    past it where they fit (``res``); for the Gram stage Y and D, ``cs``
    samples each, and the ring, ``depth`` slots of ``q`` rows of Rt; at the
    top the u rows (the last member's may overlay the region's dead tail,
    never the u vectors it is read from). q is the multiple of 4 that
    gives the 128 threads a tile each per slot, at most all of Rt, shrunk
    by 4 while the Gram stage would take the block from two blocks an SM
    (or from the rows the steps hold, if more), unless one block an SM
    with a larger q keeps more of its threads busy with tiles; where the
    region lives in device memory the layout keeps its 2 min(32, n_s) rows
    and cs shrinks too. ``kc``: the register forms (n_u <= 8), whose steps
    leave shared memory free but for the u rows, form their known sums
    a1' Rt in n_s rows at the bottom with a1 staged kc rows at a time
    above them, where the rows below the u rows hold that (else 0: the
    sums read a1 from device memory). Returns {"cs", "q", "depth",
    "rows", "res", "kc"}."""
    um = n_u if um is None else um
    row = itemsize * _LD
    max_rows = SMEM_LIMIT // row
    two = (SMEM_PER_SM // 2 - 1024) // row
    in_dev = state_in_device(itemsize, n_s, n_u, direct)
    region = 0 if in_dev else state_rows(n_s, n_u, direct)
    vec = (2 if direct else 3) * n_u if region else 0
    res = direct and not in_dev and region + n_s <= max_rows
    hold = region + (n_s if res else 0)
    fixed = max(hold + (members - 1) * um, vec + members * um)
    cs = min(_CHUNK, n_s)
    rv = 1 if n_u == 1 else 2
    per4 = -(-cs // (4 // rv)) * -(-n_u // rv) * members
    q = min(GRAM_TILE_Q * -(-SITES_PER_BLOCK // per4),
            -(-n_ct // GRAM_TILE_Q) * GRAM_TILE_Q)
    floor = 2 * min(_CHUNK, n_s) if in_dev else 0

    def depth(q):
        return 0 if q == 0 else (RING_SLOTS if q < n_ct else 1)

    def need(cs, q):
        return 2 * cs + depth(q) * q + members * um

    def shrink(q, cap):
        while q > GRAM_TILE_Q and need(cs, q) > cap:
            q -= GRAM_TILE_Q
        return q

    def busy(q):
        return min(SITES_PER_BLOCK, per4 * q // GRAM_TILE_Q)

    # q within two blocks' rows, or one block's where that keeps more of
    # an SM's threads busy with tiles
    q2, q1 = shrink(q, max(two, fixed)), shrink(q, max(max_rows, fixed))
    q = q1 if 2 * busy(q2) < busy(q1) else q2
    while in_dev and need(cs, q) > floor:
        if q > GRAM_TILE_Q:
            q -= GRAM_TILE_Q
        elif cs > 1:
            cs -= 1
        else:
            break
    rows = max(fixed, need(cs, q), floor)
    # the register forms' known sums: n_s rows, then a1 kc rows at a time
    free = (rows - members * um - n_s) * _LD
    kc = (min(free // n_s, n_ct)
          if n_u <= REG_N_U and n_ct > 0 and free >= n_s else 0)
    return {"cs": cs, "q": q, "depth": depth(q), "rows": rows,
            "res": int(res), "kc": kc}


def u_phase_layout(name: str, itemsize: int, n_s: int, n_ct: int, n_u: int,
                   direct: bool = False, bf16c: bool = False,
                   weighted: bool = False, smem=None):
    """(layout, bytes). ``smem(layout)`` gives a layout's bytes: by default
    ``u_phase_smem``; the launchers pass the library's ``*_smem`` exports
    (``lib_smem``), so that on the card the kernels' own bytes decide. The
    resident layout reads Y and D from device
    memory once; the wide one reads them twice (and, in the direct form,
    once per FISTA step), but its shared memory stops growing with n_s at
    32 samples, so more blocks share an SM. On an H100
    (``chip_smoke.time_layouts``, 27 shapes, with the register-tiled Gram
    stage) the wide layout was up to 36% slower wherever it fitted fewer
    than twice the resident layout's blocks per SM (at one such shape,
    50 samples in float64, 13% faster), and 3-39% faster wherever it
    fitted at least twice as many at n_u <= 8 (the resident layout then
    fits one or two); in the direct form up to 2.1x slower. So, at
    n_u <= 8: the resident layout, unless it passes SMEM_LIMIT or, in the
    gram form, the wide one fits at least twice its blocks per SM; the
    global layout where neither fits (the wide layout passes SMEM_LIMIT
    from p = 162 state rows in float64 at n_s >= 32, 387 in float32).

    Above n_u = 8 the state region on the chip sets much of a layout's
    bytes, and occupancy decides (``chip_smoke.time_layouts`` at
    ``STATE_LAYOUT_TIMES``, each layout forced at the sweep's direct form,
    n_s = 10 with n_u 9-25, and the cohort's gram form, n_s = 100 with n_u
    9-17, float32 and float64, 1M sites): the resident layout took 28-82%
    longer than the wide one where it fitted one block per SM and the wide
    one two or more (direct float64 at n_u = 25, the gram form at n_s =
    100), and 6-85% less wherever it fitted two or more, in the direct form
    even against twice its blocks (float64, n_u = 12). The global layout
    (then with a Gram stage that read [Rt | u] from device memory) came
    within 12% of the wide one at the one shape where the wide one fitted
    a block and it two (K1 12% less time, K4 3% more; float32, n_u = 17).
    So: the resident layout, unless it does not fit, or fits one block
    per SM and the wide one two or more; the global layout where the wide
    one does not fit."""
    if smem is None:
        def smem(layout):
            return u_phase_smem(layout, itemsize, n_s, n_ct, n_u, direct,
                                bf16c, weighted)
    res, wide = smem("resident"), smem("wide")
    if n_u > REG_N_U:
        leave = blocks_per_sm(res) < 2 <= blocks_per_sm(wide)
    else:
        leave = not direct and blocks_per_sm(wide) >= 2 * blocks_per_sm(res)
    if res <= SMEM_LIMIT and not leave:
        return "resident", res
    if wide <= SMEM_LIMIT:
        return "wide", wide
    return "global", smem("global")


# each layout's C entry points: dm_u_phase_grams{suffix}_*, and K4's
# dm_u_phase_grams_multi{suffix}_*
_LAYOUT_SUFFIX = {"resident": "", "wide": "_wide", "global": "_global"}


def lib_smem(lib, kernel: str, *args):
    """``smem(layout)`` for ``u_phase_layout`` from the library's exports:
    ``{kernel}{suffix}_smem(*args)`` (``kernel`` "dm_u_phase_grams" with
    args (itemsize, n_s, n_ct, n_u, direct, bf16c), or
    "dm_u_phase_grams_multi" with (itemsize, n_s, n_ct, n_u, weighted))."""
    def smem(layout):
        return getattr(lib, f"{kernel}{_LAYOUT_SUFFIX[layout]}_smem")(
            *(int(a) for a in args))
    return smem


GLOBAL_PLAN_KEYS = ("cs", "q", "depth", "rows", "res", "kc")


def lib_global_plan(lib, itemsize, n_s, n_ct, n_u, direct, um, members):
    """``global_plan`` from the library's ``dm_global_plan`` export (the
    kernels' own copy): {"cs", "q", "depth", "rows", "res", "kc"}."""
    out = (ctypes.c_int * len(GLOBAL_PLAN_KEYS))()
    lib.dm_global_plan(int(itemsize), int(n_s), int(n_ct), int(n_u),
                       int(direct), int(um), int(members), out)
    return dict(zip(GLOBAL_PLAN_KEYS, out))


def launch_case(n, n_s, n_ct, n_u, n_b, data, state, layout, in_device,
                smem, ring=None, **flags) -> str:
    """What a failed K1/K4 launch names: its shape, dtypes, layout, state
    region, shared memory, the global layout's ring (``global_plan``, when
    given) and any ``flags`` set."""
    extra = "".join(f", {k}" for k, on in flags.items() if on)
    if ring is not None:
        extra = (f", ring {ring['depth']} x {ring['q']} rows of Rt, "
                 f"{ring['cs']} samples a chunk, {ring['rows']} rows"
                 + extra)
    return (f"N = {n}, n_s = {n_s}, n_ct = {n_ct}, n_u = {n_u}, B = {n_b}, "
            f"{str(data).replace('torch.', '')} data, "
            f"{str(state).replace('torch.', '')} state, {layout} layout, "
            f"state region in device memory: {bool(in_device)}, {smem} "
            f"bytes of shared memory{extra}")


def check_dtypes(name, data, state):
    """Raises TypeError unless (``data``, ``state``) is a pair the U-phase
    kernels take: float32 or float64 for both, or bfloat16 data with a
    float32 state. ``data`` are the data operands, ``state`` the rest."""
    st = state[0].dtype
    dd = data[0].dtype
    if st not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: the state operands are float32 or float64, "
                        f"not {st}")
    if dd != st and not (dd == torch.bfloat16 and st == torch.float32):
        raise TypeError(f"{name}: {dd} data with a {st} state; the data are "
                        f"float32 or float64 like the state, or bfloat16 "
                        f"with a float32 state")
    dev = data[0].device
    for group, dt in ((data, dd), (state, st)):
        for t in group:
            if t.device != dev or t.dtype != dt:
                raise ValueError(f"{name}: the data operands must share one "
                                 f"dtype, the state operands another, all "
                                 f"on one device")


def _check_args(ydt, rtt, a1_block, a2_block, uut, scal):
    check_dtypes("u_phase_grams", (ydt, rtt), (a1_block, a2_block, uut, scal))
    for t in (ydt, rtt, a1_block, a2_block, uut, scal):
        if not t.is_contiguous():
            raise ValueError("u_phase_grams: operands must be contiguous")
    n_u, n_s = a2_block.shape
    n_ct = a1_block.shape[0]
    n = ydt.shape[1]
    if (ydt.shape != (2 * n_s, n) or rtt.shape != (n_ct, n)
            or a1_block.shape != (n_ct, n_s) or uut.shape != (2 * n_u, n)
            or scal.shape != (N_SCAL,)):
        raise ValueError(
            f"u_phase_grams: inconsistent shapes ydt {tuple(ydt.shape)}, "
            f"rtt {tuple(rtt.shape)}, a1 {tuple(a1_block.shape)}, "
            f"a2 {tuple(a2_block.shape)}, uut {tuple(uut.shape)}, "
            f"scal {tuple(scal.shape)}")
    if n == 0 or n_u < 1:
        raise ValueError(f"u_phase_grams: no CpG sites or no unknown rows "
                         f"(N = {n}, n_u = {n_u})")
    return n, n_s, n_ct, n_u


def count_forms(forms: dict, **flags) -> None:
    """Adds one launch to ``forms[name]`` for each name whose flag is set.
    The kernels' names: "wide" (K1/K4's wide layout; p > 32 in K2/K3/K5/
    K6), "two_row" (the glue kernels' two-row form, 32 < p <= 64),
    "global_layout" (K1/K4's global layout), "column_blocks" (the glue
    kernels above 64 rows: a block or cluster a column), "device_rows"
    (the glue kernels past 16 column blocks, G_s's rows in device memory),
    "state_on_chip" (K1/K4 at n_u > REG_N_U, the state region in shared
    memory), "state_in_device" (the same, its region in device memory;
    K7's n_u > REG_N_U form, whose region always lives there),
    "bf16c_direct" (bf16_compute in the direct form), "rt_folded" (Rt
    folded into the data block), "masked" (K2/K5/K9 with row masks). A
    launch also counts in its wrapper's ``launches``."""
    for name, on in flags.items():
        if on:
            forms[name] = forms.get(name, 0) + 1


def gram_entries(n_s: int, n_ct: int, n_u: int) -> int:
    """Gram entries per member: gu (n_s, n_u, p), b_u (n_u, n_s), usq."""
    return n_s * n_u * (n_ct + n_u) + n_u * n_s + 1


def momentum_table_plain(a, l_prev, lip, n_steps: int):
    """The momentum table of an n_steps FISTA loop, in ordinary tensor ops:
    (n_steps + 1,) values in a's dtype, the steps' betas
    ``momentum(a_k, a_{k+1}, l_prev_k, lip)`` (``ops/fista.py``) with
    a_0 = a, l_prev_0 = l_prev and l_prev_k = lip from step 1 on, then
    the advanced Nesterov scalar a_{n_steps}. The twin of the kernels'
    prologue (``csrc/u_phase_common.cuh``, ``momentum_table_kernel``),
    which computes the same values once per launch so that no thread
    replays them; a, l_prev, lip are 0-d tensors."""
    out = []
    for _ in range(n_steps):
        a1 = nesterov_step(a)
        out.append(momentum(a, a1, l_prev, lip))
        a, l_prev = a1, lip
    out.append(a)
    return torch.stack(out)


def momentum_table(scal, n_steps: int, phase: bool = False):
    """The momentum tables of the scalar rows ``scal`` ((N_SCAL,) or
    (B, N_SCAL_MULTI); with ``phase`` the single-phase kernels' 5-slot
    vector, slots PH_A, PH_L_PREV, PH_L), as K1, K4 and K7 build them
    before their main pass: (n_steps + 1,) per row, (B, n_steps + 1) for
    B rows. On the card the prologue kernel alone (with ``phase`` it also
    writes the vector's output slots, as K7's launch does); on the CPU
    ``momentum_table_plain``."""
    rows = scal.reshape(-1, scal.shape[-1])
    slots = (PH_A, PH_L_PREV, PH_L) if phase else (A_U, L_W_PREV, L_W)
    if scal.device.type == "cpu":
        tab = torch.stack([momentum_table_plain(*(r[k] for k in slots),
                                                n_steps) for r in rows])
    else:
        if scal.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"momentum_table takes float32 or float64, not "
                            f"{scal.dtype}")
        if not scal.is_contiguous():
            raise ValueError("momentum_table: scal must be contiguous")
        tab = scal.new_empty((rows.shape[0], n_steps + 1))
        lib = _build.load().lib
        fn = (lib.dm_momentum_table_f32 if scal.dtype == torch.float32
              else lib.dm_momentum_table_f64)
        with torch.cuda.device(scal.device):
            err = fn(scal.data_ptr(), rows.shape[1], rows.shape[0],
                     tab.data_ptr(), n_steps, int(phase),
                     torch.cuda.current_stream(scal.device).cuda_stream)
        _build.check(err, "momentum_table")
        momentum_table.launches += 1
    return tab if scal.dim() > 1 else tab[0]


momentum_table.launches = 0


GRAM_TILE_Q = 4    # rows of [Rt | u] per Gram micro-tile (kTileQ)


def gram_tile_plan(n_c: int, n_u: int, p: int, usq: bool) -> dict:
    """The Gram stage's work plan for one block of 128 sites and n_c
    staged samples (``csrc/u_phase_common.cuh``, ``gram_plan``; the
    kernels' ``dm_gram_tile_plan`` export, which ``chip_smoke.py`` holds
    this to): with at most SITES_PER_BLOCK entries [gu | b_u | usq] each
    entry is a thread's item ("entry" form); above, gu is dealt in
    micro-tiles of rs samples x rv unknowns x GRAM_TILE_Q rows (rv 1 at
    n_u = 1, else 2; rs = 4 / rv), ts x tv x tq of them, followed by b_u's
    entries and usq, each an item ("tile" form). Items go to the block's
    threads round robin."""
    n_local = n_c * n_u * p + n_u * n_c + int(usq)
    rv = 1 if n_u == 1 else 2
    rs = 4 // rv
    if n_local <= SITES_PER_BLOCK:
        return {"tiled": False, "rs": rs, "rv": rv, "ts": 0, "tv": 0,
                "tq": 0, "n_tiles": 0, "n_items": n_local}
    ts, tv = -(-n_c // rs), -(-n_u // rv)
    tq = -(-p // GRAM_TILE_Q)
    n_tiles = ts * tv * tq
    return {"tiled": True, "rs": rs, "rv": rv, "ts": ts, "tv": tv, "tq": tq,
            "n_tiles": n_tiles, "n_items": n_tiles + n_u * n_c + int(usq)}


def member_stride(t, name: str) -> int:
    """Elements between the members of ``t`` (B, ...), whose per-member
    block must be contiguous (a slice of a (B, p, n_s) alpha stack is)."""
    block = t[0]
    if not block.is_contiguous() or (t.shape[0] > 1 and block.numel() > 0
                                     and t.stride(0) < block.numel()):
        raise ValueError(f"{name}: each member's block must be contiguous "
                         f"and apart from the others")
    return t.stride(0)


def known_block(ydt, rtt, a1_block, a1_shape, state):
    """(ydt, rtt, a1): None for the known block means none (n_ct = 0):
    empty operands, rtt in the data's dtype, a1 of the empty ``a1_shape``
    in the dtype of the ``state`` tensor. With ``rtt`` None but a1 given,
    Rt is folded into ydt as its rows from 2 n_s on (n_s = a1_shape[-1]):
    ydt and rtt become row views of that buffer."""
    if rtt is None and a1_block is not None:
        n2 = 2 * a1_shape[-1]
        return ydt[:n2], ydt[n2:], a1_block
    if rtt is None:
        rtt = ydt.new_empty((0, ydt.shape[1]))
    if a1_block is None:
        a1_block = state.new_empty(a1_shape)
    return ydt, rtt, a1_block


def bf16_round(x):
    """x rounded to bfloat16 (to nearest, ties to even) and back to x's
    dtype: the twins' form of the kernels' ``__float2bfloat16_rn``."""
    return x.to(torch.bfloat16).to(x.dtype)


def launch_plan(lib, itemsize: int, n: int, n_s: int, n_ct: int, n_u: int,
                n_steps: int, direct: bool = False,
                bf16c: bool = False) -> dict:
    """K1's launch plan from the library's exports (the kernels' own copy
    of the plan, ``lib``): {"layout", "smem" (its bytes), "in_device" (the
    n_u > 8 state region in device memory), "ring" (the global layout's
    ``global_plan``, else None), "sizes": the values of the state type of
    each buffer the wrapper allocates: "partials" (the per-block partial
    sums, then the momentum table), "out" and "state" (the region, 0 when
    on the chip)}. The global layout allocates nothing of its own: its Y,
    D and Rt stream through shared memory."""
    layout, smem = u_phase_layout(
        "u_phase_grams", itemsize, n_s, n_ct, n_u, direct, bf16c,
        smem=lib_smem(lib, "dm_u_phase_grams", itemsize, n_s, n_ct, n_u,
                      direct, bf16c))
    in_device = layout == "global" and bool(
        lib.dm_state_in_device(itemsize, n_s, n_u, int(direct)))
    ring = (lib_global_plan(lib, itemsize, n_s, n_ct, n_u, direct,
                            n_u * (2 if bf16c and not direct else 1), 1)
            if layout == "global" else None)
    n_entries = gram_entries(n_s, n_ct, n_u)
    n_blocks = lib.dm_u_phase_grams_blocks(n)
    state = (n_blocks * lib.dm_state_rows(n_s, n_u, int(direct)) * _LD
             if in_device else 0)
    return {"layout": layout, "smem": smem, "in_device": in_device,
            "ring": ring,
            "sizes": {"partials": n_entries * n_blocks + n_steps + 1,
                      "out": n_entries, "state": state}}


def u_phase_grams(ydt, rtt, a1_block, a2_block, uut, scal, n_steps: int,
                  lagged: bool = False, bf16_compute: bool = False):
    """One outer iteration's U phase: the whole n_steps FISTA loop on U,
    then the new-u Gram blocks.

    ydt (2 n_s, N) = [Y.T; D.T]; rtt (n_ct, N) = Rt.T; a1_block
    (n_ct, n_s) and a2_block (n_u, n_s) are the known and unknown rows of
    alpha (rtt and a1_block None, or with n_ct = 0, when there is no known
    block); uut (2 n_u, N) = [u.T; u_prev.T]; scal the solver's scalar
    vector (slots A_U, L_W, L_W_PREV read). ``lagged`` takes each step's
    gradient at the old u (the unsupervised solve). ``bf16_compute`` as in
    the module docstring. ydt may hold Rt as its rows from 2 n_s on, with
    rtt None (the folded layout).

    Updates ``uut`` and ``scal[A_U]``, ``scal[L_W_PREV]`` in place (the
    JAX package donates the same buffers) and returns (gu (n_s, n_u, p),
    b_u (n_u, n_s), usq (0-d)) with p = n_ct + n_u,
    gu[s, u, q] = sum_i u_iu d_is [Rt | u]_iq, b_u = u'(d * y),
    usq = sum u^2.
    """
    folded = rtt is None and a1_block is not None
    ydt, rtt, a1_block = known_block(ydt, rtt, a1_block,
                                     (0, a2_block.shape[1]), uut)
    n, n_s, n_ct, n_u = _check_args(ydt, rtt, a1_block, a2_block, uut, scal)
    bf16c = bf16_compute and ydt.dtype == torch.bfloat16
    if ydt.device.type == "cpu":
        return u_phase_grams_plain(ydt, rtt, a1_block, a2_block, uut, scal,
                                   n_steps, lagged, bf16c)
    if ydt.device.type != "cuda":
        raise ValueError(f"u_phase_grams: unsupported device {ydt.device}")
    direct = not gram_form(n_u, n_s)
    lib = _build.load().lib
    plan = launch_plan(lib, uut.element_size(), n, n_s, n_ct, n_u, n_steps,
                       direct, bf16c)
    layout, smem, in_device = plan["layout"], plan["smem"], plan["in_device"]
    prefix = "dm_u_phase_grams" + _LAYOUT_SUFFIX[layout]
    p = n_ct + n_u
    size = plan["sizes"]
    partials = uut.new_empty((size["partials"],))
    tab = partials[size["partials"] - n_steps - 1:]
    out = uut.new_empty((size["out"],))
    state = uut.new_empty((size["state"],)) if in_device else None
    args = (ydt.data_ptr(), rtt.data_ptr(), a1_block.data_ptr(),
            a2_block.data_ptr(), uut.data_ptr(), scal.data_ptr(),
            tab.data_ptr(), partials.data_ptr(), out.data_ptr(),
            None if state is None else state.data_ptr(), n, n_s, n_ct, n_u,
            n_steps, int(lagged), int(direct))
    with torch.cuda.device(ydt.device):
        stream = torch.cuda.current_stream(ydt.device).cuda_stream
        if ydt.dtype == torch.bfloat16:
            err = getattr(lib, prefix + "_bf16")(*args, int(bf16c), stream)
        elif ydt.dtype == torch.float32:
            err = getattr(lib, prefix + "_f32")(*args, stream)
        else:
            err = getattr(lib, prefix + "_f64")(*args, stream)
    _build.check(err, "u_phase_grams", launch_case(
        n, n_s, n_ct, n_u, 1, ydt.dtype, uut.dtype, layout, in_device, smem,
        plan["ring"], direct=direct, bf16_compute=bf16c))
    if bf16c:
        u_phase_grams.launches_bf16_compute += 1
    elif ydt.dtype == torch.bfloat16:
        u_phase_grams.launches_bf16 += 1
    else:
        u_phase_grams.launches += 1
    count_forms(u_phase_grams.forms, wide=layout == "wide",
                global_layout=layout == "global",
                state_on_chip=n_u > REG_N_U and state is None,
                state_in_device=state is not None,
                bf16c_direct=bf16c and direct, rt_folded=folded)
    gu = out[:n_s * n_u * p].view(n_s, n_u, p)
    b_u = out[n_s * n_u * p:-1].view(n_u, n_s)
    return gu, b_u, out[-1]


# launches per storage form: float32/float64 data, bf16 data (float32
# state), and bf16 data with bf16_compute; and, apart, the launches of
# each form named in ``count_forms`` (a launch counts in both)
u_phase_grams.launches = 0
u_phase_grams.launches_bf16 = 0
u_phase_grams.launches_bf16_compute = 0
u_phase_grams.forms = {}


def u_phase_grams_plain(ydt, rtt, a1_block, a2_block, uut, scal,
                        n_steps: int, lagged: bool = False,
                        bf16_compute: bool = False):
    """The same function as ``u_phase_grams`` in ordinary tensor ops (the
    kernel's twin: the CPU path, and what the kernel is checked against
    on the card), in the same gram or direct dataflow. bf16 data are
    upcast to the state dtype; ``bf16_compute`` (bf16 data only) rounds
    through ``bf16_round`` at the kernel's points, and in the direct form
    only d y, as the JAX kernel's direct-form fallback does."""
    ydt, rtt, a1_block = known_block(ydt, rtt, a1_block,
                                     (0, a2_block.shape[1]), uut)
    bf16c = bf16_compute and ydt.dtype == torch.bfloat16
    st = uut.dtype
    n_u, n_s = a2_block.shape
    n_ct = rtt.shape[0]
    yt, dt, rtt = ydt[:n_s].to(st), ydt[n_s:].to(st), rtt.to(st)
    dy = bf16_round(dt * yt) if bf16c else dt * yt
    gram = gram_form(n_u, n_s)
    w2 = (a2_block[:, None, :] * a2_block[None, :, :]).reshape(n_u * n_u, n_s)
    if gram and bf16c:
        # the JAX kernel's c1 - c2 build over bf16 operands (c-major drt)
        drt = bf16_round(rtt[:, None, :] * dt[None]).reshape(
            n_ct * n_s, rtt.shape[1])
        wk = (a2_block[:, None, :] * a1_block[None]).reshape(n_u, n_ct * n_s)
        C = bf16_round(a2_block) @ dy - bf16_round(wk) @ drt
        M = (bf16_round(w2) @ dt).reshape(n_u, n_u, -1)
    else:
        dresid = dy if n_ct == 0 else dy - dt * (a1_block.T @ rtt)
        if gram:
            C = a2_block @ dresid                              # (n_u, N)
            M = (w2 @ dt).reshape(n_u, n_u, -1)
    if gram:

        def grad(g):
            return C - torch.einsum("uvn,vn->un", M, g)
    else:
        def grad(g):
            return a2_block @ (dresid - dt * (a2_block.T @ g))
    u, u_prev = uut[:n_u].clone(), uut[n_u:].clone()
    a, l_w, l_prev = (scal[k].clone() for k in (A_U, L_W, L_W_PREV))
    for _ in range(n_steps):
        a1 = nesterov_step(a)
        beta = momentum(a, a1, l_prev, l_w)
        u_t = u + beta * (u - u_prev)
        step = grad(u if lagged else u_t)
        u, u_prev = torch.clamp(u_t + step / l_w, 0.0, 1.0), u
        a, l_prev = a1, l_w
    if gram and bf16c:
        u_g = bf16_round(u)
        du = bf16_round(dt[:, None, :] * u_g[None])            # (n_s, n_u, N)
        gu = torch.einsum("sun,qn->suq", du, torch.cat([rtt, u_g], dim=0))
        b_u = u_g @ dy.T
    else:
        rext = torch.cat([rtt, u], dim=0)
        gu = torch.einsum("sn,un,qn->suq", dt, u, rext)
        b_u = u @ dy.T
    usq = torch.sum(u * u)
    uut[:n_u] = u
    uut[n_u:] = u_prev
    scal[A_U] = a
    scal[L_W_PREV] = l_prev
    return gu, b_u, usq


# ---------------------------------------------------------------------------
# K7 and K8: the single-phase U kernel and the one-pass Gram system
# ---------------------------------------------------------------------------

# slots of the single-phase kernels' scalar vector (K7 here, K9 in
# ``cuda_small``; small_common.cuh's kPh*): the Nesterov scalar, the
# Lipschitz constant and its previous value, read; the advanced scalar and
# previous constant, written
PH_A, PH_L, PH_L_PREV, PH_A_OUT, PH_L_PREV_OUT = range(5)


def phase_scalars(like, a, lip, lip_prev):
    """The single-phase kernels' scalar vector on ``like``'s device, in its
    dtype: (a, lip, lip_prev, a, lip_prev); the last two slots are the
    outputs. The inputs may be numbers or 0-d tensors on that device (no
    host read)."""
    def t(x):
        return torch.as_tensor(x, dtype=like.dtype,
                               device=like.device).reshape(())
    a, lip, lip_prev = t(a), t(lip), t(lip_prev)
    return torch.stack([a, lip, lip_prev, a, lip_prev])


def k7_smem(itemsize: int, n_ct: int) -> int:
    """Shared memory of K7 in bytes: the n_ct staged rows of Rt, 129
    values each (``itemsize`` is the state's), the formula of the kernel's
    ``dm_u_phase_smem`` export (``csrc/u_phase.cu``), which
    ``chip_smoke.py`` holds it to. Y, D and the alpha block are read from
    device memory: on an H100 staging them too (K1's resident layout) was
    as fast or slower at every shape timed (PERF.md, K7). Raises
    NotImplementedError, stating the bytes, where the rows pass the card's
    limit (n_ct > 225 in float64, 450 in float32)."""
    return _k7_fits(itemsize * n_ct * _LD, itemsize, n_ct)


def _k7_fits(smem: int, itemsize: int, n_ct: int) -> int:
    """``smem``, or NotImplementedError where it passes the card's limit."""
    if smem > SMEM_LIMIT:
        raise NotImplementedError(
            f"u_phase at n_ct = {n_ct} ({itemsize}-byte state) needs {smem} "
            f"bytes of shared memory, above the {SMEM_LIMIT} a block may use")
    return smem


def u_phase(yt, dt, rtt, a1_block, a2_block, ut, u_prev_t, a, l_w,
            l_w_prev, n_steps: int, *, lagged: bool = False):
    """The whole U FISTA inner loop in one pass (K7), the JAX package's
    ``u_phase`` without its TPU lane ``tile``.

    yt, dt (n_s, N) = Y.T, D.T; rtt (n_ct, N) = Rt.T and a1_block
    (n_ct, n_s), or both None (no known block); a2_block (n_u, n_s); ut,
    u_prev_t (n_u, N); a, l_w, l_w_prev numbers or 0-d tensors on the
    data's device. Data float32, float64 or bfloat16 (with a float32
    state), converted to the state dtype as it is read. ``lagged`` takes
    each step's gradient at the old u. Always the gram dataflow:
    C = a2 (D (Y - a1' Rt)), M rows a2 diag(d_i) a2', and
    u = clip(u_t + (C - M g) / l_w, 0, 1). Returns new (ut, u_prev_t,
    a_new, l_w_prev_new) and leaves the inputs as they were.
    """
    n_u, n_s = a2_block.shape
    n = yt.shape[1]
    if rtt is None:
        rtt = yt.new_empty((0, n))
    if a1_block is None:
        a1_block = ut.new_empty((0, n_s))
    check_dtypes("u_phase", (yt, dt, rtt), (a1_block, a2_block, ut,
                                            u_prev_t))
    n_ct = rtt.shape[0]
    if (yt.shape != (n_s, n) or dt.shape != (n_s, n)
            or rtt.shape != (n_ct, n) or a1_block.shape != (n_ct, n_s)
            or ut.shape != (n_u, n) or u_prev_t.shape != (n_u, n)):
        raise ValueError(
            f"u_phase: inconsistent shapes yt {tuple(yt.shape)}, dt "
            f"{tuple(dt.shape)}, rtt {tuple(rtt.shape)}, a1 "
            f"{tuple(a1_block.shape)}, a2 {tuple(a2_block.shape)}, ut "
            f"{tuple(ut.shape)}, u_prev_t {tuple(u_prev_t.shape)}")
    if n == 0 or n_u < 1:
        raise ValueError(f"u_phase: no CpG sites or no unknown rows (N = "
                         f"{n}, n_u = {n_u})")
    scal = phase_scalars(ut, a, l_w, l_w_prev)
    if yt.device.type == "cpu":
        return u_phase_plain(yt, dt, rtt, a1_block, a2_block, ut, u_prev_t,
                             scal[PH_A], scal[PH_L], scal[PH_L_PREV],
                             n_steps, lagged=lagged)
    if yt.device.type != "cuda":
        raise ValueError(f"u_phase: unsupported device {yt.device}")
    for t in (yt, dt, rtt, a1_block, a2_block, ut, u_prev_t):
        if not t.is_contiguous():
            raise ValueError("u_phase: operands must be contiguous")
    lib = _build.load().lib
    # the plan from the library's exports, the kernel's own copy
    smem = _k7_fits(lib.dm_u_phase_smem(ut.element_size(), n_ct),
                    ut.element_size(), n_ct)
    u_out, up_out = torch.empty_like(ut), torch.empty_like(u_prev_t)
    tab = ut.new_empty((n_steps + 1,))
    # above REG_N_U the gram form's state region, in device memory: K7,
    # which no solver runs, keeps one layout
    rows = lib.dm_state_rows(n_s, n_u, 0)
    state = (ut.new_empty((-(-n // SITES_PER_BLOCK) * rows, _LD)) if rows
             else None)
    dt_name = {torch.float32: "f32", torch.float64: "f64",
               torch.bfloat16: "bf16"}[yt.dtype]
    fn = getattr(lib, "dm_u_phase_" + dt_name)
    with torch.cuda.device(yt.device):
        err = fn(yt.data_ptr(), dt.data_ptr(), rtt.data_ptr(),
                 a1_block.data_ptr(), a2_block.data_ptr(), ut.data_ptr(),
                 u_prev_t.data_ptr(), u_out.data_ptr(), up_out.data_ptr(),
                 scal.data_ptr(), tab.data_ptr(),
                 None if state is None else state.data_ptr(), n, n_s,
                 n_ct, n_u, n_steps, int(lagged),
                 torch.cuda.current_stream(yt.device).cuda_stream)
    _build.check(err, "u_phase", launch_case(
        n, n_s, n_ct, n_u, 1, yt.dtype, ut.dtype, "K7", bool(rows), smem))
    if yt.dtype == torch.bfloat16:
        u_phase.launches_bf16 += 1
    else:
        u_phase.launches += 1
    count_forms(u_phase.forms, state_in_device=n_u > REG_N_U)
    return u_out, up_out, scal[PH_A_OUT], scal[PH_L_PREV_OUT]


# launches on float32/float64 data and on bf16 data; and, apart, those of
# each form named in ``count_forms``
u_phase.launches = 0
u_phase.launches_bf16 = 0
u_phase.forms = {}


def u_phase_plain(yt, dt, rtt, a1_block, a2_block, ut, u_prev_t, a, l_w,
                  l_w_prev, n_steps: int, *, lagged: bool = False):
    """The same function as ``u_phase`` in ordinary tensor ops, in the JAX
    kernel's association: C = a2 @ (dt * (yt - a1' rtt)) (just dt * yt
    without a known block), M = (a2 a2 pairs) @ dt; a, l_w, l_w_prev 0-d
    tensors or numbers."""
    st = ut.dtype
    y, d = yt.to(st), dt.to(st)
    resid = y if rtt is None or rtt.shape[0] == 0 else (
        y - a1_block.T @ rtt.to(st))
    n_u, n_s = a2_block.shape
    C = a2_block @ (d * resid)
    w2 = (a2_block[:, None, :] * a2_block[None, :, :]).reshape(n_u * n_u,
                                                               n_s)
    M = (w2 @ d).reshape(n_u, n_u, -1)

    def t(x):
        return torch.as_tensor(x, dtype=st, device=ut.device).reshape(())
    u, u_prev, a, l_w, l_prev = ut, u_prev_t, t(a), t(l_w), t(l_w_prev)
    for _ in range(n_steps):
        a1 = nesterov_step(a)
        beta = momentum(a, a1, l_prev, l_w)
        u_t = u + beta * (u - u_prev)
        grad = C - torch.einsum("uvn,vn->un", M, u if lagged else u_t)
        u, u_prev = torch.clamp(u_t + grad / l_w, 0.0, 1.0), u
        a, l_prev = a1, l_w
    return u, u_prev, a, l_prev


# K8's launch plan (csrc/grams.cu): 16 warps a block; warp tiles of
# _K8_WM x 4 MMA tiles; per data kind (0 float32, 1 float64, 2 bf16 data)
# the MMA tile's rows, a k-step's sites, the m-tiles of a warp tile and a
# lane's accumulators per MMA tile; the ring's (sites per tile, stages),
# the first that fits
_K8_WARPS, _K8_WN, _K8_MAX_SLICES = 16, 4, 8
_K8_KIND = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
_K8_MR, _K8_KS, _K8_WM, _K8_ACC = (16, 8, 16), (8, 4, 16), (2, 4, 2), (4, 2, 4)
_K8_DATA_SIZE, _K8_ACC_SIZE = (4, 8, 2), (4, 8, 4)
_K8_RINGS = ((512, 3), (512, 2), (256, 3), (256, 2), (128, 4), (64, 4), (64, 3),
             (64, 2), (32, 4), (32, 3), (32, 2))
_K8_SMS = {}


class GramsPlan(NamedTuple):
    """K8's launch plan: the data kind, sites per staged tile and ring
    stages, samples a block holds and their groups, float32/float64's
    column groups, warp tiles a block holds, the warps splitting each
    one's k-steps, the chunks of sites (one a block row of the grid) and
    the main pass's shared memory in bytes."""
    kind: int
    tile: int
    stages: int
    group_samples: int
    n_groups: int
    col_groups: int
    items: int
    slices: int
    n_chunks: int
    chunk_sites: int
    smem: int


def grams_entries(p: int, kind: int) -> int:
    """Entries a sample has in K8's partial buffer: G's p (p + 1) / 2
    pairs (all p^2 entries under bf16 data), b's p and ydy."""
    return (p * p if kind == 2 else p * (p + 1) // 2) + p + 1


def grams_smem(kind: int, p: int, group_samples: int, tile: int,
               stages: int, items: int, slices: int) -> int:
    """K8's shared memory in bytes (``dm_grams_smem``): the ring (stages x
    (2 group_samples + p) rows of a tile of data and 16 bytes), two
    operand buffers (float32/float64: D and D * Y on the samples padded to
    the MMA tile, float32's split in hi and lo, and p + 2 rows of R, ones
    and zeros; bf16: p rows of R and three (d, y, bf16(d y)) a sample and
    a zero row), the staged rows' aligned starts and offsets (12 bytes a
    row), and at a chunk's end the larger of the ydy sums and the slices'
    sums, which reuse them."""
    rows = 2 * group_samples + p
    ring = stages * rows * (tile * _K8_DATA_SIZE[kind] + 16)
    table = -(-12 * rows // 16) * 16
    es = _K8_ACC_SIZE[kind]
    if kind == 2:
        ops, ydy = (p + 3 * group_samples + 1) * (tile + 8) * 2, 0
    else:
        mr = _K8_MR[kind]
        a_rows = -(-group_samples // mr) * mr
        lda = 2 * tile if kind == 0 else tile + 4
        ldr = tile + 8 if kind == 0 else tile + 4
        ops = (2 * a_rows * lda + (p + 2) * ldr) * es
        ydy = a_rows * (tile // 2) * es
    slice_sums = ((slices - 1) * items * _K8_WM[kind] * _K8_WN
                  * _K8_ACC[kind] * 32 * es)
    return max(ring + 2 * ops + table, ydy, slice_sums)


@functools.lru_cache(maxsize=256)
def grams_plan(n: int, n_s: int, p: int, kind: int = 0,
               n_sm: int = 132) -> GramsPlan:
    """K8's launch plan for ``kind`` (0 float32, 1 float64, 2 bf16 data).
    float32 and float64 (the pair form): a block holds a group of samples
    whose m-tiles fit one warp tile (32 samples), and every column in warp
    tiles of 4 n-tiles, one a warp (G's pairs, then b's in tiles of their
    own), in column groups of 16 warp tiles; bf16 (the per-sample form): a block holds as
    many samples as its 16 warps hold X_s's warp tiles, at most 16. Where
    a block has fewer warp tiles than warps, the others split the
    k-steps (slices, at most 8). The ring takes the first (tile, stages)
    that fits the card's shared memory; the sites split into chunks of
    whole tiles, one block per SM (one wave) where every block holds the
    same samples and columns, else two (the groups' work differs). Raises
    NotImplementedError naming the shape and the bytes where nothing
    fits."""
    mr, wm = _K8_MR[kind], _K8_WM[kind]
    if kind == 2:
        mts, nts = -(-(p + 1) // 16), -(-(p + 1) // 8)
        tps = -(-mts // wm) * -(-nts // _K8_WN)
        if tps > _K8_WARPS:
            raise NotImplementedError(
                f"grams on bf16 data at p = {p} takes {tps} warp tiles a "
                f"sample, above the {_K8_WARPS} warps of a block")
        n_groups = -(-n_s // (_K8_WARPS // tps))
        group = -(-n_s // n_groups)
        col_groups, items = 1, group * tps
    else:
        mtiles = -(-n_s // mr)
        per = -(-mtiles // -(-mtiles // wm))
        group = min(n_s, per * mr)
        n_groups = -(-n_s // group)
        ranges = (-(-(p * (p + 1) // 2) // (8 * _K8_WN))
                  + -(-p // (8 * _K8_WN)))
        col_groups = -(-ranges // _K8_WARPS)
        items = -(-ranges // col_groups)
    for tile, stages in _K8_RINGS:
        # float32/float64 convert at most 2048 site pairs a tile (a lane
        # holds their ydy sums); bf16 data takes tiles of up to 512 sites
        if (tile > 256 and kind != 2) or (
                kind != 2 and -(-group // mr) * mr * tile // 2 > 2048):
            continue
        slices = max(1, min(_K8_MAX_SLICES, _K8_WARPS // items,
                            tile // _K8_KS[kind]))
        smem = grams_smem(kind, p, group, tile, stages, items, slices)
        if smem <= SMEM_LIMIT:
            break
    else:
        raise NotImplementedError(
            f"grams at n_s = {n_s}, p = {p} ({('float32', 'float64', 'bf16')[kind]}"
            f" data) needs {smem} bytes of shared memory, above the "
            f"{SMEM_LIMIT} a block may use")
    n_tiles = -(-n // tile)
    blocks = n_sm if n_groups * col_groups == 1 else 2 * n_sm
    n_chunks = max(1, min(n_tiles, -(-blocks // (n_groups * col_groups))))
    chunk_sites = -(-n_tiles // n_chunks) * tile
    return GramsPlan(kind, tile, stages, group, n_groups, col_groups, items,
                     slices, -(-n // chunk_sites), chunk_sites, smem)


def _sm_count(device) -> int:
    if device.index not in _K8_SMS:
        _K8_SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _K8_SMS[device.index]


def grams(yt, dt, rt):
    """One-pass per-sample Gram system (K8), the JAX package's ``grams``
    without its TPU lane ``tile``.

    yt, dt (n_s, N), rt (p, N), one dtype (float32, float64 or bfloat16).
    Returns (G (n_s, p, p), b (p, n_s), ydy (n_s,)) in the accumulation
    dtype (float32 for bf16): G[s] = R' diag(d_s) R, b = R'(d_s y_s),
    ydy = y_s' D y_s. On the card the sums run on the tensor cores
    (3xTF32 in float32, DMMA in float64, bf16 MMA under bf16 data), in
    float32 and float64 as G's pairs summed once and mirrored. Under bf16
    the products r d_s and d y are rounded to bf16 where the JAX kernel's
    compiled program rounds them (each a dot operand; (d y) y feeds a
    float32 sum unrounded), with float32 sums. ``ops/gram.sample_grams``
    leaves r d_s unrounded, as the solvers' programs do, so it is not
    K8's bf16 twin.
    """
    n_s, n = yt.shape
    p = rt.shape[0]
    dd = yt.dtype
    if dd not in (torch.float32, torch.float64, torch.bfloat16):
        raise TypeError(f"grams takes float32, float64 or bfloat16, not {dd}")
    for t in (dt, rt):
        if t.dtype != dd or t.device != yt.device:
            raise ValueError("grams: yt, dt and rt must share one dtype and "
                             "device")
    if dt.shape != (n_s, n) or rt.shape != (p, n) or n == 0 or p == 0:
        raise ValueError(f"grams: inconsistent shapes yt {tuple(yt.shape)}, "
                         f"dt {tuple(dt.shape)}, rt {tuple(rt.shape)}")
    if yt.device.type == "cpu":
        return grams_plain(yt, dt, rt)
    if yt.device.type != "cuda":
        raise ValueError(f"grams: unsupported device {yt.device}")
    for t in (yt, dt, rt):
        if not t.is_contiguous():
            raise ValueError("grams: operands must be contiguous")
    acc = state_dtype(dd)
    kind = _K8_KIND[dd]
    plan = grams_plan(n, n_s, p, kind, _sm_count(yt.device))
    lib = _build.load().lib
    partials = torch.empty((plan.n_chunks, n_s * grams_entries(p, kind)),
                           dtype=acc, device=yt.device)
    G = torch.empty((n_s, p, p), dtype=acc, device=yt.device)
    b = torch.empty((p, n_s), dtype=acc, device=yt.device)
    ydy = torch.empty((n_s,), dtype=acc, device=yt.device)
    with torch.cuda.device(yt.device):
        err = getattr(lib, f"dm_grams_{('f32', 'f64', 'bf16')[kind]}")(
            yt.data_ptr(), dt.data_ptr(), rt.data_ptr(), partials.data_ptr(),
            G.data_ptr(), b.data_ptr(), ydy.data_ptr(), n, plan.chunk_sites,
            n_s, p, plan.tile, plan.stages, plan.group_samples,
            plan.col_groups, plan.items, plan.slices, plan.n_chunks,
            torch.cuda.current_stream(yt.device).cuda_stream)
    _build.check(err, "grams")
    if dd == torch.bfloat16:
        grams.launches_bf16 += 1
    else:
        grams.launches += 1
    return G, b, ydy


grams.launches = 0
grams.launches_bf16 = 0


def grams_plain(yt, dt, rt):
    """The same function as ``grams`` in ordinary tensor ops, rounding
    through ``bf16_round`` where the kernel rounds under bf16 data; G one
    sample at a time, so no (n_s, p, N) temporary is made."""
    acc = state_dtype(yt.dtype)
    bf = yt.dtype == torch.bfloat16
    y, d, r = yt.to(acc), dt.to(acc), rt.to(acc)
    dy = bf16_round(d * y) if bf else d * y
    G = torch.empty((y.shape[0], r.shape[0], r.shape[0]), dtype=acc,
                    device=y.device)
    for s in range(y.shape[0]):
        rs = r * d[s]
        G[s] = (bf16_round(rs) if bf else rs) @ r.T
    return G, r @ dy.T, torch.sum(dy * y, dim=1)
