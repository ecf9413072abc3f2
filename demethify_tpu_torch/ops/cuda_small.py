"""K2, K3, K5 and K6, the glue kernels, and K9 and K10, their loops on an
assembled Gram system: wrappers, launch counts and plain twins.

``alpha_phase_full`` (K2) replaces the Pallas kernel
``demethify_tpu/ops/pallas_small.py::_alpha_full_kernel`` (through
``alpha_phase_full``); ``fw_phase_full`` (K3) replaces
``_fw_full_kernel`` (through ``fw_phase_full``). Their member-gridded
forms for the batched restarts, ``alpha_phase_full_multi`` (K5) and
``fw_phase_full_multi`` (K6), replace ``_alpha_full_multi_kernel`` and
``_fw_full_multi_kernel`` (through the wrappers of the same names). The
kernels are ``csrc/alpha_phase_full.cu`` (K2, K5) and
``csrc/fw_phase_full.cu`` (K3, K6); their source notes say what bounds
them on an H100 (latency: tiny data, n_steps serial steps) and what the
design does about it (one warp per sample column, the columns over
blocks and the members on the grid; the simplex projection, or the
Frank-Wolfe block argmin, inside the warp).

The multi forms take the known blocks (gtt, bt, ydy) either shared by the
members, as the batched restarts have them, or one per member with a
leading member axis, as the weighted bootstrap has them (each replicate's
w-weighted blocks); the kernels read the latter at a member stride and
the former at stride 0, one body for both.

On a CUDA tensor a wrapper launches its kernel or raises; only CPU
tensors take the plain PyTorch twins (``*_plain``; the multi twins write
the member axis out as more columns). Without a known block (n_ct = 0,
the unsupervised solve) the known operands are empty and never read.
The multi forms leave a member whose ACTIVE slot is 0 exactly as it was
and set an active member's ACTIVE slot for the next outer iteration from
|new cost - old cost| >= TOL (the reference's termination test, per
member).

Shapes: p <= 32 rows keep a column's Gram rows in the lanes' registers
(the register form); from 33 to 64 rows lane q holds rows q and q + 32
of the column in registers and the warp's slab of shared memory holds
the column's Gram matrix at an odd row stride (the two-row form,
``two_row_stride``). Above 64 rows each column gets a block, or a
thread-block cluster of up to 16 blocks (the largest an H100 places),
with one row a thread and the column's Gram rows spread over the blocks'
shared memory (the column-block form, ``alpha_column_plan``,
``fw_column_plan``; the simplex projection ranks the column across the
cluster); past 16 blocks (K2, K5 and K9 from p = 625 in float64, 905 in
float32; K3, K6 and K10 from 671 and 947) the device rows: the same
loop on 16 blocks a column, each block's Gram rows in its region of a
device-memory buffer the wrapper allocates (``column_work``), up to
1024 threads a block. Every kernel takes every p. The register form
of K2, K3, K5 and K6 runs its warp collectives to a row bucket of 8, 16
or 32 lanes and gives every column its own warp, over several blocks
past 16 columns (``alpha_plan``), with the cost summed in a fixed order
that does not depend on the grid; K3 and K6 read their step sizes from
a table built once per launch. The two-row form gives each column a
block of its own, and its alpha is the column blocks' bit for bit, as
the column blocks' and the device rows' alpha, cost and l_w are those of
the one-block wide loop they replaced. A column whose v holds a NaN
projects to NaN in every row in every form, as the JAX kernels and the
twins give it.
K9 and K10 run K2's and K3's loops at the same bucket and plans
(``phase_plan``): in one block in the register form, a column a block
in the two-row form, K2's and K3's column blocks and device rows above
64 rows (``csrc/column_steps.cuh`` holds their loops, one body each).

``row_mask`` (K2, (p,)) and ``row_mask_b`` (K5, (B, p), one per member)
are the JAX kernels' masks (``pallas_small.py:281-282, 409-410``): before
each projection the rows whose mask is not > 0 are set to -1e30, which
projects them to exactly 0 and the other rows as the smaller vector
would be. ``fused.partial_ref_solve_fused(row_mask=)`` runs K2's; no
solver runs K5's yet.

``alpha_phase`` (K9) replaces ``_alpha_kernel`` (through
``alpha_phase``, ``pallas_small.py:70, 97``) and ``fw_phase`` (K10)
``_fw_kernel`` (through ``fw_phase``, ``pallas_small.py:204, 213``):
K2's and K3's loops (``csrc/glue_steps.cuh``, ``csrc/column_steps.cuh``,
one body each) on a G and b the caller assembled, with no cost or
Lipschitz epilogue (``csrc/alpha_phase.cu``, ``csrc/fw_phase.cu``). They
take the JAX functions' operands, return new arrays and leave their
inputs as they were; K9's scalars come back as 0-d tensors advanced on the device. No
solver runs them.
"""

import ctypes

import torch

from demethify_tpu_torch.ops import _build
from demethify_tpu_torch.ops.cuda_kernels import (
    A_ALPHA,
    ACTIVE,
    COST,
    DMAX2,
    L_H_PREV,
    L_W,
    N_SCAL,
    N_SCAL_MULTI,
    PH_A,
    PH_A_OUT,
    PH_L,
    PH_L_PREV,
    PH_L_PREV_OUT,
    RT_SQ,
    SMEM_LIMIT,
    TOL,
    count_forms,
    member_stride,
    phase_scalars,
)
from demethify_tpu_torch.ops.fista import fista_alpha_gram
from demethify_tpu_torch.ops.frank_wolfe import frank_wolfe_gram

REG_P = 32     # rows the register form holds, one lane per row (kMaxP)
TWO_ROW_P = 64  # rows the two-row form holds, two a lane (kTwoRowP)
# the wide form's slabs may take the card's limit less 1 KB for the
# kernels' static shared memory (small_common.cuh, kGlueSmemLimit)
_GLUE_LIMIT = SMEM_LIMIT - 1024
# the register form of K2, K3, K5, K6: its row buckets, and how it spreads
# the columns (one block up to ONE_BLOCK_COLUMNS, then blocks of
# BLOCK_COLUMNS)
ROW_BUCKETS = (8, 16, 32)
ONE_BLOCK_COLUMNS = 16
BLOCK_COLUMNS = 8


def alpha_plan(p: int, n_s: int):
    """(row bucket, columns per block, blocks per member) of the register
    and two-row forms of K2, K5 (``csrc/alpha_phase_full.cu``), K3 and K6
    (``csrc/fw_phase_full.cu``), p <= 64: in the register form (p <= 32)
    the smallest bucket P >= p (``dm_row_bucket``; K10 takes the same), to
    which every warp collective of a step runs, with one warp per column,
    all n_s columns in one block up to ONE_BLOCK_COLUMNS, else blocks of
    BLOCK_COLUMNS (columns [x cols, (x + 1) cols) in block x); in the
    two-row form TWO_ROW_P with one column a block, the one-warp block
    its kernels are written for (their step is bound by the SM's shuffle,
    FP64 and issue throughput, so a column an SM is about the fastest;
    K9 and K10 take the same grid).
    The kernel sums the columns' cost terms in a fixed order whatever the
    grid: column s into group s mod min(n_s, 32), each group in column
    order, then the groups in order."""
    if not 1 <= p <= TWO_ROW_P:
        raise ValueError(f"alpha_plan: p = {p} rows has no register or "
                         f"two-row plan (1-{TWO_ROW_P})")
    if p <= REG_P:
        bucket = next(b for b in ROW_BUCKETS if b >= p)
        cols = n_s if n_s <= ONE_BLOCK_COLUMNS else BLOCK_COLUMNS
    else:
        bucket, cols = TWO_ROW_P, 1
    return bucket, cols, -(-n_s // cols)


def two_row_stride(p: int) -> int:
    """Row stride of the two-row form's Gram slab (``dm_two_row_stride``):
    p rounded up to odd, so that the 32 lanes' row starts fall in distinct
    banks (a float32 load in one wavefront, a float64 load in the two a
    64-bit load needs)."""
    return p | 1


# per (device, dtype): the register form's per-column cost terms (K2, K3,
# K5, K6) and their members' finished-block tickets (int32, zero between
# launches: the last block of a member resets its own). Reused by every
# launch, which is safe as the launches run on one stream one after
# another (the solvers' way); a fresh ticket buffer would cost a fill
# launch per call
_GLUE_SCRATCH = {}


def _glue_scratch(like, n_b: int, n_s: int):
    """(colsum (n_b, 3, n_s), tickets (n_b,)) for a register-form launch."""
    key = (like.device, like.dtype)
    colsum, tickets = _GLUE_SCRATCH.get(key, (None, None))
    if colsum is None or colsum.numel() < n_b * 3 * n_s:
        colsum = like.new_empty((n_b * 3 * n_s,))
    if tickets is None or tickets.numel() < n_b:
        tickets = torch.zeros((n_b,), dtype=torch.int32, device=like.device)
    _GLUE_SCRATCH[key] = (colsum, tickets)
    return colsum, tickets


def _reg_args(like, n_b, p, n_s):
    """The (colsum, tickets, bucket, cols) launch arguments of K2, K3, K5
    and K6 in the register and two-row forms (p <= 64): the per-column
    cost terms, the tickets and the plan."""
    bucket, cols, _ = alpha_plan(p, n_s)
    colsum, tickets = _glue_scratch(like, n_b, n_s)
    return colsum.data_ptr(), tickets.data_ptr(), bucket, cols


def glue_smem(itemsize: int, p: int, n_s: int):
    """(warps per block, dynamic shared memory in bytes) of the glue
    kernels at p rows and n_s columns: (min(n_s, 32), 0) in the register
    form (p <= 32; K2's and K5's register form spreads its columns by
    ``alpha_plan`` instead); in the two-row form (p <= 64) ``alpha_plan``'s
    one column a block, its slab p x ``two_row_stride(p)`` values (the
    momentum or step-size table follows the slab where it fits); above 64
    rows the one-block wide loop that the column blocks replaced, whose
    warps the column blocks' cost still counts its groups in
    (``fw_column_groups``, ``alpha_column_groups``): one slab of
    p x p + 6 p values per warp and as many warps as fit, at most
    min(n_s, 32) -- the kernels' ``dm::glue_warps``. Both are the
    kernels' ``dm_glue_smem``, which ``chip_smoke.py`` holds this to. 0
    warps when one slab does not fit."""
    n_warps = min(n_s, 32)
    if p <= REG_P:
        return n_warps, 0
    if p <= TWO_ROW_P:
        return 1, itemsize * p * two_row_stride(p)
    slab = itemsize * (p * p + 6 * p)
    n_warps = min(n_warps, _GLUE_LIMIT // slab)
    return n_warps, max(n_warps, 1) * slab


# the column-block form (p > 64): at most MAX_COLUMN_BLOCKS blocks a
# column, the largest cluster an H100 places (kMaxColumnBlocks; past the
# portable 8 with cudaFuncAttributeNonPortableClusterSizeAllowed), and at
# most DEVICE_ROW_THREADS threads a block in the device rows
MAX_COLUMN_BLOCKS = 16
DEVICE_ROW_THREADS = 1024
COLUMN_PLAN_KEYS = ("blocks", "rows", "threads", "device")
# where a column's values live ("device", csrc/small_common.cuh):
# everything in shared memory (the column blocks), G_s's rows in device
# memory (the device rows), or the rows of p values there too
SHARED_ROWS, DEVICE_ROWS, DEVICE_COLUMN = 0, 1, 2
# the device rows' blocks keep 2 KB of the card's limit for their static
# shared memory (the Frank-Wolfe loop's double-buffered minima of 32 warps
# take 1.5 KB in float64; kDeviceRowsLimit)
_DEVICE_ROWS_LIMIT = _GLUE_LIMIT - 1024
# the rows of p and of R values a block keeps beside its R rows of G_s
# (K2, K5, K9: alpha, alpha_prev, a_t, v twice, the ranks and their sums;
# K3, K6, K10: alpha, then b and G_s alpha of its rows)
_LINES = {"alpha": (7, 0), "fw": (1, 2)}


def _column_plan(itemsize: int, p: int, p_rows: int, r_rows: int) -> dict:
    """The fewest blocks C <= MAX_COLUMN_BLOCKS whose R = ceil(p / C) rows
    of G_s and p_rows rows of p values and r_rows of R values fit one
    block's shared memory (the card's limit less 1 KB), as a plan dict
    (device SHARED_ROWS); past that C = MAX_COLUMN_BLOCKS with G_s's rows
    in device memory and the rest in shared memory (DEVICE_ROWS, "bytes"
    the rest's), or where the rest does not fit, in device memory too
    (DEVICE_COLUMN, "bytes" 0). "threads": R rounded up to warps, at most
    DEVICE_ROW_THREADS (past that a thread owns several rows). The rest
    stays in shared memory while it takes at most the card's limit less
    2 KB."""
    for c in range(1, MAX_COLUMN_BLOCKS + 1):
        rows = -(-p // c)
        n_bytes = itemsize * (rows * p + p_rows * p + r_rows * rows)
        if n_bytes <= _GLUE_LIMIT:
            return {"blocks": c, "rows": rows, "threads": 32 * -(-rows // 32),
                    "device": SHARED_ROWS, "bytes": n_bytes}
    c = MAX_COLUMN_BLOCKS
    rows = -(-p // c)
    threads = min(DEVICE_ROW_THREADS, 32 * -(-rows // 32))
    line = itemsize * (p_rows * p + r_rows * rows)
    if line <= _DEVICE_ROWS_LIMIT:
        return {"blocks": c, "rows": rows, "threads": threads,
                "device": DEVICE_ROWS, "bytes": line}
    return {"blocks": c, "rows": rows, "threads": threads,
            "device": DEVICE_COLUMN, "bytes": 0}


def fw_column_plan(itemsize: int, p: int) -> dict:
    """K3's and K6's plan above 64 rows (``csrc/small_common.cuh``
    ``column_plan``; the kernels' ``dm_fw_column_plan``, which
    ``chip_smoke.py`` holds this to): "blocks" C, the fewest blocks of a
    thread-block cluster whose shared memory holds the column, at most
    MAX_COLUMN_BLOCKS; "rows" R = ceil(p / C), block c owning rows
    [c R, min(c R + R, p)), one a thread; "threads", R rounded up to
    warps; "device" SHARED_ROWS; "bytes", a block's dynamic shared memory:
    R rows of G_s, alpha (p) and R values each of b and G_s alpha, at most
    the card's limit less 1 KB. Past MAX_COLUMN_BLOCKS the device rows
    (``_column_plan``; one block's region of the buffer holds
    ``column_work``'s share). A launch is a grid of (n_s C, members)
    blocks in clusters of C."""
    return _column_plan(itemsize, p, *_LINES["fw"])


def alpha_column_plan(itemsize: int, p: int) -> dict:
    """K2's and K5's plan above 64 rows (``csrc/small_common.cuh``
    ``column_plan``; the kernels' ``dm_alpha_column_plan``, which
    ``chip_smoke.py`` holds this to), as ``fw_column_plan``'s but for the
    projection's rows: "bytes" holds R rows of G_s and seven rows of p
    (alpha, alpha_prev, the momentum point, v twice by step parity, the
    values in rank order and their prefix sums); the momentum table
    follows them in a launch where it fits. One block to p = 166 in
    float64 (237 in float32), clusters of up to MAX_COLUMN_BLOCKS to
    p = 624 (904); past that the device rows, the seven rows of p in
    shared memory to p = 4,114 (8,228)."""
    return _column_plan(itemsize, p, *_LINES["alpha"])


def column_work(kernel: str, itemsize: int, p: int, n_s: int) -> int:
    """Elements per member of the device buffer K2, K5 and K9 (``kernel``
    "alpha") or K3, K6 and K10 ("fw") take at p rows and n_s columns: 0 in
    the column blocks; in the device rows each block's R rows of G_s (and
    in DEVICE_COLUMN its rows of p and R values), n_s C blocks a member.
    The kernels' ``dm_alpha_column_work`` and ``dm_fw_column_work``,
    which ``chip_smoke.py`` holds this to."""
    p_rows, r_rows = _LINES[kernel]
    plan = _column_plan(itemsize, p, p_rows, r_rows) if p > TWO_ROW_P else {
        "device": SHARED_ROWS}
    if plan["device"] == SHARED_ROWS:
        return 0
    block = plan["rows"] * p
    if plan["device"] == DEVICE_COLUMN:
        block += p_rows * p + r_rows * plan["rows"]
    return n_s * plan["blocks"] * block


def lib_fw_column_plan(lib, itemsize: int, p: int) -> dict:
    """``fw_column_plan`` from the library's ``dm_fw_column_plan`` export
    (the kernels' own copy)."""
    out = (ctypes.c_int * len(COLUMN_PLAN_KEYS))()
    n_bytes = lib.dm_fw_column_plan(int(itemsize), int(p), out)
    return dict(zip(COLUMN_PLAN_KEYS, out), bytes=n_bytes)


def lib_alpha_column_plan(lib, itemsize: int, p: int) -> dict:
    """``alpha_column_plan`` from the library's ``dm_alpha_column_plan``
    export (the kernels' own copy)."""
    out = (ctypes.c_int * len(COLUMN_PLAN_KEYS))()
    n_bytes = lib.dm_alpha_column_plan(int(itemsize), int(p), out)
    return dict(zip(COLUMN_PLAN_KEYS, out), bytes=n_bytes)


def lib_column_capacity(lib, kernel: str, itemsize: int, p: int) -> dict:
    """What the card gives K2's (``kernel`` "alpha") or K3's ("fw")
    column kernel at p rows, in the layout its plan takes there: "cluster",
    the largest cluster it would place
    (``cudaOccupancyMaxPotentialClusterSize``), and "clusters", how many
    clusters of the plan's blocks it holds at once
    (``cudaOccupancyMaxActiveClusters``). Raises on a CUDA error."""
    out = (ctypes.c_int * 2)()
    err = getattr(lib, f"dm_{kernel}_column_capacity")(int(itemsize), int(p),
                                                        out)
    _build.check(err, f"dm_{kernel}_column_capacity", f"p = {p}, itemsize "
                 f"{itemsize}")
    return {"cluster": out[0], "clusters": out[1]}


# K9's and K10's forms, by the code of the kernels' plan exports
# (csrc/column_steps.cuh PhaseForm)
PHASE_FORMS = ("register", "two_row", "column_blocks", "device_rows")
PHASE_PLAN_KEYS = ("form", "bucket", "blocks", "rows", "threads", "device")


def phase_plan(kernel: str, itemsize: int, p: int) -> dict:
    """K9's (``kernel`` "alpha") or K10's ("fw") form at p rows of
    itemsize-byte values, the kernels' ``dm_alpha_phase_plan`` and
    ``dm_fw_phase_plan`` (which ``chip_smoke.py`` holds this to): "form"
    one of PHASE_FORMS, "bucket" the row bucket (8, 16 or 32; 64 in the
    two-row form; 0 above), "blocks", "rows", "threads" and "device"
    K2's (``alpha_column_plan``, K9) or K3's (``fw_column_plan``, K10)
    column plan above 64 rows, "bytes" a block's dynamic shared memory
    before any step table (the two-row slab, or the column plan's; 0 in
    the register form). The device rows take the shapes past 16 column
    blocks, their buffer ``column_work`` elements; every p >= 1 has a
    form."""
    if p < 1:
        raise ValueError(f"phase_plan: p = {p} rows")
    plan = {"bucket": 0, "blocks": 0, "rows": 0, "threads": 0,
            "device": SHARED_ROWS, "bytes": 0}
    if p <= REG_P:
        return dict(plan, form="register", bucket=alpha_plan(p, 1)[0])
    if p <= TWO_ROW_P:
        return dict(plan, form="two_row", bucket=TWO_ROW_P,
                    bytes=itemsize * p * two_row_stride(p))
    cols = {"alpha": alpha_column_plan, "fw": fw_column_plan}[kernel](
        itemsize, p)
    return dict(cols, form="column_blocks" if cols["device"] == SHARED_ROWS
                else "device_rows", bucket=0)


def lib_phase_plan(lib, kernel: str, itemsize: int, p: int) -> dict:
    """``phase_plan`` from the library's ``dm_alpha_phase_plan`` or
    ``dm_fw_phase_plan`` export (the kernels' own copy)."""
    out = (ctypes.c_int * len(PHASE_PLAN_KEYS))()
    n_bytes = getattr(lib, f"dm_{kernel}_phase_plan")(int(itemsize), int(p),
                                                       out)
    plan = dict(zip(PHASE_PLAN_KEYS, out), bytes=n_bytes)
    plan["form"] = PHASE_FORMS[plan["form"]]
    return plan


# the warps a block of the one-block wide loop took where its slabs were
# in device memory, by itemsize: K3's and K6's kernels' registers allowed
# 896 threads in float64 (cudaFuncGetAttributes on an H100), 1024 in
# float32; K2's and K5's (128 and 95 registers a thread) 512 and 640. The
# column blocks and the device rows keep that loop's groups, so its cost
# and l_w keep their bits
SLAB_LOOP_WARPS = {4: 32, 8: 28}
ALPHA_SLAB_LOOP_WARPS = {4: 20, 8: 16}


def _column_groups(itemsize, p, n_s, slab_warps):
    n_warps = glue_smem(itemsize, p, n_s)[0]
    return n_warps if n_warps >= 1 else min(n_s, slab_warps)


def fw_column_groups(itemsize: int, p: int, n_s: int) -> int:
    """The groups in which K3's and K6's column blocks sum a member's
    columns into its cost and l_w (``dm_fw_column_groups``): the warps of
    the one-block wide loop they replaced (``glue_smem``'s; where its
    slabs were in device memory, min(n_s, 32) capped by SLAB_LOOP_WARPS),
    so the sums keep that loop's order and bits."""
    return _column_groups(itemsize, p, n_s, SLAB_LOOP_WARPS[itemsize])


def alpha_column_groups(itemsize: int, p: int, n_s: int) -> int:
    """The groups in which K2's and K5's column blocks sum a member's
    columns (``dm_alpha_column_groups``): the warps of the one-block wide
    loop they replaced, as ``fw_column_groups``, its device-slab kernels'
    cap from ALPHA_SLAB_LOOP_WARPS."""
    return _column_groups(itemsize, p, n_s, ALPHA_SLAB_LOOP_WARPS[itemsize])


def _column_args(kernel, like, n_b, p, n_s):
    """K2's, K3's, K5's and K6's launch arguments (colsum, tickets, bucket,
    cols, the work buffer) and, above 64 rows, the library's column plan
    of ``kernel`` ("alpha": ``lib_alpha_column_plan``, "fw":
    ``lib_fw_column_plan``): the register and two-row forms' as
    ``_reg_args``; the column blocks' cost terms and tickets; in the
    device rows a work buffer of ``column_work`` elements a member (kept
    alive by the caller until the launch is queued; else None)."""
    if p <= TWO_ROW_P:
        return (*_reg_args(like, n_b, p, n_s), None, None)
    lib_plan = {"alpha": lib_alpha_column_plan,
                "fw": lib_fw_column_plan}[kernel]
    plan = lib_plan(_build.load().lib, like.element_size(), p)
    colsum, tickets = _glue_scratch(like, n_b, n_s)
    work = None
    if plan["device"] != SHARED_ROWS:
        work = like.new_empty(
            (n_b * column_work(kernel, like.element_size(), p, n_s),))
    return colsum.data_ptr(), tickets.data_ptr(), 0, 0, work, plan


def _where(plan):
    """A column plan in words, for an error."""
    where = (f"C = {plan['blocks']}, {plan['rows']} rows and "
             f"{plan['threads']} threads a block, {plan['bytes']} bytes of "
             f"shared memory")
    if plan["device"] == SHARED_ROWS:
        return "column blocks " + where
    return ("device rows " + where + (
        ", G_s's rows in device memory" if plan["device"] == DEVICE_ROWS
        else ", G_s's rows and the rows of p in device memory"))


def _column_case(p, n_s, n_b, like, plan, n_steps=None):
    """A K2, K3, K5 or K6 launch's shape, dtype and plan, for its error
    (K2's and K5's with the steps, whose momentum table follows the
    plan's bytes where it fits)."""
    where = _where(plan) if plan else "p <= 64"
    steps = "" if n_steps is None else f", {n_steps} steps"
    return f"p = {p}, n_s = {n_s}, B = {n_b}, {like.dtype}{steps}, {where}"


def _ptr(t):
    """A tensor's device pointer, or None (NULL) for no tensor."""
    return None if t is None else t.data_ptr()


def _mask_arg(mask, like, shape, name):
    """A row mask as the kernels read it: in ``like``'s dtype and device,
    contiguous, of ``shape`` (None stays None)."""
    if mask is None:
        return None
    mask = torch.as_tensor(mask).to(device=like.device, dtype=like.dtype)
    if mask.shape != shape:
        raise ValueError(f"{name}: the row mask must be {tuple(shape)}, got "
                         f"{tuple(mask.shape)}")
    return mask.contiguous()


def _check_args(name, tensors, alpha, n_u, gtt, bt, gu, bu, ydy, scal,
                extra_ok):
    """Device, dtype, contiguity and shapes; returns (p, n_s, n_ct)."""
    dev, dt = alpha.device, alpha.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"{name} takes float32 or float64, not {dt}")
    for t in tensors:
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{name}: all operands must share one device "
                             f"and dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    p, n_s = alpha.shape
    n_ct = p - n_u
    if not (1 <= n_u <= p and gtt.shape == (n_s, n_ct, n_ct)
            and bt.shape == (n_ct, n_s) and gu.shape == (n_s, n_u, p)
            and bu.shape == (n_u, n_s) and ydy.shape == (n_s,)
            and scal.shape == (N_SCAL,) and extra_ok(p, n_s)):
        raise ValueError(f"{name}: inconsistent shapes")
    return p, n_s, n_ct


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _count_glue(forms, p, work, masked=False):
    """K2's, K3's, K5's and K6's launch by form (``count_forms``): above 32
    rows ("wide"), the two-row form, the column blocks, or the device rows
    (a work buffer)."""
    count_forms(forms, wide=p > REG_P, two_row=REG_P < p <= TWO_ROW_P,
                column_blocks=work is None and p > TWO_ROW_P,
                device_rows=work is not None, masked=masked)


def alpha_phase_full(gtt, bt, gu, bu, usq, ydy, alpha, alpha_prev, scal,
                     n_steps: int, n_u: int, row_mask=None):
    """One launch: Gram assembly, the alpha FISTA loop, l_w and the cost.

    gtt (n_s, n_ct, n_ct), bt (n_ct, n_s), ydy (n_s,) are the
    loop-invariant known blocks (gtt (n_s, 0, 0) and bt (0, n_s) when
    there is none); gu (n_s, n_u, p), bu (n_u, n_s), usq
    (0-d) come from K1. alpha, alpha_prev (p, n_s) and the scalar vector
    scal (slots A_ALPHA, L_H_PREV advanced; L_W, COST written; RT_SQ,
    DMAX2 read) are updated in place. ``row_mask`` (p,), bool or numeric:
    the rows not > 0 project to exactly 0 (the module docstring). Returns
    nothing.
    """
    p, n_s, n_ct = _check_args(
        "alpha_phase_full",
        (gtt, bt, gu, bu, usq, ydy, alpha, alpha_prev, scal), alpha, n_u,
        gtt, bt, gu, bu, ydy, scal,
        lambda p, n_s: usq.numel() == 1 and alpha_prev.shape == (p, n_s))
    mask = _mask_arg(row_mask, alpha, (p,), "alpha_phase_full")
    if alpha.device.type == "cpu":
        alpha_phase_full_plain(gtt, bt, gu, bu, usq, ydy, alpha, alpha_prev,
                               scal, n_steps, n_u, mask)
        return
    if alpha.device.type != "cuda":
        raise ValueError(f"alpha_phase_full: unsupported device "
                         f"{alpha.device}")
    lib = _build.load().lib
    fn = (lib.dm_alpha_phase_full_f32 if alpha.dtype == torch.float32
          else lib.dm_alpha_phase_full_f64)
    with torch.cuda.device(alpha.device):
        colsum, tickets, bucket, cols, work, plan = _column_args(
            "alpha", alpha, 1, p, n_s)
        err = fn(gtt.data_ptr(), bt.data_ptr(), gu.data_ptr(),
                 bu.data_ptr(), usq.data_ptr(), ydy.data_ptr(),
                 alpha.data_ptr(), alpha_prev.data_ptr(), scal.data_ptr(),
                 _ptr(mask), colsum, tickets, _ptr(work), n_s, n_ct, n_u,
                 n_steps, bucket, cols, _stream(alpha))
    _build.check(err, "alpha_phase_full",
                 _column_case(p, n_s, 1, alpha, plan, n_steps))
    alpha_phase_full.launches += 1
    _count_glue(alpha_phase_full.forms, p, work, masked=mask is not None)


alpha_phase_full.launches = 0
alpha_phase_full.forms = {}


def assemble_G_b(gtt, bt, gu, bu):
    """Full per-sample Grams G (n_s, p, p) and b (p, n_s) from the known
    blocks and K1's new-u blocks (``_assemble_G_b`` of the JAX package)."""
    n_ct = gtt.shape[1]
    top = torch.cat([gtt, gu[:, :, :n_ct].transpose(1, 2)], dim=2)
    return torch.cat([top, gu], dim=1), torch.cat([bt, bu], dim=0)


def alpha_phase_full_plain(gtt, bt, gu, bu, usq, ydy, alpha, alpha_prev,
                           scal, n_steps: int, n_u: int, row_mask=None):
    """The same function as ``alpha_phase_full`` in ordinary tensor ops."""
    G, b = assemble_G_b(gtt, bt, gu, bu)
    l_h = (scal[RT_SQ] + usq.reshape(())) * scal[DMAX2]
    al, ap, a, l_h_prev = fista_alpha_gram(
        alpha.clone(), alpha_prev.clone(), scal[A_ALPHA].clone(),
        scal[L_H_PREV].clone(), l_h, G, b, n_steps,
        None if row_mask is None else row_mask > 0)
    grad = b - torch.einsum("spq,qs->ps", G, al)
    cost = torch.sum(ydy) - torch.sum(b * al) - torch.sum(al * grad)
    alpha.copy_(al)
    alpha_prev.copy_(ap)
    scal[A_ALPHA] = a
    scal[L_H_PREV] = l_h_prev
    scal[L_W] = torch.sum(al[-n_u:] ** 2) * scal[DMAX2]
    scal[COST] = cost


def fw_phase_full(gtt, bt, gu, bu, ydy, alpha, purity, scal, n_steps: int,
                  n_u: int):
    """One launch: Gram assembly, the whole Frank-Wolfe loop, l_w and the
    cost (K3).

    gtt, bt, ydy, gu, bu as for ``alpha_phase_full``; alpha (p, n_s) is
    [known; unknown] and purity (n_s,) the known-block mass of each column
    (the flipped 1 - p/100 of the CLI). alpha is updated in place; scal's
    L_W and COST are written and DMAX2 read. Returns nothing.
    """
    p, n_s, n_ct = _check_args(
        "fw_phase_full", (gtt, bt, gu, bu, ydy, alpha, purity, scal), alpha,
        n_u, gtt, bt, gu, bu, ydy, scal,
        lambda p, n_s: purity.shape == (n_s,))
    if alpha.device.type == "cpu":
        fw_phase_full_plain(gtt, bt, gu, bu, ydy, alpha, purity, scal,
                            n_steps, n_u)
        return
    if alpha.device.type != "cuda":
        raise ValueError(f"fw_phase_full: unsupported device "
                         f"{alpha.device}")
    lib = _build.load().lib
    fn = (lib.dm_fw_phase_full_f32 if alpha.dtype == torch.float32
          else lib.dm_fw_phase_full_f64)
    with torch.cuda.device(alpha.device):
        colsum, tickets, bucket, cols, work, plan = _column_args(
            "fw", alpha, 1, p, n_s)
        err = fn(gtt.data_ptr(), bt.data_ptr(), gu.data_ptr(),
                 bu.data_ptr(), ydy.data_ptr(), alpha.data_ptr(),
                 purity.data_ptr(), scal.data_ptr(), colsum, tickets,
                 _ptr(work), n_s, n_ct, n_u, n_steps, bucket, cols,
                 _stream(alpha))
    _build.check(err, "fw_phase_full", _column_case(p, n_s, 1, alpha, plan))
    fw_phase_full.launches += 1
    _count_glue(fw_phase_full.forms, p, work)


fw_phase_full.launches = 0
fw_phase_full.forms = {}


def fw_phase_full_plain(gtt, bt, gu, bu, ydy, alpha, purity, scal,
                        n_steps: int, n_u: int):
    """The same function as ``fw_phase_full`` in ordinary tensor ops."""
    G, b = assemble_G_b(gtt, bt, gu, bu)
    n_ct = alpha.shape[0] - n_u
    a1, a2 = frank_wolfe_gram(alpha[:n_ct], alpha[n_ct:], G, b, purity,
                              n_steps)
    al = torch.cat([a1, a2], dim=0)
    grad = b - torch.einsum("spq,qs->ps", G, al)
    alpha.copy_(al)
    scal[L_W] = torch.sum(a2 * a2) * scal[DMAX2]
    scal[COST] = torch.sum(ydy) - torch.sum(b * al) - torch.sum(al * grad)


# ---------------------------------------------------------------------------
# K5 and K6: the same kernels with one thread block per restart member
# ---------------------------------------------------------------------------


def _check_multi(name, alpha_b, n_u, shared, members, scal_b):
    """Device, dtype and, for the kernel, layout of the multi forms'
    operands: ``shared`` (gtt, bt, ydy, ...) contiguous, ``members``
    (B, ...) with contiguous per-member blocks, scal_b (B, N_SCAL_MULTI)
    contiguous. Returns (n_b, p, n_s, n_ct)."""
    dev, dt = alpha_b.device, alpha_b.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"{name} takes float32 or float64, not {dt}")
    for t in (*shared, *members, scal_b):
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{name}: all operands must share one device "
                             f"and dtype")
    n_b, p, n_s = alpha_b.shape
    n_ct = p - n_u
    if n_b < 1 or scal_b.shape != (n_b, N_SCAL_MULTI):
        raise ValueError(f"{name}: inconsistent shapes")
    if dev.type == "cuda":
        for t in (*shared, scal_b):
            if not t.is_contiguous():
                raise ValueError(f"{name}: operands must be contiguous")
        for t in members:
            member_stride(t, name)
    return n_b, p, n_s, n_ct


def _known_layout(n_b, gtt, bt, ydy):
    """Where the known blocks live: shared by the members (gtt 3-d) or one
    per member (a leading member axis). Returns (shared operands,
    per-member operands, leading shape, member strides, 0 when shared)."""
    known = (gtt, bt, ydy)
    if gtt.dim() == 3:
        return known, (), (), (0, 0, 0)
    return (), known, (n_b,), tuple(x.stride(0) for x in known)


def _shapes_ok(lead, n_b, p, n_s, n_ct, n_u, gtt, bt, gu_b, bu_b, ydy):
    return (1 <= n_u <= p and gtt.shape == lead + (n_s, n_ct, n_ct)
            and bt.shape == lead + (n_ct, n_s)
            and gu_b.shape == (n_b, n_s, n_u, p)
            and bu_b.shape == (n_b, n_u, n_s) and ydy.shape == lead + (n_s,))


def alpha_phase_full_multi(gtt, bt, gu_b, bu_b, usq_b, ydy, alpha_b,
                           alpha_prev_b, scal_b, n_steps: int, n_u: int,
                           row_mask_b=None):
    """One launch (K5): ``alpha_phase_full`` for each active member.

    gtt, bt, ydy are the known blocks, shared by the members, or one per
    member (B, n_s, n_ct, n_ct), (B, n_ct, n_s), (B, n_s); gu_b
    (B, n_s, n_u, p), bu_b (B, n_u, n_s), usq_b (B,) come from K4 (views
    of its output rows are taken as they are); alpha_b, alpha_prev_b
    (B, p, n_s) and scal_b (B, N_SCAL_MULTI) are updated in place for the
    active members (A_ALPHA, L_H_PREV advanced; L_W, COST, ACTIVE
    written; RT_SQ, DMAX2, TOL read). ``row_mask_b`` (B, p): each
    member's row mask, as ``alpha_phase_full``'s. Returns nothing.
    """
    name = "alpha_phase_full_multi"
    shared, own, lead, (st_gtt, st_bt, st_ydy) = _known_layout(
        alpha_b.shape[0], gtt, bt, ydy)
    n_b, p, n_s, n_ct = _check_multi(
        name, alpha_b, n_u, shared,
        (*own, gu_b, bu_b, usq_b, alpha_b, alpha_prev_b), scal_b)
    if (not _shapes_ok(lead, n_b, p, n_s, n_ct, n_u, gtt, bt, gu_b, bu_b,
                       ydy)
            or usq_b.shape != (n_b,) or alpha_prev_b.shape != alpha_b.shape
            or alpha_prev_b.stride(0) != alpha_b.stride(0)):
        raise ValueError(f"{name}: inconsistent shapes")
    mask = _mask_arg(row_mask_b, alpha_b, (n_b, p), name)
    if alpha_b.device.type == "cpu":
        alpha_phase_full_multi_plain(gtt, bt, gu_b, bu_b, usq_b, ydy,
                                     alpha_b, alpha_prev_b, scal_b, n_steps,
                                     n_u, mask)
        return
    if alpha_b.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {alpha_b.device}")
    lib = _build.load().lib
    fn = (lib.dm_alpha_phase_full_multi_f32
          if alpha_b.dtype == torch.float32
          else lib.dm_alpha_phase_full_multi_f64)
    with torch.cuda.device(alpha_b.device):
        colsum, tickets, bucket, cols, work, plan = _column_args(
            "alpha", alpha_b, n_b, p, n_s)
        err = fn(gtt.data_ptr(), st_gtt, bt.data_ptr(), st_bt,
                 gu_b.data_ptr(), gu_b.stride(0), bu_b.data_ptr(),
                 bu_b.stride(0), usq_b.data_ptr(), usq_b.stride(0),
                 ydy.data_ptr(), st_ydy, alpha_b.data_ptr(),
                 alpha_prev_b.data_ptr(), alpha_b.stride(0),
                 scal_b.data_ptr(), N_SCAL_MULTI,
                 _ptr(mask), p,                   # the mask's row stride
                 colsum, tickets, _ptr(work), n_s, n_ct, n_u, n_steps,
                 bucket, cols, n_b, _stream(alpha_b))
    _build.check(err, name, _column_case(p, n_s, n_b, alpha_b, plan,
                                         n_steps))
    alpha_phase_full_multi.launches += 1
    _count_glue(alpha_phase_full_multi.forms, p, work,
                masked=mask is not None)


alpha_phase_full_multi.launches = 0
alpha_phase_full_multi.forms = {}


def _columns(x_b):
    """(B, r, n_s) -> (r, B n_s), column c = b n_s + s."""
    return x_b.transpose(0, 1).reshape(x_b.shape[1], -1)


def _members(x_c, n_b):
    """(r, B n_s) -> (B, r, n_s), the inverse of ``_columns``."""
    return x_c.reshape(x_c.shape[0], n_b, -1).transpose(0, 1)


def assemble_G_b_multi(gtt, bt, gu_b, bu_b):
    """Per-member full Grams G (B, n_s, p, p) and b (B, p, n_s) from the
    known blocks (shared, or one per member) and the members' K4 blocks."""
    n_b, n_ct = gu_b.shape[0], gtt.shape[-1]
    top = torch.cat([gtt.expand(n_b, -1, -1, -1),
                     gu_b[..., :n_ct].transpose(2, 3)], dim=3)
    return (torch.cat([top, gu_b], dim=2),
            torch.cat([bt.expand(n_b, -1, -1), bu_b], dim=1))


def _finish_members(scal_b, alpha_b, al_b, b_b, grad_b, ydy, n_u,
                    updates):
    """The multi twins' epilogue: per-member cost and l_w; the active
    members' alpha, scalar ``updates`` {slot: (B,) value}, COST and
    ACTIVE written in place."""
    act = scal_b[:, ACTIVE] != 0
    cost = (torch.sum(ydy, dim=-1) - torch.sum(b_b * al_b, dim=(1, 2))
            - torch.sum(al_b * grad_b, dim=(1, 2)))
    updates[L_W] = torch.sum(al_b[:, -n_u:] ** 2, dim=(1, 2)) * scal_b[:,
                                                                       DMAX2]
    still = (torch.abs(cost - scal_b[:, COST]) >= scal_b[:, TOL]).to(
        scal_b.dtype)
    updates[ACTIVE] = still
    updates[COST] = cost
    alpha_b[act] = al_b[act]
    for slot, value in updates.items():
        scal_b[:, slot] = torch.where(act, value, scal_b[:, slot])
    return act


def alpha_phase_full_multi_plain(gtt, bt, gu_b, bu_b, usq_b, ydy, alpha_b,
                                 alpha_prev_b, scal_b, n_steps: int,
                                 n_u: int, row_mask_b=None):
    """The same function as ``alpha_phase_full_multi`` in ordinary tensor
    ops: the members' columns side by side, per-column scalars (and, with
    ``row_mask_b``, per-column masks)."""
    n_b, p, n_s = alpha_b.shape
    G, b = assemble_G_b_multi(gtt, bt, gu_b, bu_b)
    G_c, b_c = G.reshape(n_b * n_s, p, p), _columns(b)
    l_h = (scal_b[:, RT_SQ] + usq_b) * scal_b[:, DMAX2]

    def per_col(v):
        return v.repeat_interleave(n_s)

    mask_c = (None if row_mask_b is None
              else _columns(row_mask_b[:, :, None].expand(-1, -1, n_s) > 0))
    al, ap, a, l_h_prev = fista_alpha_gram(
        _columns(alpha_b), _columns(alpha_prev_b),
        per_col(scal_b[:, A_ALPHA]), per_col(scal_b[:, L_H_PREV]),
        per_col(l_h), G_c, b_c, n_steps, mask_c)
    grad = b_c - torch.einsum("spq,qs->ps", G_c, al)
    act = _finish_members(
        scal_b, alpha_b, _members(al, n_b), b, _members(grad, n_b), ydy,
        n_u, {A_ALPHA: a[::n_s], L_H_PREV: l_h_prev[::n_s]})
    alpha_prev_b[act] = _members(ap, n_b)[act]


def fw_phase_full_multi(gtt, bt, gu_b, bu_b, ydy, alpha_b, purity, scal_b,
                        n_steps: int, n_u: int):
    """One launch (K6): ``fw_phase_full`` for each active member.

    gtt, bt, ydy as for ``alpha_phase_full_multi`` (shared or one per
    member); purity (n_s,) is shared by the members; gu_b, bu_b come from
    K4; alpha_b (B, p, n_s) = [known; unknown] and scal_b
    (B, N_SCAL_MULTI) are updated in place for the active members (L_W,
    COST, ACTIVE written; DMAX2, TOL read). Returns nothing.
    """
    name = "fw_phase_full_multi"
    shared, own, lead, (st_gtt, st_bt, st_ydy) = _known_layout(
        alpha_b.shape[0], gtt, bt, ydy)
    n_b, p, n_s, n_ct = _check_multi(name, alpha_b, n_u, (*shared, purity),
                                     (*own, gu_b, bu_b, alpha_b), scal_b)
    if (not _shapes_ok(lead, n_b, p, n_s, n_ct, n_u, gtt, bt, gu_b, bu_b,
                       ydy)
            or purity.shape != (n_s,)):
        raise ValueError(f"{name}: inconsistent shapes")
    if alpha_b.device.type == "cpu":
        fw_phase_full_multi_plain(gtt, bt, gu_b, bu_b, ydy, alpha_b, purity,
                                  scal_b, n_steps, n_u)
        return
    if alpha_b.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {alpha_b.device}")
    lib = _build.load().lib
    fn = (lib.dm_fw_phase_full_multi_f32 if alpha_b.dtype == torch.float32
          else lib.dm_fw_phase_full_multi_f64)
    with torch.cuda.device(alpha_b.device):
        colsum, tickets, bucket, cols, work, plan = _column_args(
            "fw", alpha_b, n_b, p, n_s)
        err = fn(gtt.data_ptr(), st_gtt, bt.data_ptr(), st_bt,
                 gu_b.data_ptr(), gu_b.stride(0), bu_b.data_ptr(),
                 bu_b.stride(0), ydy.data_ptr(), st_ydy, alpha_b.data_ptr(),
                 alpha_b.stride(0), purity.data_ptr(), scal_b.data_ptr(),
                 N_SCAL_MULTI, colsum, tickets, _ptr(work), n_s, n_ct, n_u,
                 n_steps, bucket, cols, n_b, _stream(alpha_b))
    _build.check(err, name, _column_case(p, n_s, n_b, alpha_b, plan))
    fw_phase_full_multi.launches += 1
    _count_glue(fw_phase_full_multi.forms, p, work)


fw_phase_full_multi.launches = 0
fw_phase_full_multi.forms = {}


def fw_phase_full_multi_plain(gtt, bt, gu_b, bu_b, ydy, alpha_b, purity,
                              scal_b, n_steps: int, n_u: int):
    """The same function as ``fw_phase_full_multi`` in ordinary tensor ops:
    the members' columns side by side."""
    n_b, p, n_s = alpha_b.shape
    n_ct = p - n_u
    G, b = assemble_G_b_multi(gtt, bt, gu_b, bu_b)
    G_c, b_c = G.reshape(n_b * n_s, p, p), _columns(b)
    al = _columns(alpha_b)
    a1, a2 = frank_wolfe_gram(al[:n_ct], al[n_ct:], G_c, b_c,
                              purity.repeat(n_b), n_steps)
    al = torch.cat([a1, a2], dim=0)
    grad = b_c - torch.einsum("spq,qs->ps", G_c, al)
    _finish_members(scal_b, alpha_b, _members(al, n_b), b,
                    _members(grad, n_b), ydy, n_u, {})


# ---------------------------------------------------------------------------
# K9 and K10: the alpha FISTA and Frank-Wolfe loops on an assembled G, b
# ---------------------------------------------------------------------------


def _check_phase(name, G, b, p, like, others):
    """dtype (``like``'s, float32 or float64), device, contiguity on the
    card and shapes of the single-phase glue kernels' operands at p rows
    and n_s = like's columns; G and b are cast to that dtype, as the JAX
    wrappers cast them. Returns (G, b, n_s)."""
    dt, dev = like.dtype, like.device
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"{name} takes float32 or float64, not {dt}")
    G, b = G.to(dt), b.to(dt)
    n_s = like.shape[1]
    for t in (G, b, *others):
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{name}: all operands must share one device "
                             f"and dtype")
    if G.shape != (n_s, p, p) or b.shape != (p, n_s):
        raise ValueError(f"{name}: inconsistent shapes G {tuple(G.shape)}, "
                         f"b {tuple(b.shape)} at p = {p}, n_s = {n_s}")
    if dev.type == "cuda":
        G, b = G.contiguous(), b.contiguous()
        for t in others:
            if not t.is_contiguous():
                raise ValueError(f"{name}: operands must be contiguous")
    elif dev.type != "cpu":
        raise ValueError(f"{name}: unsupported device {dev}")
    return G, b, n_s


def _phase_work(lib, kernel, like, p, n_s):
    """K9's or K10's plan from the library (``lib_phase_plan``) and, in
    the device rows, a work buffer of ``column_work`` elements (else None;
    the caller keeps it alive until the launch is queued)."""
    plan = lib_phase_plan(lib, kernel, like.element_size(), p)
    if plan["form"] != "device_rows":
        return plan, None
    return plan, like.new_empty(
        (column_work(kernel, like.element_size(), p, n_s),))


def _phase_case(p, n_s, like, plan, n_steps):
    """A K9 or K10 launch's shape, dtype and plan, for its error."""
    where = (_where(plan) if plan["form"] in ("column_blocks", "device_rows")
             else plan["form"])
    return f"p = {p}, n_s = {n_s}, {like.dtype}, {n_steps} steps, {where}"


def _count_phase(forms, plan, masked=False):
    """K9's and K10's launch by form (``count_forms``)."""
    count_forms(forms, two_row=plan["form"] == "two_row",
                column_blocks=plan["form"] == "column_blocks",
                device_rows=plan["form"] == "device_rows", masked=masked)


def alpha_phase(G, b, alpha, alpha_prev, a, l_h_prev, l_h, n_steps: int,
                row_mask=None):
    """The whole alpha FISTA inner loop in one launch (K9), the JAX
    package's ``alpha_phase``.

    G (n_s, p, p), b (p, n_s), alpha and alpha_prev (p, n_s), float32 or
    float64; a, l_h_prev, l_h numbers or 0-d tensors on the data's device
    (no host read); ``row_mask`` (p,): the rows not > 0 project to exactly
    0. Returns new (alpha, alpha_prev, a_new, l_h_prev_new), the carry
    convention of ``fista_alpha_gram``, and leaves the inputs as they
    were.
    """
    p = alpha.shape[0]
    G, b, n_s = _check_phase("alpha_phase", G, b, p, alpha,
                             (alpha, alpha_prev))
    if alpha_prev.shape != alpha.shape:
        raise ValueError("alpha_phase: alpha_prev must be alpha's shape")
    mask = _mask_arg(row_mask, alpha, (p,), "alpha_phase")
    scal = phase_scalars(alpha, a, l_h, l_h_prev)
    if alpha.device.type == "cpu":
        return alpha_phase_plain(G, b, alpha, alpha_prev, scal[PH_A],
                                 scal[PH_L_PREV], scal[PH_L], n_steps, mask)
    lib = _build.load().lib
    fn = (lib.dm_alpha_phase_f32 if alpha.dtype == torch.float32
          else lib.dm_alpha_phase_f64)
    al, ap = torch.empty_like(alpha), torch.empty_like(alpha_prev)
    with torch.cuda.device(alpha.device):
        plan, work = _phase_work(lib, "alpha", alpha, p, n_s)
        err = fn(G.data_ptr(), b.data_ptr(), alpha.data_ptr(),
                 alpha_prev.data_ptr(), al.data_ptr(), ap.data_ptr(),
                 scal.data_ptr(), _ptr(mask), _ptr(work), p, n_s, n_steps,
                 _stream(alpha))
    _build.check(err, "alpha_phase", _phase_case(p, n_s, alpha, plan,
                                                 n_steps))
    alpha_phase.launches += 1
    _count_phase(alpha_phase.forms, plan, masked=mask is not None)
    return al, ap, scal[PH_A_OUT], scal[PH_L_PREV_OUT]


alpha_phase.launches = 0
alpha_phase.forms = {}


def alpha_phase_plain(G, b, alpha, alpha_prev, a, l_h_prev, l_h,
                      n_steps: int, row_mask=None):
    """The same function as ``alpha_phase`` in ordinary tensor ops
    (``fista_alpha_gram``); the scalars are 0-d tensors."""
    return fista_alpha_gram(alpha, alpha_prev, a, l_h_prev, l_h, G, b,
                            n_steps, None if row_mask is None
                            else row_mask > 0)


def fw_phase(G, b, alpha1, alpha2, purity, n_steps: int):
    """The whole Frank-Wolfe loop in one launch (K10), the JAX package's
    ``fw_phase``.

    G (n_s, p, p), b (p, n_s) of the stacked R = [known | unknown];
    alpha1 (p1, n_s) and alpha2 (p - p1, n_s), both blocks non-empty;
    purity (n_s,) the known block's mass per column. Returns new
    (alpha1, alpha2) and leaves the inputs as they were.
    """
    if (alpha1.dim() != 2 or alpha2.dim() != 2
            or alpha2.shape[1] != alpha1.shape[1]
            or min(alpha1.shape[0], alpha2.shape[0]) < 1):
        raise ValueError(f"fw_phase: alpha1 and alpha2 must be non-empty "
                         f"(rows, n_s), got {tuple(alpha1.shape)} and "
                         f"{tuple(alpha2.shape)}")
    p1, p = alpha1.shape[0], alpha1.shape[0] + alpha2.shape[0]
    purity = torch.as_tensor(purity).to(device=alpha1.device,
                                        dtype=alpha1.dtype)
    G, b, n_s = _check_phase("fw_phase", G, b, p, alpha1,
                             (alpha1, alpha2, purity))
    if purity.shape != (n_s,):
        raise ValueError("fw_phase: purity must be (n_s,)")
    if alpha1.device.type == "cpu":
        return fw_phase_plain(G, b, alpha1, alpha2, purity, n_steps)
    lib = _build.load().lib
    fn = (lib.dm_fw_phase_f32 if alpha1.dtype == torch.float32
          else lib.dm_fw_phase_f64)
    a1, a2 = torch.empty_like(alpha1), torch.empty_like(alpha2)
    with torch.cuda.device(alpha1.device):
        plan, work = _phase_work(lib, "fw", alpha1, p, n_s)
        err = fn(G.data_ptr(), b.data_ptr(), alpha1.data_ptr(),
                 alpha2.data_ptr(), a1.data_ptr(), a2.data_ptr(),
                 purity.data_ptr(), _ptr(work), p, p1, n_s, n_steps,
                 _stream(alpha1))
    _build.check(err, "fw_phase", _phase_case(p, n_s, alpha1, plan, n_steps))
    fw_phase.launches += 1
    _count_phase(fw_phase.forms, plan)
    return a1, a2


fw_phase.launches = 0
fw_phase.forms = {}


def fw_phase_plain(G, b, alpha1, alpha2, purity, n_steps: int):
    """The same function as ``fw_phase`` in ordinary tensor ops
    (``frank_wolfe_gram``)."""
    return frank_wolfe_gram(alpha1, alpha2, G, b, purity, n_steps)
