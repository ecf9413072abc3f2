"""The kernel solvers: one pass over the CpG axis per outer iteration.

Counterparts of ``partial_ref_solve_fused``, ``unsupervised_solve_fused``
and ``purity_solve_fused`` of ``demethify_tpu/solvers/fused.py`` (same
arguments and results, minus the TPU knobs ``packed_io`` and ``tile``:
K1 takes Rt folded into the data block too, but the solvers keep it
apart, the JAX solvers' default; ``axis``, a
``parallel/distributed.Axis``, takes the place of ``axis_name``). The
big arrays live transposed, (rows, n_cpg), which is internal to this
module. Each outer
iteration launches K1 (``ops/cuda_kernels.u_phase_grams``: the whole U
FISTA loop plus the new-u Gram blocks) and then one single-block kernel
on the Grams: K2 (``ops/cuda_small.alpha_phase_full``: the alpha FISTA
loop) in the partial-reference and unsupervised solves, K3
(``ops/cuda_small.fw_phase_full``: the Frank-Wolfe loop) in the purity
solve; each also writes l_w and the Gram-identity cost. Loop-invariant
known-block Grams are computed once before the loop.

The solver's scalars stay on the device (``cuda_kernels.N_SCAL`` slots);
the only host read per outer iteration is the cost, for the reference's
termination test ``|cf - cf_prev| >= tol``, made in the working dtype as
the JAX while_loop makes it.

The batched random restarts (``*_solve_fused_multi``, counterparts of the
JAX package's solvers of the same names) run B members on the same data:
each outer iteration launches K4 (``ops/cuda_multi.u_phase_grams_multi``:
one pass over Y, D and Rt for all members) and then K5 or K6
(``ops/cuda_small.alpha_phase_full_multi`` / ``fw_phase_full_multi``:
one thread block per member). Every member keeps its own row of
``N_SCAL_MULTI`` device scalars, its own tolerance and its own ACTIVE
flag. The flags are computed on the device: the solver sets them once
from the starting costs, and K5/K6 set each active member's flag for the
next iteration from |new cost - old cost| >= tol, in the working dtype;
K4 and K5/K6 leave an inactive member untouched. The only host read per
outer iteration is one copy of the (B, N_SCAL_MULTI) scalar rows (costs
and flags), for the trace, the members' iteration counts and the loop's
"any member active" test. No member padding: that is a TPU sublane rule.

bfloat16 storage: y, d and R_trunc may be bf16. The transposed copies
[Y.T; D.T] and Rt.T then stay bf16 (the kernels read them as such), while
u, alpha, the scalars and every sum over the CpG axis are float32. The
set-up sums (starting cost, norms, ydy, known blocks) upcast the data a
chunk of sites at a time, never as a whole. The set-up rounds where the
JAX fused solvers' compiled programs round (XLA forms a product of bf16
values in float32, exactly, unless the program keeps it as a bf16
array): the DMAX2 slot the loop reads is max(D)^2 rounded to bf16, while
the starting l_w and l_h take it in float32 (``_start``); the ydy sums
take d y rounded to bf16 where the JAX solver's expression does
(``_no_known_grams``, ``ops/gram.py``).

With ``row_weights_b`` (B, n_cpg) the multi solvers run the weighted
bootstrap: member b solves its own row-multiplicity problem (one
resample replicate, w_b its row multiplicities) on the shared Y, D and
Rt, as the plain solvers' ``row_weights`` does. K4 folds each member's
weight row into its Gram sums (the U steps stay raw); each member has its
own w-weighted known blocks (K5/K6 read them at a member stride), its own
||Rt||^2 and max coverage over its surviving rows (per-member RT_SQ and
DMAX2 slots), and its own weighted starting cost, tolerance and ACTIVE
flag.

Row-sharded solves (``*_sharded``, the JAX package's shard_map forms):
every rank of ``axis`` calls the solver on its own block of the CpG
rows. Each sum over the CpG axis is summed over the ranks where the JAX
solvers psum: max(D) (a max), the starting cost and norms (summed before
dmax^2 multiplies them), the known blocks, and each outer iteration K1's
or K4's Gram blocks, packed into one all-reduce between K1/K4 and
K2/K3/K5/K6. The alpha phase then runs on every rank on the same bits,
and every rank makes the same host termination test.
"""

import numpy as np
import torch

from demethify_tpu_torch.ops.cuda_kernels import (
    A_ALPHA,
    A_U,
    ACTIVE,
    COST,
    DMAX2,
    L_H_PREV,
    L_W,
    L_W_PREV,
    N_SCAL,
    N_SCAL_MULTI,
    RT_SQ,
    SITES_PER_BLOCK,
    TOL,
    gram_entries,
    state_in_device,
    state_rows,
    u_phase_grams,
)
from demethify_tpu_torch.ops.cuda_multi import u_phase_grams_multi
from demethify_tpu_torch.ops.cuda_small import (
    alpha_phase_full,
    alpha_phase_full_multi,
    fw_phase_full,
    fw_phase_full_multi,
)
from demethify_tpu_torch.ops.gram import (
    accum_dtype,
    coverage_max,
    known_block_grams,
    row_chunks,
    storage_dy,
    weighted_known_grams,
)
from demethify_tpu_torch.parallel.distributed import LOCAL
from demethify_tpu_torch.utils import host_read, nan_debugging


def _data_t(y, d, R_trunc, dtype, axis=LOCAL):
    """ydt (2 n_s, N) = [Y.T; D.T] and rtt (n_ct, N) = Rt.T (None without a
    known block), both in the storage dtype, and max(D) over the ranks of
    ``axis`` in ``dtype``."""
    ydt = torch.cat([y.T, d.T], dim=0).contiguous()
    rtt = None if R_trunc is None else R_trunc.T.contiguous()
    return ydt, rtt, axis.max_(torch.max(ydt[y.shape[1]:]).to(dtype))


def _axis_sums(axis, *xs):
    """xs summed over the ranks of ``axis`` in one collective; a None
    stays None."""
    summed = iter(axis.sums(*(x for x in xs if x is not None)))
    return tuple(None if x is None else next(summed) for x in xs)


def _uut(u, dtype):
    """[u.T; u.T]: u (..., N, n_u) -> (..., 2 n_u, N), contiguous."""
    ut = u.transpose(-1, -2).to(dtype)
    return torch.cat([ut, ut], dim=-2).contiguous()


def _cost_t(ydt, rt_full, alpha, w=None):
    """The weighted cost in the transposed layout; ``w`` (N,) weights each
    site (the weighted bootstrap's row multiplicities)."""
    n_s = alpha.shape[1]
    resid = ydt[:n_s] - alpha.T @ rt_full
    sq = ydt[n_s:] * resid * resid
    return torch.sum(sq if w is None else sq * w)


def _site_chunks(dtype, ydt, *rows):
    """(ydt, *rows) over chunks of sites, ydt upcast to ``dtype`` one chunk
    at a time (the set-up sums without a copy of the whole data under
    16-bit storage, and without (rows, N) temporaries in any dtype). Each
    of ``rows`` is (k, N), (N,) or None."""
    for lo, hi in row_chunks(ydt.shape[1]):
        yield (ydt[:, lo:hi].to(dtype),
               *(None if r is None else r[..., lo:hi] for r in rows))


def _scalars(dtype, device, n=N_SCAL, **slots):
    scal = torch.zeros(n, dtype=dtype, device=device)
    names = {"a_u": A_U, "l_w": L_W, "l_w_prev": L_W_PREV,
             "a_alpha": A_ALPHA, "l_h_prev": L_H_PREV, "cost": COST,
             "rt_sq": RT_SQ, "dmax2": DMAX2}
    for name, value in slots.items():
        scal[names[name]] = value
    return scal


def _start(ydt, rtt, uut, alpha, n_u, dmax, alpha_fista, w=None,
           axis=LOCAL):
    """One member's starting scalars (the same arithmetic in the single-
    and the multi-member solves, so their members start bit-equal):
    Nesterov scalars 1, l_w = l_w_prev = ||alpha_unknown||^2 dmax^2 and
    the cost; with ``alpha_fista`` (not the Frank-Wolfe purity solve)
    also l_h_prev = ||[Rt | u]||^2 dmax^2 and ||Rt||^2. With site weights
    ``w`` (N,) the cost and the norms are w-weighted, as the plain
    solvers' ``row_weights`` makes them (dmax, max(D), is then the
    member's). Under 16-bit storage the starting constants take dmax^2
    in ``dtype``, and the DMAX2 slot the kernels read every iteration
    takes it rounded to the storage dtype, as the JAX fused solvers'
    compiled programs form the two (max(D) ** 2 is a bf16 value carried
    into their loops, fused in float32 into the starting products). The
    three sums are over the ranks of ``axis`` too, and dmax^2 multiplies
    the summed norm, in the JAX sharded solvers' order."""
    dtype = alpha.dtype
    dmax2 = dmax ** 2
    sums = [_start_sums(y_c, r_c, u_c, alpha, alpha_fista, w_c)
            for y_c, r_c, u_c, w_c in _site_chunks(dtype, ydt, rtt,
                                                     uut[:n_u], w)]
    cost, l_h, rt_sq = _axis_sums(axis, *(
        None if x[0] is None else sum(x[1:], x[0]) for x in zip(*sums)))
    l_w0 = torch.sum(alpha[-n_u:] ** 2) * dmax2
    slots = dict(a_u=1.0, l_w=l_w0, l_w_prev=l_w0, cost=cost,
                 dmax2=dmax2.to(ydt.dtype).to(dtype))
    if alpha_fista:
        slots.update(a_alpha=1.0, l_h_prev=l_h * dmax2)
        if rt_sq is not None:
            slots["rt_sq"] = rt_sq
    return slots


def _start_sums(ydt, rtt, ut, alpha, alpha_fista, w):
    """The starting cost, ||[Rt | u]||^2 and ||Rt||^2 (w-weighted given
    site weights ``w``; the norms None without ``alpha_fista``) of the
    sites of ydt (in the state dtype) and rtt (in the storage dtype), all
    in the state dtype."""
    rtf = None if rtt is None else rtt.to(ut.dtype)
    rt0 = ut if rtt is None else torch.cat([rtf, ut], dim=0)
    cost = _cost_t(ydt, rt0, alpha, w)
    if not alpha_fista:
        return cost, None, None
    if w is None:
        l_h = torch.sum(rt0 * rt0)
        rt_sq = None if rtt is None else torch.sum(rtf * rtf)
    else:
        l_h = torch.sum(w * ut * ut)
        rt_sq = None if rtt is None else torch.sum(w * rtf * rtf)
        l_h = l_h if rt_sq is None else rt_sq + l_h
    return cost, l_h, rt_sq


def _known_grams(R_trunc, y, d, axis):
    """The loop-invariant known-block Grams (G_tt, b_t, ydy) summed over
    the ranks of ``axis``, contiguous, in the state dtype."""
    return tuple(x.contiguous() for x in
                 axis.sums(*known_block_grams(R_trunc, d, y)))


def _no_known_grams(ydt, dtype, axis, dy_once=False):
    """Empty known blocks and ydy = sum_i d y y (n_s,) in ``dtype`` for the
    solves without a reference. Under 16-bit storage the JAX single
    solver's ``(dt * yt * yt).astype`` (``fused.py:272``) compiles to d y
    rounded to the storage dtype times y in float32, as the known
    blocks' ydy (``ops/gram.py``); with ``dy_once`` the multi solver's
    ``(dt * yt).astype(dtype) * yt.astype(dtype)`` (``fused.py:988``)
    compiles to the exact float32 product."""
    n_s = ydt.shape[0] // 2
    ydy = torch.zeros(n_s, dtype=dtype, device=ydt.device)
    for lo, hi in row_chunks(ydt.shape[1]):
        dy, dyy = storage_dy(ydt[n_s:, lo:hi], ydt[:n_s, lo:hi], dtype)
        ydy += torch.sum(dy * ydt[:n_s, lo:hi].to(dtype) if dy_once
                         else dyy, dim=1)
    empty = dict(dtype=dtype, device=ydt.device)
    return (torch.empty((n_s, 0, 0), **empty), torch.empty((0, n_s), **empty),
            axis.sum_(ydy).contiguous())


def _outer_loop(one_iteration, scal, n_iter1, tol, tol_relative,
                record_trace, solver, state):
    """Calls ``one_iteration()`` until ``|cf - cf_prev| < tol`` or n_iter1
    calls; reads scal[COST] once per call. With ``--debugnans`` that read
    also carries the finite flag of ``state()`` (u, alpha) and the cost,
    and a non-finite one raises FloatingPointError naming ``solver``.
    Returns (n_iter, trace)."""
    dtype = scal.dtype
    np_dtype = np.float32 if dtype == torch.float32 else np.float64

    def read(k):
        if nan_debugging():
            return np_dtype(host_read(scal[COST], solver, k,
                                      cost=scal[COST], **state())[0])
        return np_dtype(scal[COST].item())

    cf = read(0)
    tol = np_dtype(tol) * cf if tol_relative else np_dtype(tol)
    cf_prev = np_dtype(np.inf)
    costs = []
    while len(costs) < n_iter1 and abs(cf - cf_prev) >= tol:
        one_iteration()
        cf_prev, cf = cf, read(len(costs) + 1)          # the host read
        costs.append(cf)
    trace = torch.full((n_iter1 if record_trace else 0,), float("nan"),
                       dtype=dtype, device=scal.device)
    if record_trace and costs:
        trace[:len(costs)] = torch.as_tensor(np.asarray(costs, np_dtype),
                                             device=scal.device)
    return len(costs), trace


def partial_ref_solve_fused(u, alpha, y, d, R_trunc, n_u: int,
                            n_iter1: int = 10000, n_iter2: int = 20,
                            tol: float = 1e-2, record_trace: bool = False,
                            tol_relative: bool = False,
                            row_mask=None, bf16_compute: bool = False,
                            axis=LOCAL):
    """Same trajectory as ``solvers/partial_ref.partial_ref_solve``.

    u (n_cpg, n_u), alpha (p, n_s), y, d (n_cpg, n_s), R_trunc
    (n_cpg, n_ct), all on one device. ``row_mask`` ((p,) bool, or 0/1)
    goes to K2 every iteration: its rows not kept project to exactly 0,
    so with the other u columns and alpha rows starting at zero the
    padded solve is the lower-rank solve (the JAX solver's ``row_mask``,
    ``solvers/fused.py:124, 224``). ``bf16_compute`` (bf16 storage only;
    a no-op otherwise, as in the JAX solver) runs K1's bf16_compute
    form. ``axis`` (``parallel/distributed.Axis``, the JAX solver's
    ``axis_name``): y, d, R_trunc and u are this rank's block of the CpG
    rows, and every sum over the CpG axis (max(D), the starting cost and
    norms, the known blocks, each iteration's K1 Gram blocks in one
    collective) is summed over the ranks; K2 then runs on every rank on
    the same bits. Returns (u, alpha, info) with info = {'cost': 0-d
    tensor, 'n_iter': int, 'trace': (n_iter1,) NaN-padded cost history
    when record_trace, else empty}.
    """
    dtype = accum_dtype(y)
    alpha = alpha.to(dtype).contiguous().clone()
    ydt, rtt, dmax = _data_t(y, d, R_trunc, dtype, axis)
    uut = _uut(u, dtype)
    G_tt, b_t, ydy = _known_grams(R_trunc, y, d, axis)
    scal = _scalars(dtype, y.device,
                    **_start(ydt, rtt, uut, alpha, n_u, dmax, True,
                             axis=axis))
    alpha_prev = alpha.clone()
    if row_mask is not None:
        row_mask = torch.as_tensor(row_mask).to(device=y.device, dtype=dtype)

    def one_iteration():
        gu, b_u, usq = axis.sums(*u_phase_grams(
            ydt, rtt, alpha[:-n_u], alpha[-n_u:], uut, scal, n_iter2,
            bf16_compute=bf16_compute))
        alpha_phase_full(G_tt, b_t, gu, b_u, usq, ydy, alpha, alpha_prev,
                         scal, n_iter2, n_u, row_mask)

    k, trace = _outer_loop(one_iteration, scal, n_iter1, tol, tol_relative,
                           record_trace, "partial_ref_solve_fused",
                           lambda: dict(u=uut[:n_u], alpha=alpha))
    return uut[:n_u].T.contiguous(), alpha, {
        "cost": scal[COST].clone(), "n_iter": k, "trace": trace}


def unsupervised_solve_fused(u, alpha, y, d, n_u: int, n_iter1: int = 10000,
                             n_iter2: int = 20, tol: float = 1e-2,
                             record_trace: bool = False,
                             tol_relative: bool = False, axis=LOCAL):
    """Same trajectory as ``solvers/unsupervised.unsupervised_solve``
    (R = U, the lagged u-gradient): K1 without a known block, lagged,
    then K2 without a known block (||Rt||^2 = 0). u (n_cpg, n_u), alpha
    (n_u, n_s). ``axis`` as for ``partial_ref_solve_fused``. Returns
    (u, alpha, info) as ``partial_ref_solve_fused``."""
    dtype = accum_dtype(y)
    alpha = alpha.to(dtype).contiguous().clone()
    ydt, _, dmax = _data_t(y, d, None, dtype, axis)
    uut = _uut(u, dtype)
    G_tt, b_t, ydy = _no_known_grams(ydt, dtype, axis)
    scal = _scalars(dtype, y.device,
                    **_start(ydt, None, uut, alpha, n_u, dmax, True,
                             axis=axis))
    alpha_prev = alpha.clone()

    def one_iteration():
        gu, b_u, usq = axis.sums(*u_phase_grams(
            ydt, None, None, alpha, uut, scal, n_iter2, lagged=True))
        alpha_phase_full(G_tt, b_t, gu, b_u, usq, ydy, alpha, alpha_prev,
                         scal, n_iter2, n_u)

    k, trace = _outer_loop(one_iteration, scal, n_iter1, tol, tol_relative,
                           record_trace, "unsupervised_solve_fused",
                           lambda: dict(u=uut[:n_u], alpha=alpha))
    return uut[:n_u].T.contiguous(), alpha, {
        "cost": scal[COST].clone(), "n_iter": k, "trace": trace}


def purity_solve_fused(u, alpha, y, d, R_trunc, purity, n_u: int,
                       n_iter1: int = 100, n_iter2: int = 500,
                       tol: float = 1e-2, record_trace: bool = False,
                       tol_relative: bool = False, axis=LOCAL):
    """Same trajectory as ``solvers/purity.purity_solve``: K1 (n_iter2
    steps, default 500) then K3, the whole Frank-Wolfe loop. purity (n_s,)
    is the flipped known-block mass 1 - p/100. ``axis`` as for
    ``partial_ref_solve_fused``. Returns (u, alpha, info) as
    ``partial_ref_solve_fused``."""
    dtype = accum_dtype(y)
    alpha = alpha.to(dtype).contiguous().clone()
    purity = purity.to(device=y.device, dtype=dtype).contiguous()
    ydt, rtt, dmax = _data_t(y, d, R_trunc, dtype, axis)
    uut = _uut(u, dtype)
    G_tt, b_t, ydy = _known_grams(R_trunc, y, d, axis)
    scal = _scalars(dtype, y.device,
                    **_start(ydt, rtt, uut, alpha, n_u, dmax, False,
                             axis=axis))

    def one_iteration():
        gu, b_u, _ = u_phase_grams(ydt, rtt, alpha[:-n_u], alpha[-n_u:],
                                   uut, scal, n_iter2)
        gu, b_u = axis.sums(gu, b_u)
        fw_phase_full(G_tt, b_t, gu, b_u, ydy, alpha, purity, scal, n_iter2,
                      n_u)

    k, trace = _outer_loop(one_iteration, scal, n_iter1, tol, tol_relative,
                           record_trace, "purity_solve_fused",
                           lambda: dict(u=uut[:n_u], alpha=alpha))
    return uut[:n_u].T.contiguous(), alpha, {
        "cost": scal[COST].clone(), "n_iter": k, "trace": trace}


# ---------------------------------------------------------------------------
# batched random restarts
# ---------------------------------------------------------------------------

def free_device_bytes(device) -> int:
    """Device memory free for new tensors on ``device``: the driver's free
    memory plus the blocks torch's caching allocator holds unused."""
    free, _ = torch.cuda.mem_get_info(device)
    return free + (torch.cuda.memory_reserved(device)
                   - torch.cuda.memory_allocated(device))


def max_multi_members(n_cpg: int, n_s: int, n_ct: int, n_u: int,
                      itemsize: int, data_itemsize: int, free_bytes: int,
                      weighted: bool = False) -> int:
    """Largest restart batch one multi-member solve takes on the card
    (replaces the JAX package's VMEM model of the same name), given the
    device memory ``free_bytes`` free when the restarts start (y, d and
    Rt already on the device; ``free_device_bytes``). ``itemsize`` is the
    state's, ``data_itemsize`` the data's (2 under bf16 storage).

    What grows with B, per member, in bytes (``itemsize``):
      - K4's partial buffer, E ceil(n_cpg / 128) itemsize, with
        E = n_s n_u (n_ct + n_u) + n_u n_s + 1 Gram entries (laid out
        (blocks, B E); behind it each member's momentum table and list
        slot, n_steps + 2 values, which the formula leaves out);
      - the member's u and u_prev rows (2 n_u n_cpg itemsize), its
        stacked starting u and its returned u (2 n_u n_cpg itemsize);
      - ``weighted`` (the bootstrap): its weight row, itemsize n_cpg;
      - shared memory: nothing. K4 stages its members' alpha blocks and
        u rows a group at a time, and ``cuda_multi.k4_member_plan`` caps
        the group by shared memory, never by B; K5/K6 give each member
        its own thread blocks. So neither grows with B.
    What does not: the solver's copies [Y.T; D.T] and Rt.T,
    data_itemsize n_cpg (2 n_s + n_ct) bytes, and where K4's n_u > 8
    state region lives in device memory (``state_in_device``), its
    itemsize 129 ``state_rows(n_s, n_u)`` values a block: ``shared``. The
    members may take half of the free memory less those; the other half
    is room for the
    set-up's transients (the starting costs' residuals and the known
    block's Gram products, each a few (n_s, n_cpg) arrays) and for the
    allocator's rounding. So
        B_max = max(1, (free_bytes // 2 - shared)
                       // (itemsize (E ceil(n_cpg / 128)
                                     + (4 n_u + weighted) n_cpg))).
    Above it the restarts (or bootstrap replicates) run in chunks of
    B_max.
    """
    n_blocks = -(-n_cpg // SITES_PER_BLOCK)
    per_member = itemsize * (gram_entries(n_s, n_ct, n_u) * n_blocks
                             + (4 * n_u + int(weighted)) * n_cpg)
    shared = data_itemsize * n_cpg * (2 * n_s + n_ct)
    if state_in_device(itemsize, n_s, n_u):
        shared += itemsize * n_blocks * (SITES_PER_BLOCK + 1) * state_rows(
            n_s, n_u)
    return max(1, (free_bytes // 2 - shared) // per_member)


def _multi_start(u_b, alpha_b, ydt, rtt, n_u, dmax, dtype, tol,
                 tol_relative, alpha_fista, w_t, axis):
    """The members' [u.T; u_prev.T] rows, alpha stack and scalar rows.

    Each member's starting scalars are the single-member solve's
    (``_start``; with weight rows ``w_t`` (B, N), the member's weighted
    ones, dmax (B,) then per member). Its tolerance is tol, or tol times
    its starting cost when ``tol_relative``, and it starts active when
    |cost - inf| >= tol, both in the working dtype on the host, as
    ``_outer_loop`` tests them (a NaN starting cost makes the member
    inactive from the start). The starting sums are over the ranks of
    ``axis``."""
    alpha_b = alpha_b.to(dtype).contiguous().clone()
    uut_b = _uut(u_b, dtype)
    scal_b = torch.stack([
        _scalars(dtype, ydt.device, n=N_SCAL_MULTI,
                 **_start(ydt, rtt, uut_b[b], alpha_b[b], n_u,
                          dmax if w_t is None else dmax[b], alpha_fista,
                          None if w_t is None else w_t[b], axis))
        for b in range(alpha_b.shape[0])])
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    cf0 = scal_b[:, COST].cpu().numpy().astype(np_dtype)
    tol_b = np_dtype(tol) * cf0 if tol_relative else np.full_like(
        cf0, np_dtype(tol))
    active = np.abs(cf0 - np_dtype(np.inf)) >= tol_b
    scal_b[:, TOL] = torch.as_tensor(tol_b, device=ydt.device)
    scal_b[:, ACTIVE] = torch.as_tensor(active.astype(np_dtype),
                                        device=ydt.device)
    return uut_b, alpha_b, scal_b


def _outer_loop_multi(one_iteration, scal_b, n_iter1, record_trace, solver,
                      state):
    """Calls ``one_iteration()`` while any member is active and fewer than
    n_iter1 calls were made; one host read of scal_b per call. With
    ``--debugnans`` that read also carries the finite flag of ``state()``
    (every member's u and alpha) and the members' costs, and a non-finite
    one raises FloatingPointError naming ``solver``. Returns (n_iter (B,)
    int64, trace (B, n_iter1) NaN-padded or (B, 0))."""
    def read(k):
        if nan_debugging():
            return torch.tensor(host_read(
                scal_b, solver, k, cost=scal_b[:, COST], **state()),
                dtype=scal_b.dtype).reshape(scal_b.shape)
        return scal_b.cpu()

    host = read(0)
    active = host[:, ACTIVE] != 0
    n_iter = torch.zeros(scal_b.shape[0], dtype=torch.int64)
    trace = torch.full((scal_b.shape[0], n_iter1 if record_trace else 0),
                       float("nan"), dtype=scal_b.dtype)
    k = 0
    while k < n_iter1 and bool(active.any()):
        one_iteration()
        host = read(k + 1)                   # the host read: B scalar rows
        n_iter += active
        if record_trace:
            trace[active, k] = host[active, COST]
        active = host[:, ACTIVE] != 0
        k += 1
    return n_iter, trace.to(scal_b.device)


def _multi_result(uut_b, alpha_b, scal_b, n_u, n_iter, trace):
    return uut_b[:, :n_u].transpose(1, 2).contiguous(), alpha_b, {
        "cost": scal_b[:, COST].clone(), "n_iter": n_iter, "trace": trace}


def _multi_data(y, d, R_trunc, dtype, row_weights_b, axis):
    """The multi solvers' shared data and known blocks: ydt, rtt, dmax
    and (G_tt, b_t, ydy), shared by the members; with ``row_weights_b``
    also the members' weight rows w_t (B, N), and then dmax (B,) (the
    max coverage over each member's surviving rows) and the known blocks
    one per member, w-weighted (else w_t is None). dmax and the known
    blocks are over the ranks of ``axis``."""
    ydt, rtt, dmax = _data_t(y, d, R_trunc, dtype, axis)
    if row_weights_b is None:
        known = (_no_known_grams(ydt, dtype, axis, dy_once=True)
                 if R_trunc is None else _known_grams(R_trunc, y, d, axis))
        return ydt, rtt, dmax, known, None
    w_t = row_weights_b.to(device=ydt.device, dtype=dtype).contiguous()
    if w_t.shape != (row_weights_b.shape[0], ydt.shape[1]):
        raise ValueError(f"row_weights_b must be (B, n_cpg), got "
                         f"{tuple(row_weights_b.shape)}")
    dmax = axis.max_(torch.stack([coverage_max(d, w).to(dtype)
                                  for w in w_t]))
    R = y.new_empty((y.shape[0], 0)) if R_trunc is None else R_trunc
    known = tuple(x.contiguous() for x in
                  axis.sums(*weighted_known_grams(R, d, y, w_t)))
    return ydt, rtt, dmax, known, w_t


def partial_ref_solve_fused_multi(u_b, alpha_b, y, d, R_trunc, n_u: int,
                                  n_iter1: int = 10000, n_iter2: int = 20,
                                  tol: float = 1e-2,
                                  record_trace: bool = False,
                                  tol_relative: bool = False,
                                  row_weights_b=None, axis=LOCAL):
    """Batched-restart partial-reference solve: the same per-member
    trajectories as ``partial_ref_solve_fused`` on each member, or, with
    ``row_weights_b`` (B, n_cpg), as the plain
    ``partial_ref_solve(row_weights=row_weights_b[b])`` (the weighted
    bootstrap).

    u_b (B, n_cpg, n_u), alpha_b (B, p, n_s); y, d, R_trunc as for the
    single solve. Returns (u_b, alpha_b, info) with per-member info
    {'cost': (B,), 'n_iter': (B,) int64 on the host, 'trace':
    (B, n_iter1) NaN-padded when record_trace, else (B, 0)}. Gram form
    only (n_u^2 <= 3 n_s), at most ``max_multi_members`` members (the
    caller chunks; ``solvers/api.py`` does). ``axis`` as for
    ``partial_ref_solve_fused`` (u_b and row_weights_b then hold this
    rank's rows; K4's (B, ...) Gram blocks are summed before K5)."""
    dtype = accum_dtype(y)
    ydt, rtt, dmax, (G_tt, b_t, ydy), w_t = _multi_data(
        y, d, R_trunc, dtype, row_weights_b, axis)
    uut_b, alpha_b, scal_b = _multi_start(u_b, alpha_b, ydt, rtt, n_u,
                                          dmax, dtype, tol, tol_relative,
                                          True, w_t, axis)
    alpha_prev_b = alpha_b.clone()

    def one_iteration():
        gu, b_u, usq = axis.sums(*u_phase_grams_multi(
            ydt, rtt, alpha_b[:, :-n_u], alpha_b[:, -n_u:], uut_b, scal_b,
            n_iter2, weights=w_t))
        alpha_phase_full_multi(G_tt, b_t, gu, b_u, usq, ydy, alpha_b,
                               alpha_prev_b, scal_b, n_iter2, n_u)

    n_iter, trace = _outer_loop_multi(
        one_iteration, scal_b, n_iter1, record_trace,
        "partial_ref_solve_fused_multi",
        lambda: dict(u=uut_b[:, :n_u], alpha=alpha_b))
    return _multi_result(uut_b, alpha_b, scal_b, n_u, n_iter, trace)


def unsupervised_solve_fused_multi(u_b, alpha_b, y, d, n_u: int,
                                   n_iter1: int = 10000, n_iter2: int = 20,
                                   tol: float = 1e-2,
                                   record_trace: bool = False,
                                   tol_relative: bool = False,
                                   row_weights_b=None, axis=LOCAL):
    """Batched-restart unsupervised solve (R = U, the lagged u-gradient):
    K4 lagged without a known block, then K5 without one. u_b
    (B, n_cpg, n_u), alpha_b (B, n_u, n_s). ``row_weights_b`` as for
    ``partial_ref_solve_fused_multi`` (each member then follows the plain
    ``unsupervised_solve(row_weights=)``; K4's weighted form without a
    known block). ``axis`` as for ``partial_ref_solve_fused_multi``.
    Returns as ``partial_ref_solve_fused_multi``."""
    dtype = accum_dtype(y)
    ydt, _, dmax, (G_tt, b_t, ydy), w_t = _multi_data(y, d, None, dtype,
                                                      row_weights_b, axis)
    uut_b, alpha_b, scal_b = _multi_start(u_b, alpha_b, ydt, None, n_u,
                                          dmax, dtype, tol, tol_relative,
                                          True, w_t, axis)
    alpha_prev_b = alpha_b.clone()

    def one_iteration():
        gu, b_u, usq = axis.sums(*u_phase_grams_multi(
            ydt, None, None, alpha_b, uut_b, scal_b, n_iter2, lagged=True,
            weights=w_t))
        alpha_phase_full_multi(G_tt, b_t, gu, b_u, usq, ydy, alpha_b,
                               alpha_prev_b, scal_b, n_iter2, n_u)

    n_iter, trace = _outer_loop_multi(
        one_iteration, scal_b, n_iter1, record_trace,
        "unsupervised_solve_fused_multi",
        lambda: dict(u=uut_b[:, :n_u], alpha=alpha_b))
    return _multi_result(uut_b, alpha_b, scal_b, n_u, n_iter, trace)


def purity_solve_fused_multi(u_b, alpha_b, y, d, R_trunc, purity, n_u: int,
                             n_iter1: int = 100, n_iter2: int = 500,
                             tol: float = 1e-2, record_trace: bool = False,
                             tol_relative: bool = False,
                             row_weights_b=None, axis=LOCAL):
    """Batched-restart purity-constrained solve: K4 (n_iter2 steps,
    default 500) then K6, the whole Frank-Wolfe loop of every active
    member. ``row_weights_b`` and ``axis`` as for
    ``partial_ref_solve_fused_multi``. Returns as
    ``partial_ref_solve_fused_multi``."""
    dtype = accum_dtype(y)
    purity = purity.to(device=y.device, dtype=dtype).contiguous()
    ydt, rtt, dmax, (G_tt, b_t, ydy), w_t = _multi_data(
        y, d, R_trunc, dtype, row_weights_b, axis)
    uut_b, alpha_b, scal_b = _multi_start(u_b, alpha_b, ydt, rtt, n_u,
                                          dmax, dtype, tol, tol_relative,
                                          False, w_t, axis)

    def one_iteration():
        gu, b_u, _ = u_phase_grams_multi(
            ydt, rtt, alpha_b[:, :-n_u], alpha_b[:, -n_u:], uut_b, scal_b,
            n_iter2, weights=w_t)
        gu, b_u = axis.sums(gu, b_u)
        fw_phase_full_multi(G_tt, b_t, gu, b_u, ydy, alpha_b, purity, scal_b,
                            n_iter2, n_u)

    n_iter, trace = _outer_loop_multi(
        one_iteration, scal_b, n_iter1, record_trace,
        "purity_solve_fused_multi",
        lambda: dict(u=uut_b[:, :n_u], alpha=alpha_b))
    return _multi_result(uut_b, alpha_b, scal_b, n_u, n_iter, trace)


# ---------------------------------------------------------------------------
# row-sharded solves: each rank runs K1 (or K4) on its own block of the CpG
# rows, the Gram partials are summed over the ranks, and K2/K3 (or K5/K6)
# run on every rank on the same bits (the JAX package's shard_map forms,
# ``demethify_tpu/solvers/fused.py:415-727``)
# ---------------------------------------------------------------------------

def _agree(axis, info):
    """``info`` when every rank of ``axis`` ended with the same cost bits
    and iteration counts, else RuntimeError on every rank at once. Each
    rank makes its own termination test, so ranks that disagree would
    part in the next collective; the all-reduce hands every rank the same
    sums and the replicated kernels are deterministic, so they never
    should."""
    if axis.size == 1:
        return info
    mine = (info["cost"].detach().cpu().numpy().tobytes(),
            np.asarray(info["n_iter"]).tolist())
    ranks = axis.all_gather_object(mine)
    if any(r != mine for r in ranks):
        raise RuntimeError(f"the ranks of a row-sharded solve disagree on "
                           f"the final cost or iteration count: {ranks}")
    return info


def partial_ref_solve_fused_sharded(u, alpha, y, d, R_trunc, n_u: int, axis,
                                    **kw):
    """``partial_ref_solve_fused`` on this rank's block of the CpG rows
    (u, y, d, R_trunc; padded rows zero, with zero u) with its sums over
    the ranks of ``axis``. Every rank of the axis calls it at once with
    the same alpha and arguments. Returns this rank's u block, the
    replicated alpha and info, after checking that the ranks agree."""
    u, alpha, info = partial_ref_solve_fused(u, alpha, y, d, R_trunc, n_u,
                                             axis=axis, **kw)
    return u, alpha, _agree(axis, info)


def unsupervised_solve_fused_sharded(u, alpha, y, d, n_u: int, axis, **kw):
    """Row-sharded ``unsupervised_solve_fused``, as
    ``partial_ref_solve_fused_sharded``."""
    u, alpha, info = unsupervised_solve_fused(u, alpha, y, d, n_u,
                                              axis=axis, **kw)
    return u, alpha, _agree(axis, info)


def purity_solve_fused_sharded(u, alpha, y, d, R_trunc, purity, n_u: int,
                               axis, **kw):
    """Row-sharded ``purity_solve_fused``, as
    ``partial_ref_solve_fused_sharded``."""
    u, alpha, info = purity_solve_fused(u, alpha, y, d, R_trunc, purity, n_u,
                                        axis=axis, **kw)
    return u, alpha, _agree(axis, info)


def partial_ref_solve_fused_multi_sharded(u_b, alpha_b, y, d, R_trunc,
                                          n_u: int, axis, **kw):
    """Row-sharded ``partial_ref_solve_fused_multi``: u_b (B, rows, n_u)
    and ``row_weights_b`` (B, rows) hold this rank's rows. As
    ``partial_ref_solve_fused_sharded``."""
    u_b, alpha_b, info = partial_ref_solve_fused_multi(
        u_b, alpha_b, y, d, R_trunc, n_u, axis=axis, **kw)
    return u_b, alpha_b, _agree(axis, info)


def unsupervised_solve_fused_multi_sharded(u_b, alpha_b, y, d, n_u: int,
                                           axis, **kw):
    """Row-sharded ``unsupervised_solve_fused_multi``, as
    ``partial_ref_solve_fused_multi_sharded``."""
    u_b, alpha_b, info = unsupervised_solve_fused_multi(
        u_b, alpha_b, y, d, n_u, axis=axis, **kw)
    return u_b, alpha_b, _agree(axis, info)


def purity_solve_fused_multi_sharded(u_b, alpha_b, y, d, R_trunc, purity,
                                     n_u: int, axis, **kw):
    """Row-sharded ``purity_solve_fused_multi``, as
    ``partial_ref_solve_fused_multi_sharded``."""
    u_b, alpha_b, info = purity_solve_fused_multi(
        u_b, alpha_b, y, d, R_trunc, purity, n_u, axis=axis, **kw)
    return u_b, alpha_b, _agree(axis, info)
