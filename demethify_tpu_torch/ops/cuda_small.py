"""K2, K3, K5 and K6, the glue kernels: wrappers, launch counts and plain
twins.

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
design does about it (one thread block per member, one warp per sample
column; the simplex projection, or the Frank-Wolfe block argmin, inside
the warp).

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

Shapes: p <= 32 rows keep a column's Gram rows in the lanes' registers;
above, the kernels' wide form keeps each warp's column in its own slab of
shared memory (``glue_smem``); past one slab they raise, stating the
shape.

``row_mask`` (K2, (p,)) and ``row_mask_b`` (K5, (B, p), one per member)
are the JAX kernels' masks (``pallas_small.py:281-282, 409-410``): before
each projection the rows whose mask is not > 0 are set to -1e30, which
projects them to exactly 0 and the other rows as the smaller vector
would be. ``fused.partial_ref_solve_fused(row_mask=)`` runs K2's; no
solver runs K5's yet.
"""

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
    RT_SQ,
    SMEM_LIMIT,
    TOL,
    count_forms,
    member_stride,
)
from demethify_tpu_torch.ops.fista import fista_alpha_gram
from demethify_tpu_torch.ops.frank_wolfe import frank_wolfe_gram

REG_P = 32     # rows the register form holds, one lane per row (kMaxP)
# the wide form's slabs may take the card's limit less 1 KB for the
# kernels' static shared memory (small_common.cuh, kGlueSmemLimit)
_GLUE_LIMIT = SMEM_LIMIT - 1024


def glue_smem(itemsize: int, p: int, n_s: int):
    """(warps per block, dynamic shared memory in bytes) of the glue
    kernels at p rows and n_s columns: (min(n_s, 32), 0) in the register
    form (p <= 32); in the wide form one slab of p x p + 6 p values per
    warp and as many warps as fit, at most min(n_s, 32) -- the kernels'
    ``dm::glue_warps`` and ``dm_glue_smem``, which ``chip_smoke.py`` holds
    this to. 0 warps when one slab does not fit. A launch may take fewer
    warps where the kernel's registers allow fewer per block
    (``dm::max_block_warps``); its warps then loop over the columns."""
    n_warps = min(n_s, 32)
    if p <= REG_P:
        return n_warps, 0
    slab = itemsize * (p * p + 6 * p)
    n_warps = min(n_warps, _GLUE_LIMIT // slab)
    return n_warps, max(n_warps, 1) * slab


def _check_glue_shape(name, itemsize, p, n_s):
    n_warps, smem = glue_smem(itemsize, p, n_s)
    if n_warps < 1:
        raise NotImplementedError(
            f"{name} at p = {p} rows ({itemsize}-byte values) needs {smem} "
            f"bytes of shared memory for one column, above the "
            f"{_GLUE_LIMIT} a block may use")


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
    if dev.type == "cuda":
        _check_glue_shape(name, alpha.element_size(), p, n_s)
    return p, n_s, n_ct


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


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
        err = fn(gtt.data_ptr(), bt.data_ptr(), gu.data_ptr(),
                 bu.data_ptr(), usq.data_ptr(), ydy.data_ptr(),
                 alpha.data_ptr(), alpha_prev.data_ptr(), scal.data_ptr(),
                 None if mask is None else mask.data_ptr(), n_s, n_ct, n_u,
                 n_steps, _stream(alpha))
    _build.check(err, "alpha_phase_full")
    alpha_phase_full.launches += 1
    count_forms(alpha_phase_full.forms, wide=p > REG_P,
                masked=mask is not None)


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
        err = fn(gtt.data_ptr(), bt.data_ptr(), gu.data_ptr(),
                 bu.data_ptr(), ydy.data_ptr(), alpha.data_ptr(),
                 purity.data_ptr(), scal.data_ptr(), n_s, n_ct, n_u,
                 n_steps, _stream(alpha))
    _build.check(err, "fw_phase_full")
    fw_phase_full.launches += 1
    count_forms(fw_phase_full.forms, wide=p > REG_P)


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
    if dev.type == "cuda":
        _check_glue_shape(name, alpha_b.element_size(), p, n_s)
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
        err = fn(gtt.data_ptr(), st_gtt, bt.data_ptr(), st_bt,
                 gu_b.data_ptr(), gu_b.stride(0), bu_b.data_ptr(),
                 bu_b.stride(0), usq_b.data_ptr(), usq_b.stride(0),
                 ydy.data_ptr(), st_ydy, alpha_b.data_ptr(),
                 alpha_prev_b.data_ptr(), alpha_b.stride(0),
                 scal_b.data_ptr(), N_SCAL_MULTI,
                 None if mask is None else mask.data_ptr(),
                 p,                               # the mask's row stride
                 n_s, n_ct, n_u, n_steps, n_b, _stream(alpha_b))
    _build.check(err, name)
    alpha_phase_full_multi.launches += 1
    count_forms(alpha_phase_full_multi.forms, wide=p > REG_P,
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
        err = fn(gtt.data_ptr(), st_gtt, bt.data_ptr(), st_bt,
                 gu_b.data_ptr(), gu_b.stride(0), bu_b.data_ptr(),
                 bu_b.stride(0), ydy.data_ptr(), st_ydy, alpha_b.data_ptr(),
                 alpha_b.stride(0), purity.data_ptr(), scal_b.data_ptr(),
                 N_SCAL_MULTI, n_s, n_ct, n_u, n_steps, n_b,
                 _stream(alpha_b))
    _build.check(err, name)
    fw_phase_full_multi.launches += 1
    count_forms(fw_phase_full_multi.forms, wide=p > REG_P)


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
