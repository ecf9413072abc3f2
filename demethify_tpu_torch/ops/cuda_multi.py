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

On a CUDA tensor the wrapper launches the kernel or raises; only CPU
tensors take the plain PyTorch twin ``u_phase_grams_multi_plain``, the
same function with the member axis written out as a batch dimension.
"""

import torch

from demethify_tpu_torch.ops import _build, cuda_kernels
from demethify_tpu_torch.ops.cuda_kernels import (
    A_U,
    ACTIVE,
    L_W,
    L_W_PREV,
    N_SCAL_MULTI,
    REG_N_U,
    check_dtypes,
    count_forms,
    gram_entries,
    gram_form,
    known_block,
    member_stride,
    scratch_rows,
)
from demethify_tpu_torch.ops.fista import momentum, nesterov_step


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
    layout, _ = cuda_kernels.u_phase_layout(
        "u_phase_grams_multi", uut_b.element_size(), n_s, n_ct, n_u,
        weighted=weights is not None)
    lib = _build.load().lib
    prefix = "dm_u_phase_grams_multi" + ("_wide" if layout == "wide" else "")
    p = n_ct + n_u
    n_entries = gram_entries(n_s, n_ct, n_u)
    n_blocks = lib.dm_u_phase_grams_blocks(n)
    partials = uut_b.new_empty((n_b * n_entries, n_blocks))
    out = uut_b.new_empty((n_b, n_entries))
    rows = scratch_rows(n_u, False)
    scratch = uut_b.new_empty((rows, n)) if rows else None
    fn = getattr(lib, prefix + {torch.float32: "_f32", torch.float64: "_f64",
                                torch.bfloat16: "_bf16"}[ydt.dtype])
    with torch.cuda.device(ydt.device):
        stream = torch.cuda.current_stream(ydt.device).cuda_stream
        err = fn(ydt.data_ptr(), rtt.data_ptr(), a1_b.data_ptr(),
                 a1_b.stride(0), a2_b.data_ptr(), a2_b.stride(0),
                 uut_b.data_ptr(),
                 None if weights is None else weights.data_ptr(),
                 0 if weights is None else weights.stride(0),
                 scal_b.data_ptr(), N_SCAL_MULTI, partials.data_ptr(),
                 out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), n, n_s,
                 n_ct, n_u, n_steps, n_b, int(lagged), stream)
    _build.check(err, "u_phase_grams_multi")
    if ydt.dtype == torch.bfloat16:
        u_phase_grams_multi.launches_bf16 += 1
    else:
        u_phase_grams_multi.launches += 1
    count_forms(u_phase_grams_multi.forms, wide=layout == "wide",
                state_cols=n_u > REG_N_U)
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
