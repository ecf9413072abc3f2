"""K1, the U-phase megakernel: wrapper, launch count and plain twin.

``u_phase_grams`` replaces the Pallas kernel
``demethify_tpu/ops/pallas_kernels.py::_u_phase_grams_kernel`` (through
its packed wrapper ``u_phase_grams_packed``). The kernel is
``csrc/u_phase_grams.cu``; its source note says what bounds it on an H100
(memory traffic: one read of Y, D, Rt, u, u_prev and one write of u,
u_prev per outer iteration) and what the design does about it.

On a CUDA tensor the wrapper launches the kernel or raises; only CPU
tensors take the plain PyTorch twin ``u_phase_grams_plain``, which
computes the same function with ordinary tensor ops.

Device scalars: the solver keeps its scalars in one small vector on the
data's device (slots below), which K1 and K2 read and advance, so an
outer iteration needs no host sync apart from the termination test.
"""

import torch

from demethify_tpu_torch.ops import _build
from demethify_tpu_torch.ops.fista import momentum, nesterov_step

# slots of the solver's device scalar vector `scal`
A_U, L_W, L_W_PREV, A_ALPHA, L_H_PREV, COST, RT_SQ, DMAX2 = range(8)
N_SCAL = 8

MAX_N_U = 4
_SMEM_LIMIT = 232448     # bytes of shared memory a block may opt into (H100)


def _check_args(ydt, rtt, a1_block, a2_block, uut, scal):
    tensors = (ydt, rtt, a1_block, a2_block, uut, scal)
    dev, dt = ydt.device, ydt.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"u_phase_grams takes float32 or float64, not {dt} "
                        f"(bf16 storage is ROADMAP port queue item 9)")
    for t in tensors:
        if t.device != dev or t.dtype != dt:
            raise ValueError("u_phase_grams: all operands must share one "
                             "device and dtype")
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
    if n == 0:
        raise ValueError("u_phase_grams: no CpG sites")
    if n_ct == 0:
        raise NotImplementedError(
            "u_phase_grams without a known block (n_ct = 0, unsupervised "
            "mode) is ROADMAP port queue item 1")
    if not 1 <= n_u <= MAX_N_U:
        raise NotImplementedError(
            f"u_phase_grams takes 1 <= n_u <= {MAX_N_U}, got {n_u} "
            f"(larger n_u is ROADMAP port queue item 1)")
    if n_u * n_u > 3 * n_s:
        raise NotImplementedError(
            f"n_u = {n_u} with n_s = {n_s} needs the kernel's direct form "
            f"(n_u^2 > 3 n_s): ROADMAP port queue item 1")
    return n, n_s, n_ct, n_u


def u_phase_grams(ydt, rtt, a1_block, a2_block, uut, scal, n_steps: int):
    """One outer iteration's U phase: the whole n_steps FISTA loop on U,
    then the new-u Gram blocks.

    ydt (2 n_s, N) = [Y.T; D.T]; rtt (n_ct, N) = Rt.T; a1_block
    (n_ct, n_s) and a2_block (n_u, n_s) are the known and unknown rows of
    alpha; uut (2 n_u, N) = [u.T; u_prev.T]; scal the solver's scalar
    vector (slots A_U, L_W, L_W_PREV read).

    Updates ``uut`` and ``scal[A_U]``, ``scal[L_W_PREV]`` in place (the
    JAX package donates the same buffers) and returns (gu (n_s, n_u, p),
    b_u (n_u, n_s), usq (0-d)) with p = n_ct + n_u,
    gu[s, u, q] = sum_i u_iu d_is [Rt | u]_iq, b_u = u'(d * y),
    usq = sum u^2.
    """
    n, n_s, n_ct, n_u = _check_args(ydt, rtt, a1_block, a2_block, uut, scal)
    if ydt.device.type == "cpu":
        return u_phase_grams_plain(ydt, rtt, a1_block, a2_block, uut, scal,
                                   n_steps)
    if ydt.device.type != "cuda":
        raise ValueError(f"u_phase_grams: unsupported device {ydt.device}")
    lib = _build.load().lib
    itemsize = ydt.element_size()
    smem = lib.dm_u_phase_grams_smem(itemsize, n_s, n_ct, n_u)
    if smem > _SMEM_LIMIT:
        raise NotImplementedError(
            f"u_phase_grams needs {smem} bytes of shared memory at n_s = "
            f"{n_s}, n_ct = {n_ct}, n_u = {n_u}; wider shapes are ROADMAP "
            f"port queue item 12")
    p = n_ct + n_u
    n_entries = n_s * n_u * p + n_u * n_s + 1
    n_blocks = lib.dm_u_phase_grams_blocks(n)
    partials = torch.empty((n_entries, n_blocks), dtype=ydt.dtype,
                           device=ydt.device)
    out = torch.empty((n_entries,), dtype=ydt.dtype, device=ydt.device)
    fn = (lib.dm_u_phase_grams_f32 if ydt.dtype == torch.float32
          else lib.dm_u_phase_grams_f64)
    with torch.cuda.device(ydt.device):
        stream = torch.cuda.current_stream(ydt.device).cuda_stream
        err = fn(ydt.data_ptr(), rtt.data_ptr(), a1_block.data_ptr(),
                 a2_block.data_ptr(), uut.data_ptr(), scal.data_ptr(),
                 partials.data_ptr(), out.data_ptr(), n, n_s, n_ct, n_u,
                 n_steps, stream)
    _build.check(err, "u_phase_grams")
    u_phase_grams.launches += 1
    gu = out[:n_s * n_u * p].view(n_s, n_u, p)
    b_u = out[n_s * n_u * p:-1].view(n_u, n_s)
    return gu, b_u, out[-1]


u_phase_grams.launches = 0


def u_phase_grams_plain(ydt, rtt, a1_block, a2_block, uut, scal,
                        n_steps: int):
    """The same function as ``u_phase_grams`` in ordinary tensor ops (the
    kernel's twin: the CPU path, and what the kernel is checked against
    on the card)."""
    n_u, n_s = a2_block.shape
    yt, dt = ydt[:n_s], ydt[n_s:]
    dy = dt * yt
    dresid = dy - dt * (a1_block.T @ rtt)                     # (n_s, N)
    C = a2_block @ dresid                                      # (n_u, N)
    w2 = (a2_block[:, None, :] * a2_block[None, :, :]).reshape(n_u * n_u,
                                                               n_s)
    M = (w2 @ dt).reshape(n_u, n_u, -1)
    u, u_prev = uut[:n_u].clone(), uut[n_u:].clone()
    a, l_w, l_prev = (scal[k].clone() for k in (A_U, L_W, L_W_PREV))
    for _ in range(n_steps):
        a1 = nesterov_step(a)
        beta = momentum(a, a1, l_prev, l_w)
        u_t = u + beta * (u - u_prev)
        grad = C - torch.einsum("uvn,vn->un", M, u_t)
        u, u_prev = torch.clamp(u_t + grad / l_w, 0.0, 1.0), u
        a, l_prev = a1, l_w
    rext = torch.cat([rtt, u], dim=0)
    gu = torch.einsum("sn,un,qn->suq", dt, u, rext)
    b_u = u @ dy.T
    usq = torch.sum(u * u)
    uut[:n_u] = u
    uut[n_u:] = u_prev
    scal[A_U] = a
    scal[L_W_PREV] = l_prev
    return gu, b_u, usq
