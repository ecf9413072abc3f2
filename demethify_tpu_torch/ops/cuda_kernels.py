"""K1, the U-phase megakernel: wrapper, launch count and plain twin.

``u_phase_grams`` replaces the Pallas kernel
``demethify_tpu/ops/pallas_kernels.py::_u_phase_grams_kernel`` (through
its wrappers ``u_phase_grams_packed`` and ``u_phase_grams``). The kernel
is ``csrc/u_phase_grams.cu``; its source note says what bounds it on an
H100 (memory traffic: one read of Y, D, Rt, u, u_prev and one write of u,
u_prev per outer iteration) and what the design does about it.

Forms, as the JAX kernel has them: with or without a known block (the
unsupervised solve has none), the gradient at u_t or, ``lagged``, at the
old u (the reference's unsupervised quirk), and the gram or the direct
dataflow, chosen by ``gram_form`` (the JAX kernel's rule).

Dtypes: the data operands ``ydt`` and ``rtt`` are float32, float64 or
bfloat16 (storage); the state operands (``a1_block``, ``a2_block``,
``uut``, ``scal``) are float32 or float64, the same as the data except
that bfloat16 data goes with a float32 state (the JAX kernel's bf16
storage: the data converted once at load, float32 arithmetic from there
on). ``bf16_compute`` (bf16 data only, gram form) rounds the products the
JAX kernel's ``bf16_compute`` branch forms in bf16
(``pallas_kernels.py:263-334, 464-479``): d y, d rt, the alpha operands
a2, a2 a1 and a2 a2 of the C and M sums, and u and d u in the Gram sums;
every sum stays float32. With float32 data the flag does nothing, as in
the JAX kernel.

On a CUDA tensor the wrapper launches the kernel or raises; only CPU
tensors take the plain PyTorch twin ``u_phase_grams_plain``, which
computes the same function with ordinary tensor ops.

Device scalars: the solver keeps its scalars in one small vector on the
data's device (slots below), which the kernels read and advance, so an
outer iteration needs no host sync apart from the termination test. The
multi-member solves keep one row of N_SCAL_MULTI slots per restart
member: the same slots plus the member's tolerance TOL and its ACTIVE
flag (``csrc/small_common.cuh`` names the same slots).
"""

import torch

from demethify_tpu_torch.ops import _build
from demethify_tpu_torch.ops.fista import momentum, nesterov_step

# slots of the solver's device scalar vector `scal`
A_U, L_W, L_W_PREV, A_ALPHA, L_H_PREV, COST, RT_SQ, DMAX2, TOL, ACTIVE = (
    range(10))
N_SCAL = 8
N_SCAL_MULTI = 10

MAX_N_U = 8
SITES_PER_BLOCK = 128    # K1's and K4's sites per block (u_phase_common.cuh)
_SMEM_LIMIT = 232448     # bytes of shared memory a block may opt into (H100)


def gram_form(n_u: int, n_s: int) -> bool:
    """The JAX kernel's choice of dataflow (``pallas_kernels.py:298``):
    the gram form keeps n_u^2 curvature terms per site, the direct form
    redoes two small products over the n_s samples each step."""
    return n_u * n_u <= 3 * n_s


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
    if n == 0:
        raise ValueError("u_phase_grams: no CpG sites")
    if not 1 <= n_u <= MAX_N_U:
        raise NotImplementedError(
            f"u_phase_grams takes 1 <= n_u <= {MAX_N_U}, got {n_u} (larger "
            f"n_u is ROADMAP port queue item 12)")
    return n, n_s, n_ct, n_u


def gram_entries(n_s: int, n_ct: int, n_u: int) -> int:
    """Gram entries per member: gu (n_s, n_u, p), b_u (n_u, n_s), usq."""
    return n_s * n_u * (n_ct + n_u) + n_u * n_s + 1


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
    """None for the known block means none (n_ct = 0): empty operands,
    rtt in the data's dtype, a1 of the empty ``a1_shape`` in the dtype of
    the ``state`` tensor."""
    if rtt is None:
        rtt = ydt.new_empty((0, ydt.shape[1]))
    if a1_block is None:
        a1_block = state.new_empty(a1_shape)
    return rtt, a1_block


def bf16_round(x):
    """x rounded to bfloat16 (to nearest, ties to even) and back to x's
    dtype: the twins' form of the kernels' ``__float2bfloat16_rn``."""
    return x.to(torch.bfloat16).to(x.dtype)


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
    the module docstring; on the card it has the gram form only.

    Updates ``uut`` and ``scal[A_U]``, ``scal[L_W_PREV]`` in place (the
    JAX package donates the same buffers) and returns (gu (n_s, n_u, p),
    b_u (n_u, n_s), usq (0-d)) with p = n_ct + n_u,
    gu[s, u, q] = sum_i u_iu d_is [Rt | u]_iq, b_u = u'(d * y),
    usq = sum u^2.
    """
    rtt, a1_block = known_block(ydt, rtt, a1_block, (0, a2_block.shape[1]),
                                uut)
    n, n_s, n_ct, n_u = _check_args(ydt, rtt, a1_block, a2_block, uut, scal)
    bf16c = bf16_compute and ydt.dtype == torch.bfloat16
    if ydt.device.type == "cpu":
        return u_phase_grams_plain(ydt, rtt, a1_block, a2_block, uut, scal,
                                   n_steps, lagged, bf16c)
    if ydt.device.type != "cuda":
        raise ValueError(f"u_phase_grams: unsupported device {ydt.device}")
    direct = not gram_form(n_u, n_s)
    if bf16c and direct:
        raise NotImplementedError(
            f"u_phase_grams: bf16_compute has the gram form only on the card "
            f"(n_u^2 <= 3 n_s; here n_u = {n_u}, n_s = {n_s}); the JAX "
            f"kernel's direct-form fallback is ROADMAP port queue item 12")
    lib = _build.load().lib
    smem = lib.dm_u_phase_grams_smem(uut.element_size(), n_s, n_ct, n_u,
                                     int(direct), int(bf16c))
    if smem > _SMEM_LIMIT:
        raise NotImplementedError(
            f"u_phase_grams needs {smem} bytes of shared memory at n_s = "
            f"{n_s}, n_ct = {n_ct}, n_u = {n_u}; wider shapes are ROADMAP "
            f"port queue item 12")
    p = n_ct + n_u
    n_entries = gram_entries(n_s, n_ct, n_u)
    n_blocks = lib.dm_u_phase_grams_blocks(n)
    partials = uut.new_empty((n_entries, n_blocks))
    out = uut.new_empty((n_entries,))
    args = (ydt.data_ptr(), rtt.data_ptr(), a1_block.data_ptr(),
            a2_block.data_ptr(), uut.data_ptr(), scal.data_ptr(),
            partials.data_ptr(), out.data_ptr(), n, n_s, n_ct, n_u, n_steps,
            int(lagged), int(direct))
    with torch.cuda.device(ydt.device):
        stream = torch.cuda.current_stream(ydt.device).cuda_stream
        if ydt.dtype == torch.bfloat16:
            err = lib.dm_u_phase_grams_bf16(*args, int(bf16c), stream)
        elif ydt.dtype == torch.float32:
            err = lib.dm_u_phase_grams_f32(*args, stream)
        else:
            err = lib.dm_u_phase_grams_f64(*args, stream)
    _build.check(err, "u_phase_grams")
    if bf16c:
        u_phase_grams.launches_bf16_compute += 1
    elif ydt.dtype == torch.bfloat16:
        u_phase_grams.launches_bf16 += 1
    else:
        u_phase_grams.launches += 1
    gu = out[:n_s * n_u * p].view(n_s, n_u, p)
    b_u = out[n_s * n_u * p:-1].view(n_u, n_s)
    return gu, b_u, out[-1]


# launches per form: float32/float64 data, bf16 data (float32 state), and
# bf16 data with bf16_compute
u_phase_grams.launches = 0
u_phase_grams.launches_bf16 = 0
u_phase_grams.launches_bf16_compute = 0


def u_phase_grams_plain(ydt, rtt, a1_block, a2_block, uut, scal,
                        n_steps: int, lagged: bool = False,
                        bf16_compute: bool = False):
    """The same function as ``u_phase_grams`` in ordinary tensor ops (the
    kernel's twin: the CPU path, and what the kernel is checked against
    on the card), in the same gram or direct dataflow. bf16 data are
    upcast to the state dtype; ``bf16_compute`` (bf16 data only) rounds
    through ``bf16_round`` at the kernel's points, and in the direct form
    only d y, as the JAX kernel's direct-form fallback does."""
    rtt, a1_block = known_block(ydt, rtt, a1_block, (0, a2_block.shape[1]),
                                uut)
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
