"""K2, the alpha glue kernel: wrapper, launch count and plain twin.

``alpha_phase_full`` replaces the Pallas kernel
``demethify_tpu/ops/pallas_small.py::_alpha_full_kernel`` (through
``alpha_phase_full``). The kernel is ``csrc/alpha_phase_full.cu``; its
source note says what bounds it on an H100 (latency: tiny data, n_steps
serial steps) and what the design does about it (one thread block, one
warp per sample column, the simplex projection inside the warp).

On a CUDA tensor the wrapper launches the kernel or raises; only CPU
tensors take the plain PyTorch twin ``alpha_phase_full_plain``.
``row_mask`` (the model-selection sweep) is ROADMAP port queue item 6.
"""

import torch

from demethify_tpu_torch.ops import _build
from demethify_tpu_torch.ops.cuda_kernels import (
    A_ALPHA,
    COST,
    DMAX2,
    L_H_PREV,
    L_W,
    N_SCAL,
    RT_SQ,
)
from demethify_tpu_torch.ops.fista import fista_alpha_gram

MAX_P = 32     # one lane per row of alpha


def _check_args(gtt, bt, gu, bu, usq, ydy, alpha, alpha_prev, scal, n_u):
    tensors = (gtt, bt, gu, bu, usq, ydy, alpha, alpha_prev, scal)
    dev, dt = alpha.device, alpha.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"alpha_phase_full takes float32 or float64, not "
                        f"{dt}")
    for t in tensors:
        if t.device != dev or t.dtype != dt:
            raise ValueError("alpha_phase_full: all operands must share "
                             "one device and dtype")
        if not t.is_contiguous():
            raise ValueError("alpha_phase_full: operands must be "
                             "contiguous")
    p, n_s = alpha.shape
    n_ct = p - n_u
    if (gtt.shape != (n_s, n_ct, n_ct) or bt.shape != (n_ct, n_s)
            or gu.shape != (n_s, n_u, p) or bu.shape != (n_u, n_s)
            or usq.numel() != 1 or ydy.shape != (n_s,)
            or alpha_prev.shape != (p, n_s) or scal.shape != (N_SCAL,)):
        raise ValueError("alpha_phase_full: inconsistent shapes")
    if n_ct < 1:
        raise NotImplementedError(
            "alpha_phase_full without a known block (n_ct = 0) is ROADMAP "
            "port queue item 1")
    if p > MAX_P:
        raise NotImplementedError(
            f"alpha_phase_full takes p <= {MAX_P} rows, got {p} (ROADMAP "
            f"port queue item 12)")
    return p, n_s, n_ct


def alpha_phase_full(gtt, bt, gu, bu, usq, ydy, alpha, alpha_prev, scal,
                     n_steps: int, n_u: int):
    """One launch: Gram assembly, the alpha FISTA loop, l_w and the cost.

    gtt (n_s, n_ct, n_ct), bt (n_ct, n_s), ydy (n_s,) are the
    loop-invariant known blocks; gu (n_s, n_u, p), bu (n_u, n_s), usq
    (0-d) come from K1. alpha, alpha_prev (p, n_s) and the scalar vector
    scal (slots A_ALPHA, L_H_PREV advanced; L_W, COST written; RT_SQ,
    DMAX2 read) are updated in place. Returns nothing.
    """
    p, n_s, n_ct = _check_args(gtt, bt, gu, bu, usq, ydy, alpha,
                               alpha_prev, scal, n_u)
    if alpha.device.type == "cpu":
        alpha_phase_full_plain(gtt, bt, gu, bu, usq, ydy, alpha, alpha_prev,
                               scal, n_steps, n_u)
        return
    if alpha.device.type != "cuda":
        raise ValueError(f"alpha_phase_full: unsupported device "
                         f"{alpha.device}")
    lib = _build.load().lib
    fn = (lib.dm_alpha_phase_full_f32 if alpha.dtype == torch.float32
          else lib.dm_alpha_phase_full_f64)
    with torch.cuda.device(alpha.device):
        stream = torch.cuda.current_stream(alpha.device).cuda_stream
        err = fn(gtt.data_ptr(), bt.data_ptr(), gu.data_ptr(),
                 bu.data_ptr(), usq.data_ptr(), ydy.data_ptr(),
                 alpha.data_ptr(), alpha_prev.data_ptr(), scal.data_ptr(),
                 n_s, n_ct, n_u, n_steps, stream)
    _build.check(err, "alpha_phase_full")
    alpha_phase_full.launches += 1


alpha_phase_full.launches = 0


def assemble_G_b(gtt, bt, gu, bu):
    """Full per-sample Grams G (n_s, p, p) and b (p, n_s) from the known
    blocks and K1's new-u blocks (``_assemble_G_b`` of the JAX package)."""
    n_ct = gtt.shape[1]
    top = torch.cat([gtt, gu[:, :, :n_ct].transpose(1, 2)], dim=2)
    return torch.cat([top, gu], dim=1), torch.cat([bt, bu], dim=0)


def alpha_phase_full_plain(gtt, bt, gu, bu, usq, ydy, alpha, alpha_prev,
                           scal, n_steps: int, n_u: int):
    """The same function as ``alpha_phase_full`` in ordinary tensor ops."""
    G, b = assemble_G_b(gtt, bt, gu, bu)
    l_h = (scal[RT_SQ] + usq.reshape(())) * scal[DMAX2]
    al, ap, a, l_h_prev = fista_alpha_gram(
        alpha.clone(), alpha_prev.clone(), scal[A_ALPHA].clone(),
        scal[L_H_PREV].clone(), l_h, G, b, n_steps)
    grad = b - torch.einsum("spq,qs->ps", G, al)
    cost = torch.sum(ydy) - torch.sum(b * al) - torch.sum(al * grad)
    alpha.copy_(al)
    alpha_prev.copy_(ap)
    scal[A_ALPHA] = a
    scal[L_H_PREV] = l_h_prev
    scal[L_W] = torch.sum(al[-n_u:] ** 2) * scal[DMAX2]
    scal[COST] = cost
