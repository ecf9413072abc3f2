"""K2 and K3, the single-block glue kernels: wrappers, launch counts and
plain twins.

``alpha_phase_full`` (K2) replaces the Pallas kernel
``demethify_tpu/ops/pallas_small.py::_alpha_full_kernel`` (through
``alpha_phase_full``); ``fw_phase_full`` (K3) replaces
``_fw_full_kernel`` (through ``fw_phase_full``). The kernels are
``csrc/alpha_phase_full.cu`` and ``csrc/fw_phase_full.cu``; their source
notes say what bounds them on an H100 (latency: tiny data, n_steps serial
steps) and what the design does about it (one thread block, one warp per
sample column; the simplex projection, or the Frank-Wolfe block argmin,
inside the warp).

On a CUDA tensor a wrapper launches its kernel or raises; only CPU
tensors take the plain PyTorch twins ``alpha_phase_full_plain`` and
``fw_phase_full_plain``. Without a known block (n_ct = 0, the
unsupervised solve) the known operands are empty and never read.
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
from demethify_tpu_torch.ops.frank_wolfe import frank_wolfe_gram

MAX_P = 32     # one lane per row of alpha


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
    if p > MAX_P:
        raise NotImplementedError(
            f"{name} takes p <= {MAX_P} rows, got {p} (ROADMAP port queue "
            f"item 12)")
    return p, n_s, n_ct


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def alpha_phase_full(gtt, bt, gu, bu, usq, ydy, alpha, alpha_prev, scal,
                     n_steps: int, n_u: int):
    """One launch: Gram assembly, the alpha FISTA loop, l_w and the cost.

    gtt (n_s, n_ct, n_ct), bt (n_ct, n_s), ydy (n_s,) are the
    loop-invariant known blocks (gtt (n_s, 0, 0) and bt (0, n_s) when
    there is none); gu (n_s, n_u, p), bu (n_u, n_s), usq
    (0-d) come from K1. alpha, alpha_prev (p, n_s) and the scalar vector
    scal (slots A_ALPHA, L_H_PREV advanced; L_W, COST written; RT_SQ,
    DMAX2 read) are updated in place. Returns nothing.
    """
    p, n_s, n_ct = _check_args(
        "alpha_phase_full",
        (gtt, bt, gu, bu, usq, ydy, alpha, alpha_prev, scal), alpha, n_u,
        gtt, bt, gu, bu, ydy, scal,
        lambda p, n_s: usq.numel() == 1 and alpha_prev.shape == (p, n_s))
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
        err = fn(gtt.data_ptr(), bt.data_ptr(), gu.data_ptr(),
                 bu.data_ptr(), usq.data_ptr(), ydy.data_ptr(),
                 alpha.data_ptr(), alpha_prev.data_ptr(), scal.data_ptr(),
                 n_s, n_ct, n_u, n_steps, _stream(alpha))
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


fw_phase_full.launches = 0


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
