#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure or tolerance exceeded exits
non-zero and prints no result line):

1. device: torch/CUDA versions and ``nvidia-smi`` name and power limit;
2. build: the kernels from ``demethify_tpu_torch/csrc`` (one nvcc per
   source, in parallel; ctypes), with each kernel's registers and spills;
3. K1 ``u_phase_grams`` against its plain PyTorch twin at 1M sites: the
   main-path shape (10 samples, 5 known + 1 unknown, 20 inner steps) in
   float32 and float64, n_u = 2, a ragged N = 1,000,003; then its other
   forms in float32 and float64: lagged without a known block (the
   unsupervised shape, n_u = 3), the direct form (one sample, n_u = 2),
   n_u = 5, and the purity shape at 500 steps;
4. K2 ``alpha_phase_full`` against its twin at p = 6 and p = 26, and
   without a known block (p = 3);
5. K3 ``fw_phase_full`` against its twin at p = 6 and p = 26, 500
   Frank-Wolfe steps, float32 and float64, with the count of (step,
   column) vertex choices that differ from the twin's at the same iterate;
   then the multi-member kernels of the batched restarts against their
   twins, float32 and float64, with some members inactive (their state
   must come back bit-unchanged) and one active member against the
   single-member kernel on its own inputs (bit for bit?): K4
   ``u_phase_grams_multi`` at 1M sites (5 + 1, B = 16, 20 steps; n_ct = 0,
   n_u = 3, lagged, B = 8; 5 + 1, B = 8, 500 steps), K5
   ``alpha_phase_full_multi`` (B = 16, p = 6 and p = 3 without a known
   block) and K6 ``fw_phase_full_multi`` (B = 8, p = 6, 500 steps, with
   its vertex flips counted); then the weighted bootstrap's forms of the
   same kernels, float32 and float64: K4 with its weights operand
   (resample multiplicities; 5 + 1, B = 32, 20 steps; n_ct = 0, n_u = 3,
   lagged, B = 8; 5 + 1, B = 8, 500 steps), inactive members
   bit-unchanged and all-ones weights bit-identical to unweighted K4; K5
   (B = 32, p = 6; p = 3) and K6 (B = 8, 500 steps) with per-member
   weighted known blocks, and their shared-block form bit-identical to
   per-member copies of the same blocks;
6. solvers: each kernel solver against its plain solver on the card in
   float64 at 200k sites (partial-reference 50 x 20 in float32 too,
   purity 20 x 500, unsupervised 50 x 20: cost trajectories, alpha); the
   three multi-member kernel solvers (B = 4, float64, 200k sites) against
   the plain solver and against the sequential single-member kernel
   solver on each member, and a loose relative tol at which the members
   stop at different iterations; the same three with ``row_weights_b``
   against the plain weighted solver per member (n_iter, cost trace
   rtol 1e-9, alpha, u); ``bootstrap_ci`` on the card against
   ``bootstrap_ci`` on the CPU with the same injected draws and inits
   (20k sites, both layouts, three modes);
7. the paths at full width, each with the launch counters set to 0 just
   before it and read just after: the main path, ``bench.py``'s workload
   (1M x 10, 5 + 1, float32, 1000 x 20, tol = 0) through
   ``solvers.api.partial_reference_deconv``; the purity path (1M x 10,
   5 + 1, purity drawn in [0.3, 0.9], float32, 100 x 500) through
   ``purity_deconv``; the unsupervised path (1M x 10, n_u = 3, float32,
   1000 x 20) through ``unsupervised_deconv``; each beside the plain
   solver; then the batched random restarts through the same entry
   points: partial-reference with 16 restarts, purity and unsupervised
   with 8, beside the sequential loop's figure per restart; then
   bootstrap CIs through ``uncertainty.bootstrap.bootstrap_ci``: the
   weights layout for partial-reference (B = 32, 1000 x 20), purity
   (B = 8, 100 x 500) and unsupervised (n_u = 3, B = 8, 1000 x 20), and
   the resample layout for partial-reference (B = 4, 200 x 20), per
   replicate and outer iteration;
8. the envelope (after phase 5's kernels, and its paths after phase 7's):
   each kernel's shared-memory plan against its source's ``*_smem``
   export; every shape the kernels took before the wide layout plans the
   resident layout unless the wide one fits twice its blocks per SM, and
   the wide layout forced gives the resident one's bits (K1 at the main
   path's shape, K4, float64, bf16, n_u = 12); K1 and K4 (B = 4)
   against their twins at n_s in {64, 128, 256, 500} with 25 + 4 and
   n_s = 256 with 5 + 1, 200k sites, float32, float64 and bf16, each
   timed beside its bound; one K1 launch at 1M x 500, 25 + 4, float64
   with its partial buffer; n_u in {9, 12, 16} in K1 (gram and direct)
   and K4; p in {33, 40, 64} in K2, K3, K5 and K6; K2 and K5 with row
   masks (all-ones bit-identical to none); K1 with Rt folded into the
   data block, bit-identical to the unfolded launch; K1's bf16_compute in
   the direct form against its twin and through
   ``partial_ref_solve_fused(bf16_compute=True)`` card vs CPU; the
   direct-form weights bootstrap card vs CPU (no kernel launches); the
   padded ``partial_ref_solve_fused(row_mask=)`` against the lower-rank
   solve; paths through ``solvers.api`` that run the wide layout
   (1M x 100, 25 + 4, float64; 4 restarts) and p = 37, n_u = 12
   (float64: partial-reference, purity, and both with 4 restarts), each
   after its kernel solver against the plain solver on the same data and
   inits over a short schedule; and the cohort
   path, ``partial_reference_deconv`` at 1M x 100, 25 + 4, float32,
   1000 x 20, with K1's and K2's times at that shape and the plain solver
   over 20 x 20;
9. CLI: a simulated 50,000-site bedmethyl fixture through
   ``demethify_tpu_torch.cli.main`` in all four modes on ``--device cuda``,
   with ``--restart 4`` in the three iterative modes, and with
   ``--confidence 95 8`` under both ``--cimethod`` layouts in all four.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX or of the JAX
package, and checks that the port's sources reach no file of it.
"""

import contextlib
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DEV = "cuda"

# the main path's shape (bench.py's workload)
N_CPG, N_S, N_CT, N_U, N_OUTER, N_INNER = 1_000_000, 10, 5, 1, 1000, 20
# the purity path: the reference's default schedule (100 x 500)
P_OUTER, P_INNER = 100, 500
# the unsupervised path
U_N_U = 3
# smaller solver comparisons, and the CLI fixture
N_TRAJ, N_CLI = 200_000, 50_000

# kernel-vs-twin tolerances on the card. Both sides sum in different
# orders (the kernel: 128-site blocks, then a fixed tree; the twin:
# cuBLAS / PyTorch reductions). float64: 1e-10. float32: u to 5e-5
# absolute (u in [0, 1] after 20 FISTA steps), the Gram blocks to 5e-5 of
# their largest entry (sums over 1M sites).
TOL = {"float64": {"u": 1e-10, "gram": 1e-10, "alpha": 1e-10,
                   "cost": 1e-10},
       "float32": {"u": 5e-5, "gram": 5e-5, "alpha": 5e-5, "cost": 5e-5}}
# (K1 over the purity schedule's 500 steps holds the same bounds: its
# float32 u differs from the twin's by 1.0e-5 there, 1.2e-6 at 20 steps.)
# K3: float64 alpha to 1e-12. In float32 a vertex choice can flip where
# two gradients are within rounding; a flip at step k moves the final
# alpha by at most 2 / n_steps (gamma_k, then damped by the later steps),
# so alpha is held to 1e-5 + 4 * flips / n_steps.
K3_TOL = {"float64": 1e-12, "float32": 1e-5}
# solver trajectories: the Gram-identity cost sum(ydy) - ... cancels about
# three digits at this size (sum(ydy) ~ 3e3 x cost), so in float32 the
# two solvers' costs agree only to ~1e-3 relative; float64 is tight.
TRAJ_TOL = {"float64": {"cost": 1e-9, "alpha": 1e-9},
            "float32": {"cost": 1e-2, "alpha": 2e-3}}
# bf16_compute on the card against the same solver on the CPU (its
# twins): each side rounds u to bf16 after float32 sums taken in its own
# order, so a site whose u lies within rounding of a bf16 step rounds the
# other way (one bf16 step, 2^-8 relative) in its Gram terms. The
# Gram-identity cost cancels about three digits, so those few sites move
# the cost trace by up to 1.05e-2 relative over 50 iterations (measured
# on an NVIDIA H100 80GB HBM3, seed 1; held on two seeds' problems);
# alpha holds the float32 bound.
BF16C_TRAJ_TOL = {"cost": 3e-2, "alpha": 2e-3}
# bf16 storage against the float32 solve from the same init at the JAX
# package's own bf16 test schedule (30 x 5): alpha to 5e-3 (both forms
# read 6.2e-4 and 6.3e-4 at full width on an NVIDIA H100 80GB HBM3; the
# JAX test's own bound is 5e-2), column sums to 1e-3
BF16_SHORT_TOL = {"alpha": 5e-3, "sum": 1e-3}
# a relative tolerance at which the members of the loose-tol comparison
# stop at different iterations (33 to 67 on the 200k problem, 6 members)
LOOSE_TOL = 1e-5
# the full-width runs in float64 (rounding grows along the flat direction
# over 1000 iterations; ~1e6 x eps on this problem)
LONG_TOL64 = {"cost": 1e-9, "alpha": 1e-6}


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def median_ms(fn, reps=7, inner=1, warmup=2):
    """Median device time of ``fn`` in ms from CUDA events over ``reps``
    repetitions of ``inner`` back-to-back calls each."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def queued_ms(fn, inner, reps=7):
    """Median device time in ms of one of ``inner`` back-to-back calls of
    ``fn``, enqueued behind a device sleep of about 10 ms so that the card
    runs them one after another whatever each launch costs the host (for
    kernels shorter than their wrapper's host time, where ``median_ms``
    reads the host)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def timed_ms(fn):
    """(result, device ms) of one call, from CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def counters():
    """(wrapper, its counter, the name the counts go by): one counter per
    kernel form, bf16 data apart from float32/float64. A counter is an
    attribute of the wrapper, or "forms:KEY", the entry KEY of the
    wrapper's ``forms`` dict (the layouts and options of
    ``cuda_kernels.count_forms``; a launch counts there and in its
    attribute)."""
    from demethify_tpu_torch.ops import cuda_kernels, cuda_multi, cuda_small

    k1, k4 = cuda_kernels.u_phase_grams, cuda_multi.u_phase_grams_multi
    k2, k3 = cuda_small.alpha_phase_full, cuda_small.fw_phase_full
    k5, k6 = cuda_small.alpha_phase_full_multi, cuda_small.fw_phase_full_multi
    return ((k1, "forms:wide", "u_phase_grams{wide}"),
            (k1, "forms:state_cols", "u_phase_grams{n_u>8}"),
            (k1, "forms:bf16c_direct", "u_phase_grams{bf16_compute direct}"),
            (k1, "forms:rt_folded", "u_phase_grams{rt folded}"),
            (k4, "forms:wide", "u_phase_grams_multi{wide}"),
            (k4, "forms:state_cols", "u_phase_grams_multi{n_u>8}"),
            (k2, "forms:wide", "alpha_phase_full{p>32}"),
            (k2, "forms:masked", "alpha_phase_full{masked}"),
            (k3, "forms:wide", "fw_phase_full{p>32}"),
            (k5, "forms:wide", "alpha_phase_full_multi{p>32}"),
            (k5, "forms:masked", "alpha_phase_full_multi{masked}"),
            (k6, "forms:wide", "fw_phase_full_multi{p>32}"),
            (k1, "launches", "u_phase_grams"),
            (k1, "launches_bf16", "u_phase_grams[bf16]"),
            (k1, "launches_bf16_compute", "u_phase_grams[bf16_compute]"),
            (cuda_small.alpha_phase_full, "launches", "alpha_phase_full"),
            (cuda_small.fw_phase_full, "launches", "fw_phase_full"),
            (k4, "launches", "u_phase_grams_multi"),
            (k4, "launches_bf16", "u_phase_grams_multi[bf16]"),
            (cuda_small.alpha_phase_full_multi, "launches",
             "alpha_phase_full_multi"),
            (cuda_small.fw_phase_full_multi, "launches",
             "fw_phase_full_multi"))


def reset_counts():
    for fn, attr, _ in counters():
        if attr.startswith("forms:"):
            fn.forms.clear()
        else:
            setattr(fn, attr, 0)


def read_counts():
    return {name: (getattr(fn, "forms", {}).get(attr[6:], 0)
                   if attr.startswith("forms:") else getattr(fn, attr, 0))
            for fn, attr, name in counters()}


def expect_counts(launches, **want):
    """True when the named kernels launched ``want`` times and every
    other kernel not at all."""
    return all(launches[name] == want.get(name, 0) for name in launches)


# ------------------------------------------------------------------ bounds
# The least time the card could take for a kernel's work: the larger of
# its bytes (each input read once, each output written once) over the
# memory rate and its operations over the card's peak rate for their
# type (NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3; 67 TFLOP/s float32
# outside the tensor cores, 67 TFLOP/s float64 on them).
HBM_BYTES_S = 3.35e12
PEAK_FLOP_S = {"float32": 67e12, "float64": 67e12}


def bound(n_bytes, flops, dtype_name):
    """(bound_ms, bound_by) of work of n_bytes and flops."""
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = flops / PEAK_FLOP_S[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def u_phase_work(n, n_s, n_ct, n_u, steps, itemsize, data_itemsize,
                 n_members=1, weighted=False):
    """(bytes, flops) of K1 (one member) or K4 (n_members active members)
    on n sites: Y, D, Rt read once (``data_itemsize`` bytes each, 2 under
    bf16 storage; ``itemsize`` is the state's); each member's
    u, u_prev read and written (and, ``weighted``, its weight row read).
    Operations, the fewest the function needs: per site and member the
    known-block residual (with d y), C and M (each pair product
    a2[u,s] a2[v,s] formed once per launch and member, then one multiply
    by d and one add per site), the FISTA steps, and the Gram sums of the
    new u (d_s u_v formed once per (s, v), then a multiply-add per [Rt|u]
    row; b_u a multiply-add per (v, s) on the d y already formed; sum u^2)
    plus, weighted, the n_u products w u_v. The scalar momentum chain,
    the same for every site, is not counted, nor are the conversions of
    bf16 data (one per value read) or bf16_compute's roundings."""
    p = n_ct + n_u
    pairs = n_u * (n_u + 1) // 2
    n_bytes = n * (data_itemsize * (2 * n_s + n_ct)
                   + itemsize * n_members * (4 * n_u + int(weighted)))
    per_site = (n_s * (2 * n_ct + 3 + 2 * n_u + 2 * pairs)
                + steps * (6 * n_u + 2 * n_u * n_u)
                + 2 * n_s * n_u * p + n_s * n_u + 2 * n_u * n_s + 2 * n_u
                + n_u * int(weighted))
    return n_bytes, (per_site * n + n_s * pairs) * n_members


def glue_work(p, n_s, n_ct, steps, itemsize, n_members=1, fw=False,
              own_known=False):
    """(bytes, flops) of K2/K5 (alpha FISTA) or K3/K6 (Frank-Wolfe, ``fw``)
    for n_members members: the known blocks read once (once per member
    with ``own_known``, the weighted bootstrap's per-member blocks); each
    member's K1/K4 blocks read and its alpha (and alpha_prev) read and
    written; per step and column the p x p product and the projection or
    the block argmin (about 6 p operations)."""
    n_u = p - n_ct
    known = n_s * n_ct * n_ct + n_ct * n_s + n_s
    member = n_s * n_u * p + n_u * n_s + 1 + (2 if fw else 4) * p * n_s
    flops = n_members * n_s * (steps * (2 * p * p + 6 * p) + 4 * p * p)
    return itemsize * (known * (n_members if own_known else 1)
                       + n_members * member), flops


# ---------------------------------------------------------------- phase 1
def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    log(f"[device] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log(card)
    check(card, "nvidia-smi gave no name/power.limit line")
    return card


# ---------------------------------------------------------------- phase 2
def phase_build():
    from demethify_tpu_torch.ops import _build

    lib = _build.load()
    log(f"[build] {lib.path} in {lib.build_seconds:.2f} s")
    name, spills = None, []
    for ln in lib.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            # _ZN<anonymous namespace>NN<kernel>I<template args>EEv...
            m2 = re.search(r"_cu_[0-9a-f]{8}\d+(\w+?_kernel)I(\w+?)EEv",
                           m.group(1))
            name = f"{m2.group(1)}<{m2.group(2)}>" if m2 else m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name and (int(m.group(1)) or int(m.group(2))):
            spills.append(f"{name}: {m.group(0)}")
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            log(f"[build] ptxas: {name}: {m.group(1)} registers")
    for s in spills:
        log(f"[build] ptxas SPILLS: {s}")
    log(f"[build] {len(spills)} kernel(s) spill")


# ---------------------------------------------------------------- phase 3
def _k1_inputs(n, n_s, n_ct, n_u, dtype, seed):
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import (
        A_U, L_W, L_W_PREV, N_SCAL)

    g = torch.Generator(device=DEV).manual_seed(seed)
    p = n_ct + n_u
    rt = torch.rand((n_ct, n), generator=g, device=DEV, dtype=dtype)
    ut_true = torch.rand((n_u, n), generator=g, device=DEV, dtype=dtype)
    e = torch.empty((p, n_s), device=DEV, dtype=dtype).exponential_(
        generator=g)
    alpha = (e / e.sum(0)).contiguous()
    d = torch.poisson(torch.full((n_s, n), 50.0, device=DEV), generator=g)
    d = (d + 1).to(dtype)
    y = (alpha.T @ torch.cat([rt, ut_true]) + 0.01 * torch.randn(
        (n_s, n), generator=g, device=DEV, dtype=dtype)).clamp(0, 1)
    u = torch.rand((n_u, n), generator=g, device=DEV, dtype=dtype)
    uut = torch.cat([u, (u + 0.05 * torch.randn(
        u.shape, generator=g, device=DEV, dtype=dtype)).clamp(0, 1)])
    ydt = torch.cat([y, d]).contiguous()
    l_w = torch.sum(alpha[-n_u:] ** 2) * d.max() ** 2
    scal = torch.zeros(N_SCAL, device=DEV, dtype=dtype)
    scal[A_U], scal[L_W], scal[L_W_PREV] = 2.5, l_w, 0.9 * l_w
    return ydt, rt.contiguous(), alpha, uut.contiguous(), scal


def _k1_case(n, n_u, dtype_name, steps=N_INNER, seed=0, timed=False,
             n_s=N_S, n_ct=N_CT, lagged=False, label="", data=None,
             bf16_compute=False, inner=10, reps=7):
    """K1 against its twin. ``data`` "bfloat16" stores Y, D and Rt in bf16
    (the state stays ``dtype_name``, float32), ``bf16_compute`` runs that
    form's roundings; both are held to the float32 tolerances. ``reps``
    timed repetitions of ``inner`` launches each."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import (
        gram_form, u_phase_grams, u_phase_grams_plain)
    try:
        from demethify_tpu_torch.ops.cuda_kernels import u_phase_layout
    except ImportError:   # a tree from before the wide layout (time_main_path)
        def u_phase_layout(*_):
            return ("resident",)

    dtype = getattr(torch, dtype_name)
    ydt, rtt, alpha, uut, scal = _k1_inputs(n, n_s, n_ct, n_u, dtype, seed)
    if data is not None:
        ydt, rtt = (x.to(getattr(torch, data)) for x in (ydt, rtt))
    a1, a2 = alpha[:-n_u], alpha[-n_u:]
    if n_ct == 0:
        rtt = a1 = None
    form_kw = {"bf16_compute": True} if bf16_compute else {}
    uk, sk = uut.clone(), scal.clone()
    gk, bk, qk = u_phase_grams(ydt, rtt, a1, a2, uk, sk, steps, lagged,
                               **form_kw)
    up, sp = uut.clone(), scal.clone()
    gp, bp, qp = u_phase_grams_plain(ydt, rtt, a1, a2, up, sp, steps, lagged,
                                     **form_kw)
    torch.cuda.synchronize()
    err_u = float((uk - up).abs().max())
    scale = float(gp.abs().max())
    err_g = float((gk - gp).abs().max()) / scale
    err_b = float((bk - bp).abs().max()) / scale
    err_q = abs(float(qk) - float(qp)) / abs(float(qp))
    err_s = float((sk - sp).abs().max() / sp.abs().max())
    tol = TOL[dtype_name]
    form = "gram" if gram_form(n_u, n_s) else "direct"
    layout = u_phase_layout("K1", uut.element_size(), n_s, n_ct, n_u,
                            form == "direct", bf16_compute
                            and data == "bfloat16")[0]
    data_name = str(ydt.dtype).replace("torch.", "")
    res = {"n": n, "n_s": n_s, "n_ct": n_ct, "n_u": n_u, "steps": steps,
           "lagged": lagged, "form": form, "layout": layout,
           "dtype": dtype_name,
           "data": data_name, "bf16_compute": bf16_compute,
           "u_max_abs": err_u, "gu_rel": err_g, "b_u_rel": err_b,
           "usq_rel": err_q, "scal_rel": err_s, "tol_u": tol["u"],
           "tol_gram": tol["gram"]}
    if timed:
        res["ms"] = median_ms(lambda: u_phase_grams(
            ydt, rtt, a1, a2, uk, sk, steps, lagged, **form_kw),
            reps=reps, inner=inner)
        res["plain_ms"] = median_ms(lambda: u_phase_grams_plain(
            ydt, rtt, a1, a2, up, sp, steps, lagged, **form_kw), reps=3,
            inner=1 if reps < 7 else 2, warmup=1)
        n_bytes, flops = u_phase_work(n, n_s, n_ct, n_u, steps,
                                      uut.element_size(), ydt.element_size())
        res["bytes"] = n_bytes
        res["bound_ms"], res["bound_by"] = bound(n_bytes, flops, dtype_name)
    log(f"[K1]{label} N={n} n_s={n_s} n_ct={n_ct} n_u={n_u} {form} form, "
        f"{layout} layout{' lagged' if lagged else ''} {steps} steps "
        f"{dtype_name} state, "
        f"{data_name} data{', bf16_compute' if bf16_compute else ''}: u "
        f"max|diff| {err_u:.3e} (tol {tol['u']:.0e}); gu rel {err_g:.3e}, b_u "
        f"rel {err_b:.3e}, usq rel {err_q:.3e} (tol {tol['gram']:.0e}); "
        f"scalars rel {err_s:.3e}"
        + (f"; kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms "
           f"(median of back-to-back launches, CUDA events); "
           f"{res['bytes'] / 1e6:.1f} MB to move, bound "
           f"{res['bound_ms']:.4f} ms ({res['bound_by']})" if timed
           else ""))
    check(np.isfinite([err_u, err_g, err_b, err_q]).all(), "K1 non-finite")
    check(err_u <= tol["u"], f"K1 u differs from its twin by {err_u}")
    check(max(err_g, err_b, err_q) <= tol["gram"],
          f"K1 Grams differ from the twin by {max(err_g, err_b, err_q)}")
    check(err_s <= tol["gram"], f"K1 scalars differ by {err_s}")
    return res


def phase_k1():
    main = _k1_case(N_CPG, N_U, "float32", timed=True)
    _k1_case(N_CPG, N_U, "float64", timed=True)
    _k1_case(N_CPG, 2, "float32", seed=1)
    _k1_case(N_CPG + 3, N_U, "float32", seed=2)
    for dt in ("float32", "float64"):
        _k1_case(N_CPG, U_N_U, dt, seed=4, n_ct=0, lagged=True,
                 timed=dt == "float32", label="[unsupervised]")
        _k1_case(N_CPG, 2, dt, seed=5, n_s=1, label="[direct]")
        _k1_case(N_CPG, 5, dt, seed=6, label="[n_u=5]")
        _k1_case(N_CPG, N_U, dt, steps=P_INNER, seed=7, timed=True,
                 label="[purity]")
    return main


def phase_k1_bf16():
    """K1's bf16 forms against the twin at the main path's shape: Y, D and
    Rt in bf16 with a float32 state (gram form with and without a known
    block, lagged; the direct form; the purity schedule), and the
    bf16_compute form (gram form only). Returns the main shape's timed
    (storage, bf16_compute) cases."""
    kw = dict(data="bfloat16")
    main = _k1_case(N_CPG, N_U, "float32", timed=True, label="[bf16]", **kw)
    _k1_case(N_CPG, U_N_U, "float32", seed=4, n_ct=0, lagged=True,
             label="[bf16 unsupervised]", **kw)
    _k1_case(N_CPG, 2, "float32", seed=5, n_s=1, label="[bf16 direct]", **kw)
    _k1_case(N_CPG, N_U, "float32", steps=P_INNER, seed=7,
             label="[bf16 purity]", **kw)
    compute = _k1_case(N_CPG, N_U, "float32", timed=True, bf16_compute=True,
                       label="[bf16_compute]", **kw)
    _k1_case(N_CPG, U_N_U, "float32", seed=4, n_ct=0, lagged=True,
             bf16_compute=True, label="[bf16_compute unsupervised]", **kw)
    return main, compute


# ---------------------------------------------------------------- phase 4
def _small_inputs(n_ct, n_u, dtype_name, n, seed, n_s=N_S):
    """Known and new-u Gram blocks of a K1-style problem on the card."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import u_phase_grams_plain
    from demethify_tpu_torch.ops.gram import known_block_grams

    dtype = getattr(torch, dtype_name)
    ydt, rtt, alpha, uut, scal = _k1_inputs(n, n_s, n_ct, n_u, dtype, seed)
    gu, bu, usq = u_phase_grams_plain(ydt, rtt, alpha[:-n_u],
                                      alpha[-n_u:], uut, scal, 3)
    gtt, bt, ydy = (x.contiguous() for x in known_block_grams(
        rtt.T, ydt[n_s:].T, ydt[:n_s].T))
    return (gtt, bt, gu.contiguous(), bu.contiguous(), usq.reshape(1),
            ydy, alpha, ydt, rtt, scal)


def _k2_case(n_ct, dtype_name, timed=False, n=200_000, seed=3, n_u=N_U,
             mask=None, n_s=N_S):
    """K2 against its twin; ``mask`` (p,) its row mask, then also held
    bit-identical to the unmasked launch when all ones."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import (
        A_ALPHA, COST, DMAX2, L_H_PREV, L_W, RT_SQ)
    from demethify_tpu_torch.ops.cuda_small import (
        alpha_phase_full, alpha_phase_full_plain)

    gtt, bt, gu, bu, usq, ydy, alpha, ydt, rtt, scal = _small_inputs(
        n_ct, n_u, dtype_name, n, seed, n_s)
    dmax2 = ydt[n_s:].max() ** 2
    rt_sq = torch.sum(rtt * rtt)
    scal[A_ALPHA], scal[RT_SQ], scal[DMAX2] = 1.8, rt_sq, dmax2
    scal[L_H_PREV] = 1.05 * (rt_sq + usq[0]) * dmax2
    g = torch.Generator(device=DEV).manual_seed(seed + 1)
    e = torch.empty_like(alpha).exponential_(generator=g)
    alpha_prev = (e / e.sum(0)).contiguous()
    args = (gtt, bt, gu, bu, usq, ydy)
    mask_kw = {} if mask is None else {"row_mask": torch.as_tensor(
        mask, device=DEV, dtype=alpha.dtype)}
    ak, apk, sk = alpha.clone(), alpha_prev.clone(), scal.clone()
    alpha_phase_full(*args, ak, apk, sk, N_INNER, n_u, **mask_kw)
    ap_, app, sp = alpha.clone(), alpha_prev.clone(), scal.clone()
    alpha_phase_full_plain(*args, ap_, app, sp, N_INNER, n_u,
                           *mask_kw.values())
    torch.cuda.synchronize()
    masked_zero = ones_same = True
    if mask is not None:
        keep = mask_kw["row_mask"] > 0
        masked_zero = bool((ak[~keep] == 0).all())
        if bool(keep.all()):
            a0, ap0, s0 = alpha.clone(), alpha_prev.clone(), scal.clone()
            alpha_phase_full(*args, a0, ap0, s0, N_INNER, n_u)
            ones_same = (torch.equal(a0, ak) and torch.equal(ap0, apk)
                         and torch.equal(s0, sk))
    err_a = float(torch.maximum((ak - ap_).abs().max(),
                                (apk - app).abs().max()))
    scale = float(ydy.sum())
    err_c = abs(float(sk[COST]) - float(sp[COST])) / scale
    err_w = abs(float(sk[L_W]) - float(sp[L_W])) / abs(float(sp[L_W]))
    err_n = abs(float(sk[A_ALPHA]) - float(sp[A_ALPHA]))
    tol = TOL[dtype_name]
    p = n_ct + n_u
    res = {"p": p, "n_ct": n_ct, "dtype": dtype_name, "alpha_max_abs": err_a,
           "cost_rel_to_sum_ydy": err_c, "l_w_rel": err_w,
           "tol_alpha": tol["alpha"], "tol_cost": tol["cost"]}
    if timed:
        res["ms"] = median_ms(lambda: alpha_phase_full(
            *args, ak, apk, sk, N_INNER, n_u, **mask_kw), inner=20)
        res["plain_ms"] = median_ms(lambda: alpha_phase_full_plain(
            *args, ap_, app, sp, N_INNER, n_u, *mask_kw.values()),
            inner=20)
        res["bound_ms"], res["bound_by"] = bound(
            *glue_work(p, n_s, n_ct, N_INNER, alpha.element_size()),
            dtype_name)
    if mask is not None:
        log(f"[K2] row mask {mask}: masked rows exactly 0: {masked_zero}; "
            f"all-ones mask bit-identical to no mask: {ones_same}")
        check(masked_zero and ones_same, "K2 row mask")
    log(f"[K2] p={p} n_ct={n_ct} n_s={n_s} {dtype_name}: alpha max|diff| "
        f"{err_a:.3e} (tol {tol['alpha']:.0e}); cost diff / sum(ydy) "
        f"{err_c:.3e}, l_w rel {err_w:.3e} (tol {tol['cost']:.0e})"
        + (f"; kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms "
           f"(median of 7 x 20 launches, CUDA events)" if timed else ""))
    check(np.isfinite([err_a, err_c, err_w]).all(), "K2 non-finite")
    check(err_a <= tol["alpha"], f"K2 alpha differs by {err_a}")
    check(max(err_c, err_w) <= tol["cost"], "K2 cost / l_w differ")
    check(err_n <= 1e-12 * max(1.0, float(sp[A_ALPHA])) or
          dtype_name == "float32", "K2 Nesterov scalar differs")
    return res


def phase_k2():
    cases = [_k2_case(N_CT, "float32", timed=True),
             _k2_case(N_CT, "float64", timed=True),
             _k2_case(25, "float32"), _k2_case(25, "float64"),
             _k2_case(0, "float32", n_u=U_N_U, seed=8, timed=True),
             _k2_case(0, "float64", n_u=U_N_U, seed=8)]
    return cases[0]


# ---------------------------------------------------------------- phase 5
def _fw_flips(gtt, bt, gu, bu, ydy, alpha0, purity, scal, n_u, n_steps):
    """Vertex choices of the kernel that differ from the twin's LMO at the
    same iterate, over all (step, column): the kernel's iterate after k
    steps is one launch of k steps from alpha0, and its vertex at step k
    is (alpha_{k+1} - (1 - gamma_k) alpha_k) / gamma_k; the twin's LMO is
    the argmin of its own gradient expression (``frank_wolfe_gram``: the
    same einsum on the same shapes, so the same bits) at that iterate."""
    import torch

    from demethify_tpu_torch.ops.cuda_small import assemble_G_b, fw_phase_full

    traj = [alpha0.clone()]
    for k in range(1, n_steps + 1):
        a = alpha0.clone()
        fw_phase_full(gtt, bt, gu, bu, ydy, a, purity, scal.clone(), k, n_u)
        traj.append(a)
    traj = torch.stack(traj)                          # (n_steps + 1, p, n_s)
    G, b = assemble_G_b(gtt, bt, gu, bu)
    n_ct = alpha0.shape[0] - n_u
    k = torch.arange(n_steps, device=alpha0.device, dtype=alpha0.dtype)
    gamma = (2.0 / (k + 2.0))[:, None, None]
    vert = (traj[1:] - (1.0 - gamma) * traj[:-1]) / gamma
    grad = torch.stack([torch.einsum("spq,qs->ps", G, a) - b
                        for a in traj[:-1]])
    flips = 0
    for lo, hi in ((0, n_ct), (n_ct, alpha0.shape[0])):
        want = torch.argmin(grad[:, lo:hi], dim=1)
        got = torch.argmax(vert[:, lo:hi], dim=1)
        flips += int((want != got).sum())
    return flips


def _k3_case(n_ct, dtype_name, timed=False, n=200_000, seed=9, n_s=N_S):
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import COST, DMAX2, L_W
    from demethify_tpu_torch.ops.cuda_small import (
        fw_phase_full, fw_phase_full_plain)

    gtt, bt, gu, bu, _, ydy, alpha, ydt, _, scal = _small_inputs(
        n_ct, N_U, dtype_name, n, seed, n_s)
    scal[DMAX2] = ydt[n_s:].max() ** 2
    rng = np.random.default_rng(seed)
    purity = torch.as_tensor(rng.uniform(0.3, 0.9, size=n_s),
                             device=DEV, dtype=alpha.dtype)
    args = (gtt, bt, gu, bu, ydy)
    ak, sk = alpha.clone(), scal.clone()
    fw_phase_full(*args, ak, purity, sk, P_INNER, N_U)
    ap_, sp = alpha.clone(), scal.clone()
    fw_phase_full_plain(*args, ap_, purity, sp, P_INNER, N_U)
    torch.cuda.synchronize()
    err_a = float((ak - ap_).abs().max())
    scale = float(ydy.sum())
    err_c = abs(float(sk[COST]) - float(sp[COST])) / scale
    err_w = abs(float(sk[L_W]) - float(sp[L_W])) / abs(float(sp[L_W]))
    err_m = float((ak[:n_ct].sum(0) - purity).abs().max())
    flips = _fw_flips(*args, alpha, purity, scal, N_U, P_INNER)
    tol_a = K3_TOL[dtype_name] + 4.0 * flips / P_INNER
    tol_c = TOL[dtype_name]["cost"]
    p = n_ct + N_U
    res = {"p": p, "dtype": dtype_name, "alpha_max_abs": err_a,
           "cost_rel_to_sum_ydy": err_c, "l_w_rel": err_w,
           "flips": flips, "tol_alpha": tol_a}
    if timed:
        res["ms"] = median_ms(lambda: fw_phase_full(
            *args, ak, purity, sk, P_INNER, N_U), inner=20)
        res["plain_ms"] = median_ms(lambda: fw_phase_full_plain(
            *args, ap_, purity, sp, P_INNER, N_U), reps=3, inner=1,
            warmup=1)
    log(f"[K3] p={p} n_s={n_s} {P_INNER} steps {dtype_name}: alpha "
        f"max|diff| {err_a:.3e} (tol {tol_a:.1e}); vertex choices that "
        f"differ from the twin's at the same iterate: {flips} of "
        f"{2 * P_INNER * n_s}; cost diff / sum(ydy) {err_c:.3e}, l_w rel "
        f"{err_w:.3e} (tol {tol_c:.0e}); known mass - purity {err_m:.2e}"
        + (f"; kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms "
           f"(median of back-to-back launches, CUDA events)" if timed
           else ""))
    check(np.isfinite([err_a, err_c, err_w]).all(), "K3 non-finite")
    check(err_a <= tol_a, f"K3 alpha differs from its twin by {err_a}")
    check(dtype_name == "float32" or flips == 0,
          f"K3 float64 vertex choices differ ({flips})")
    check(max(err_c, err_w) <= tol_c + 4.0 * flips / P_INNER,
          "K3 cost / l_w differ")
    check(err_m <= 10 * K3_TOL[dtype_name] + 1e-6,
          f"K3 known-block mass off the purity by {err_m}")
    return res


def phase_k3():
    cases = [_k3_case(N_CT, "float32", timed=True),
             _k3_case(N_CT, "float64", timed=True),
             _k3_case(25, "float32", timed=True),
             _k3_case(25, "float64")]
    return cases[0]


# ------------------------------------------------------- phases 5b-5d: K4-K6
def _multi_inputs(n, n_s, n_ct, n_u, n_b, dtype, seed, inactive=()):
    """Shared Y, D, Rt of a K1-style problem and B members' alpha stack,
    [u.T; u_prev.T] rows and scalar rows (the members in ``inactive``
    frozen) on the card."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import (
        A_U, ACTIVE, L_W, L_W_PREV, N_SCAL_MULTI)

    ydt, rtt, _, _, _ = _k1_inputs(n, n_s, n_ct, n_u, dtype, seed)
    g = torch.Generator(device=DEV).manual_seed(seed + 1000)
    e = torch.empty((n_b, n_ct + n_u, n_s), device=DEV,
                    dtype=dtype).exponential_(generator=g)
    alpha_b = (e / e.sum(1, keepdim=True)).contiguous()
    u = torch.rand((n_b, n_u, n), generator=g, device=DEV, dtype=dtype)
    u_prev = (u + 0.05 * torch.randn(u.shape, generator=g, device=DEV,
                                     dtype=dtype)).clamp(0, 1)
    uut_b = torch.cat([u, u_prev], dim=1).contiguous()
    l_w = torch.sum(alpha_b[:, -n_u:] ** 2, dim=(1, 2)) * ydt[n_s:].max() ** 2
    scal_b = torch.zeros((n_b, N_SCAL_MULTI), device=DEV, dtype=dtype)
    scal_b[:, A_U] = 1.0 + 2.0 * torch.rand(n_b, generator=g, device=DEV,
                                            dtype=dtype)
    scal_b[:, L_W], scal_b[:, L_W_PREV] = l_w, 0.9 * l_w
    scal_b[:, ACTIVE] = 1.0
    scal_b[list(inactive), ACTIVE] = 0.0
    return ydt, rtt if n_ct else None, alpha_b, uut_b, scal_b


def _k4_case(n_u, dtype_name, n_b, steps, n_ct=N_CT, lagged=False,
             inactive=(), seed=20, timed=False, label="", data=None,
             n=N_CPG, n_s=N_S, quick=False):
    """K4 against its twin; ``data`` "bfloat16" stores Y, D and Rt in bf16
    (state float32, the float32 tolerances); ``quick`` times 3 single
    launches instead of 7 x 3 (and K1 alike)."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import (
        A_U, ACTIVE, L_W_PREV, N_SCAL, SITES_PER_BLOCK, gram_entries,
        u_phase_grams)
    from demethify_tpu_torch.ops.cuda_multi import (
        u_phase_grams_multi, u_phase_grams_multi_plain)

    dtype = getattr(torch, dtype_name)
    ydt, rtt, alpha_b, uut_b, scal_b = _multi_inputs(
        n, n_s, n_ct, n_u, n_b, dtype, seed, inactive)
    if data is not None:
        ydt = ydt.to(getattr(torch, data))
        rtt = None if rtt is None else rtt.to(ydt.dtype)
    a1 = alpha_b[:, :-n_u] if n_ct else None
    a2 = alpha_b[:, -n_u:]
    uk, sk = uut_b.clone(), scal_b.clone()
    gk, bk, qk = u_phase_grams_multi(ydt, rtt, a1, a2, uk, sk, steps, lagged)
    up, sp = uut_b.clone(), scal_b.clone()
    gp, bp, qp = u_phase_grams_multi_plain(ydt, rtt, a1, a2, up, sp, steps,
                                           lagged)
    torch.cuda.synchronize()
    act = [b for b in range(n_b) if b not in inactive]
    ina = list(inactive)
    err_u = float((uk[act] - up[act]).abs().max())
    scale = gp[act].abs().amax(dim=(1, 2, 3))
    err_g = float(((gk[act] - gp[act]).abs().amax(dim=(1, 2, 3))
                   / scale).max())
    err_b = float(((bk[act] - bp[act]).abs().amax(dim=(1, 2))
                   / scale).max())
    err_q = float(((qk[act] - qp[act]).abs() / qp[act].abs()).max())
    err_s = float(((sk[act] - sp[act]).abs()
                   / sp[act].abs().clamp_min(1e-30)).max())
    frozen = (torch.equal(uk[ina], uut_b[ina])
              and torch.equal(sk[ina], scal_b[ina])) if ina else True
    # the first active member against K1 on the same inputs: bit for bit?
    b0 = act[0]
    u1, s1 = uut_b[b0].clone(), scal_b[b0, :N_SCAL].clone()
    g1, b1, q1 = u_phase_grams(ydt, rtt, None if a1 is None else a1[b0],
                               a2[b0], u1, s1, steps, lagged)
    torch.cuda.synchronize()
    same_k1 = (torch.equal(u1, uk[b0]) and torch.equal(g1, gk[b0])
               and torch.equal(b1, bk[b0]) and torch.equal(q1, qk[b0])
               and torch.equal(s1[[A_U, L_W_PREV]], sk[b0, [A_U, L_W_PREV]]))
    tol = TOL[dtype_name]
    res = {"n": n, "n_s": n_s, "n_ct": n_ct, "n_u": n_u, "members": n_b,
           "inactive": ina, "steps": steps, "lagged": lagged,
           "dtype": dtype_name, "u_max_abs": err_u, "gu_rel": err_g,
           "b_u_rel": err_b, "usq_rel": err_q, "scal_rel": err_s,
           "frozen_unchanged": frozen, "member_equals_k1": same_k1}
    if timed:
        s_all = scal_b.clone()
        s_all[:, ACTIVE] = 1.0
        u_all = uut_b.clone()
        reps, inner = (3, 1) if quick else (7, 3)
        res["ms"] = median_ms(lambda: u_phase_grams_multi(
            ydt, rtt, a1, a2, u_all, s_all, steps, lagged), reps=reps,
            inner=inner)
        res["plain_ms"] = median_ms(lambda: u_phase_grams_multi_plain(
            ydt, rtt, a1, a2, up, sp, steps, lagged), reps=3, inner=1,
            warmup=1)
        res["k1_ms"] = median_ms(lambda: u_phase_grams(
            ydt, rtt, None if a1 is None else a1[0], a2[0], u1, s1, steps,
            lagged), reps=reps, inner=1 if quick else 10)
        n_bytes, flops = u_phase_work(n, n_s, n_ct, n_u, steps,
                                      uut_b.element_size(),
                                      ydt.element_size(), n_b)
        res["bytes"] = n_bytes
        res["bound_ms"], res["bound_by"] = bound(n_bytes, flops, dtype_name)
        res["partial_bytes"] = (uut_b.element_size() * n_b
                                * gram_entries(n_s, n_ct, n_u)
                                * -(-n // SITES_PER_BLOCK))
    log(f"[K4]{label} N={n} n_s={n_s} n_ct={n_ct} n_u={n_u} B={n_b} "
        f"(inactive {ina}){' lagged' if lagged else ''} {steps} steps "
        f"{dtype_name} state, {str(ydt.dtype)[6:]} data: active members' "
        f"u/u_prev max|diff| {err_u:.3e} (tol "
        f"{tol['u']:.0e}); gu rel {err_g:.3e}, b_u rel {err_b:.3e}, usq rel "
        f"{err_q:.3e} (tol {tol['gram']:.0e}); scalars rel {err_s:.3e}; "
        f"inactive members bit-unchanged: {frozen}; member {b0} "
        f"bit-identical to K1 on its inputs: {same_k1}"
        + (f"; kernel {res['ms']:.4f} ms (all {n_b} active), plain "
           f"{res['plain_ms']:.4f} ms, K1 alone {res['k1_ms']:.4f} ms x "
           f"{n_b} = {n_b * res['k1_ms']:.4f} ms; {res['bytes'] / 1e6:.1f} "
           f"MB to move, bound {res['bound_ms']:.4f} ms ({res['bound_by']}),"
           f" partial buffer {res['partial_bytes'] / 1e6:.1f} MB"
           if timed else ""))
    check(np.isfinite([err_u, err_g, err_b, err_q]).all(), "K4 non-finite")
    check(err_u <= tol["u"], f"K4 u differs from its twin by {err_u}")
    check(max(err_g, err_b, err_q) <= tol["gram"],
          f"K4 Grams differ from the twin by {max(err_g, err_b, err_q)}")
    check(err_s <= tol["gram"], f"K4 scalars differ by {err_s}")
    check(frozen, "K4 changed an inactive member")
    return res


def phase_k4():
    inactive = (3, 7, 11)
    main = _k4_case(N_U, "float32", 16, N_INNER, inactive=inactive,
                    timed=True, label="[restarts]")
    _k4_case(N_U, "float64", 16, N_INNER, inactive=inactive)
    uns = _k4_case(U_N_U, "float32", 8, N_INNER, n_ct=0, lagged=True,
                   inactive=(5,), seed=21, timed=True,
                   label="[unsupervised]")
    _k4_case(U_N_U, "float64", 8, N_INNER, n_ct=0, lagged=True,
             inactive=(5,), seed=21)
    pur = _k4_case(N_U, "float32", 8, P_INNER, inactive=(2,), seed=22,
                   timed=True, label="[purity]")
    _k4_case(N_U, "float64", 8, P_INNER, inactive=(2,), seed=22)
    return main, uns, pur


def resample_weights(n_b, n, dtype, seed):
    """B members' row multiplicities of a with-replacement resample of n
    rows (the bincount of seeded draws), (B, n) on the card."""
    import torch

    g = torch.Generator(device=DEV).manual_seed(seed)
    return torch.stack([
        torch.bincount(torch.randint(n, (n,), generator=g, device=DEV),
                       minlength=n) for _ in range(n_b)]).to(dtype)


def _glue_multi_inputs(n_ct, n_u, dtype_name, n_b, inactive, seed,
                       weighted=False):
    """Shared known blocks and B members' K4 blocks (from K4's twin) of a
    200k-site problem, alpha stacks and scalar rows on the card; with
    ``weighted``, resample weights per member, each member's own weighted
    known blocks, ||Rt||^2 and surviving-row max coverage (the weighted
    bootstrap's operands)."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import (
        A_ALPHA, COST, DMAX2, L_H_PREV, RT_SQ, TOL)
    from demethify_tpu_torch.ops.cuda_multi import u_phase_grams_multi_plain
    from demethify_tpu_torch.ops.gram import known_block_grams

    dtype = getattr(torch, dtype_name)
    n = 200_000
    ydt, rtt, alpha_b, uut_b, scal_b = _multi_inputs(
        n, N_S, n_ct, n_u, n_b, dtype, seed, inactive)
    # the weights only where they are used, so that the unweighted cases
    # also run on a tree from before the weights operand (time_main_path)
    w = resample_weights(n_b, n, dtype, seed) if weighted else None
    gu, bu, usq = u_phase_grams_multi_plain(
        ydt, rtt, alpha_b[:, :-n_u] if n_ct else None, alpha_b[:, -n_u:],
        uut_b.clone(), scal_b.clone(), 3, **({"weights": w} if weighted
                                              else {}))
    rt = ydt.new_empty((n, 0)) if rtt is None else rtt.T
    if weighted:
        from demethify_tpu_torch.ops.gram import weighted_known_grams

        gtt, bt, ydy = (x.contiguous() for x in weighted_known_grams(
            rt, ydt[N_S:].T, ydt[:N_S].T, w))
        rowmax = ydt[N_S:].max(0).values
        dmax2 = torch.where(w > 0, rowmax, 0.0).max(1).values ** 2
        rt_sq = w @ torch.sum(rt * rt, dim=1)
    else:
        gtt, bt, ydy = (x.contiguous() for x in known_block_grams(
            rt, ydt[N_S:].T, ydt[:N_S].T))
        dmax2 = ydt[N_S:].max() ** 2
        rt_sq = torch.sum(rt * rt)
    g = torch.Generator(device=DEV).manual_seed(seed + 2000)
    scal_b[:, A_ALPHA] = 1.0 + torch.rand(n_b, generator=g, device=DEV,
                                          dtype=dtype)
    scal_b[:, RT_SQ], scal_b[:, DMAX2] = rt_sq, dmax2
    scal_b[:, L_H_PREV] = 1.05 * (rt_sq + usq) * dmax2
    scal_b[:, COST], scal_b[:, TOL] = 0.0, 0.0
    e = torch.empty_like(alpha_b).exponential_(generator=g)
    alpha_prev_b = (e / e.sum(1, keepdim=True)).contiguous()
    return (gtt, bt, gu.contiguous(), bu.contiguous(), usq.contiguous(),
            ydy, alpha_b, alpha_prev_b, scal_b)


def _k5_case(n_ct, n_u, dtype_name, n_b, inactive, seed=30, timed=False,
             mask=None):
    """K5 against its twin; ``mask`` (B, p) the members' row masks, then
    also an all-ones mask held bit-identical to no mask."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import ACTIVE, COST, N_SCAL
    from demethify_tpu_torch.ops.cuda_small import (
        alpha_phase_full, alpha_phase_full_multi,
        alpha_phase_full_multi_plain)

    (gtt, bt, gu, bu, usq, ydy, alpha_b, alpha_prev_b,
     scal_b) = _glue_multi_inputs(n_ct, n_u, dtype_name, n_b, inactive, seed)
    args = (gtt, bt, gu, bu, usq, ydy)
    mk = None if mask is None else torch.as_tensor(mask, device=DEV,
                                                   dtype=alpha_b.dtype)
    # the mask only where it is used, so that the unmasked cases also run
    # on a tree from before the masks (time_main_path)
    mkw = () if mk is None else (mk,)
    ak, apk, sk = alpha_b.clone(), alpha_prev_b.clone(), scal_b.clone()
    alpha_phase_full_multi(*args, ak, apk, sk, N_INNER, n_u, *mkw)
    ap_, app, sp = alpha_b.clone(), alpha_prev_b.clone(), scal_b.clone()
    alpha_phase_full_multi_plain(*args, ap_, app, sp, N_INNER, n_u, *mkw)
    torch.cuda.synchronize()
    if mk is not None:
        keep = mk > 0
        act_rows = [b for b in range(n_b) if b not in inactive]
        masked_zero = all(bool((ak[b][~keep[b]] == 0).all())
                          for b in act_rows)
        a1_, ap1_, s1_ = (alpha_b.clone(), alpha_prev_b.clone(),
                          scal_b.clone())
        alpha_phase_full_multi(*args, a1_, ap1_, s1_, N_INNER, n_u,
                               torch.ones_like(mk))
        a0_, ap0_, s0_ = (alpha_b.clone(), alpha_prev_b.clone(),
                          scal_b.clone())
        alpha_phase_full_multi(*args, a0_, ap0_, s0_, N_INNER, n_u)
        ones_same = (torch.equal(a1_, a0_) and torch.equal(ap1_, ap0_)
                     and torch.equal(s1_, s0_))
        log(f"[K5] row masks: masked rows of the active members exactly 0: "
            f"{masked_zero}; all-ones masks bit-identical to no mask: "
            f"{ones_same}")
        check(masked_zero and ones_same, "K5 row masks")
    act = [b for b in range(n_b) if b not in inactive]
    ina = list(inactive)
    err_a = float(torch.maximum((ak[act] - ap_[act]).abs().max(),
                                (apk[act] - app[act]).abs().max()))
    scale = float(ydy.sum())
    err_c = float((sk[act, COST] - sp[act, COST]).abs().max()) / scale
    err_s = float(((sk[act, :N_SCAL] - sp[act, :N_SCAL]).abs()
                   / sp[act, :N_SCAL].abs().clamp_min(1e-30)).max())
    flags = torch.equal(sk[:, ACTIVE], sp[:, ACTIVE])
    frozen = (torch.equal(ak[ina], alpha_b[ina])
              and torch.equal(apk[ina], alpha_prev_b[ina])
              and torch.equal(sk[ina], scal_b[ina])) if ina else True
    b0 = act[0]
    a1, ap1, s1 = (alpha_b[b0].clone(), alpha_prev_b[b0].clone(),
                   scal_b[b0, :N_SCAL].clone())
    alpha_phase_full(gtt, bt, gu[b0], bu[b0], usq[b0:b0 + 1], ydy, a1, ap1,
                     s1, N_INNER, n_u, *(m[b0] for m in mkw))
    torch.cuda.synchronize()
    same_k2 = (torch.equal(a1, ak[b0]) and torch.equal(ap1, apk[b0])
               and torch.equal(s1, sk[b0, :N_SCAL]))
    p = n_ct + n_u
    tol = TOL[dtype_name]
    res = {"p": p, "n_ct": n_ct, "members": n_b, "inactive": ina,
           "dtype": dtype_name, "alpha_max_abs": err_a,
           "cost_rel_to_sum_ydy": err_c, "scal_rel": err_s,
           "frozen_unchanged": frozen, "member_equals_k2": same_k2}
    if timed:
        s_all = scal_b.clone()
        s_all[:, ACTIVE] = 1.0
        a_all, ap_all = alpha_b.clone(), alpha_prev_b.clone()
        res["ms"] = median_ms(lambda: alpha_phase_full_multi(
            *args, a_all, ap_all, s_all, N_INNER, n_u, *mkw), inner=20)
        res["queued_ms"] = queued_ms(lambda: alpha_phase_full_multi(
            *args, a_all, ap_all, s_all, N_INNER, n_u, *mkw), inner=20)
        res["plain_ms"] = median_ms(lambda: alpha_phase_full_multi_plain(
            *args, ap_, app, sp, N_INNER, n_u, *mkw), inner=5)
        n_bytes, flops = glue_work(p, N_S, n_ct, N_INNER,
                                   alpha_b.element_size(), n_b)
        res["bound_ms"], res["bound_by"] = bound(n_bytes, flops, dtype_name)
    log(f"[K5] B={n_b} (inactive {ina}) p={p} n_ct={n_ct} n_s={N_S} "
        f"{N_INNER} steps {dtype_name}: active alpha/alpha_prev max|diff| "
        f"{err_a:.3e} (tol {tol['alpha']:.0e}); cost diff / sum(ydy) "
        f"{err_c:.3e}, scalars rel {err_s:.3e} (tol {tol['cost']:.0e}); "
        f"active flags equal: {flags}; inactive members bit-unchanged: "
        f"{frozen}; member {b0} bit-identical to K2: {same_k2}"
        + (f"; kernel {res['ms']:.4f} ms (all {n_b} active; "
           f"{res['queued_ms']:.4f} ms queued behind a device sleep), plain "
           f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.6f} ms"
           if timed else ""))
    check(np.isfinite([err_a, err_c, err_s]).all(), "K5 non-finite")
    check(err_a <= tol["alpha"], f"K5 alpha differs by {err_a}")
    check(max(err_c, err_s) <= tol["cost"], "K5 cost / scalars differ")
    check(flags and frozen, "K5 active flags or an inactive member differ")
    return res


def phase_k5():
    main = _k5_case(N_CT, N_U, "float32", 16, (2, 9), timed=True)
    _k5_case(N_CT, N_U, "float64", 16, (2, 9))
    _k5_case(0, U_N_U, "float32", 16, (4,), seed=31)
    _k5_case(0, U_N_U, "float64", 16, (4,), seed=31)
    return main


def _fw_flips_multi(args, alpha0_b, purity, scal_b, n_u, n_steps, members):
    """K6's (step, column) vertex choices that differ from the twin's LMO
    at the same iterate, over the given members (as ``_fw_flips``)."""
    import torch

    from demethify_tpu_torch.ops.cuda_small import (
        _columns, _members, assemble_G_b_multi, fw_phase_full_multi)

    gtt, bt, gu, bu, ydy = args
    traj = [alpha0_b.clone()]
    for k in range(1, n_steps + 1):
        a = alpha0_b.clone()
        fw_phase_full_multi(gtt, bt, gu, bu, ydy, a, purity, scal_b.clone(),
                            k, n_u)
        traj.append(a)
    traj = torch.stack(traj)                       # (n_steps + 1, B, p, n_s)
    G, b = assemble_G_b_multi(gtt, bt, gu, bu)
    n_b, p, n_s = alpha0_b.shape
    G_c, b_c = G.reshape(n_b * n_s, p, p), _columns(b)
    # the twin's gradient expression on its column layout, per step
    grad = torch.stack([_members(torch.einsum("spq,qs->ps", G_c,
                                              _columns(a)) - b_c, n_b)
                        for a in traj[:-1]])[:, members]
    traj = traj[:, members]
    n_ct = alpha0_b.shape[1] - n_u
    k = torch.arange(n_steps, device=alpha0_b.device, dtype=alpha0_b.dtype)
    gamma = (2.0 / (k + 2.0))[:, None, None, None]
    vert = (traj[1:] - (1.0 - gamma) * traj[:-1]) / gamma
    flips = 0
    for lo, hi in ((0, n_ct), (n_ct, alpha0_b.shape[1])):
        want = torch.argmin(grad[:, :, lo:hi], dim=2)
        got = torch.argmax(vert[:, :, lo:hi], dim=2)
        flips += int((want != got).sum())
    return flips


def _k6_case(dtype_name, n_b=8, inactive=(5,), seed=40, timed=False,
             n_ct=N_CT):
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import ACTIVE, COST, L_W, N_SCAL
    from demethify_tpu_torch.ops.cuda_small import (
        fw_phase_full, fw_phase_full_multi, fw_phase_full_multi_plain)

    (gtt, bt, gu, bu, _, ydy, alpha_b, _,
     scal_b) = _glue_multi_inputs(n_ct, N_U, dtype_name, n_b, inactive, seed)
    rng = np.random.default_rng(seed)
    purity = torch.as_tensor(rng.uniform(0.3, 0.9, size=N_S), device=DEV,
                             dtype=alpha_b.dtype)
    alpha_b = torch.cat([
        alpha_b[:, :n_ct] / alpha_b[:, :n_ct].sum(1, keepdim=True) * purity,
        alpha_b[:, n_ct:] / alpha_b[:, n_ct:].sum(1, keepdim=True)
        * (1 - purity)], dim=1).contiguous()
    args = (gtt, bt, gu, bu, ydy)
    ak, sk = alpha_b.clone(), scal_b.clone()
    fw_phase_full_multi(*args, ak, purity, sk, P_INNER, N_U)
    ap_, sp = alpha_b.clone(), scal_b.clone()
    fw_phase_full_multi_plain(*args, ap_, purity, sp, P_INNER, N_U)
    torch.cuda.synchronize()
    act = [b for b in range(n_b) if b not in inactive]
    ina = list(inactive)
    err_a = float((ak[act] - ap_[act]).abs().max())
    scale = float(ydy.sum())
    err_c = float((sk[act, COST] - sp[act, COST]).abs().max()) / scale
    err_w = float(((sk[act, L_W] - sp[act, L_W]).abs()
                   / sp[act, L_W].abs()).max())
    err_m = float((ak[act, :n_ct].sum(1) - purity).abs().max())
    frozen = (torch.equal(ak[ina], alpha_b[ina])
              and torch.equal(sk[ina], scal_b[ina])) if ina else True
    flips = _fw_flips_multi(args, alpha_b, purity, scal_b, N_U, P_INNER, act)
    b0 = act[0]
    a1, s1 = alpha_b[b0].clone(), scal_b[b0, :N_SCAL].clone()
    fw_phase_full(gtt, bt, gu[b0], bu[b0], ydy, a1, purity, s1, P_INNER, N_U)
    torch.cuda.synchronize()
    same_k3 = torch.equal(a1, ak[b0]) and torch.equal(s1, sk[b0, :N_SCAL])
    tol_a = K3_TOL[dtype_name] + 4.0 * flips / P_INNER
    tol_c = TOL[dtype_name]["cost"] + 4.0 * flips / P_INNER
    res = {"p": n_ct + N_U, "members": n_b, "inactive": ina,
           "dtype": dtype_name, "alpha_max_abs": err_a,
           "cost_rel_to_sum_ydy": err_c, "l_w_rel": err_w, "flips": flips,
           "tol_alpha": tol_a, "frozen_unchanged": frozen,
           "member_equals_k3": same_k3}
    if timed:
        s_all = scal_b.clone()
        s_all[:, ACTIVE] = 1.0
        a_all = alpha_b.clone()
        res["ms"] = median_ms(lambda: fw_phase_full_multi(
            *args, a_all, purity, s_all, P_INNER, N_U), inner=10)
        res["plain_ms"] = median_ms(lambda: fw_phase_full_multi_plain(
            *args, ap_, purity, sp, P_INNER, N_U), reps=3, inner=1,
            warmup=1)
        n_bytes, flops = glue_work(n_ct + N_U, N_S, n_ct, P_INNER,
                                   alpha_b.element_size(), n_b, fw=True)
        res["bound_ms"], res["bound_by"] = bound(n_bytes, flops, dtype_name)
    log(f"[K6] B={n_b} (inactive {ina}) p={n_ct + N_U} n_s={N_S} {P_INNER} "
        f"steps {dtype_name}: active alpha max|diff| {err_a:.3e} (tol "
        f"{tol_a:.1e}); vertex choices that differ from the twin's at the "
        f"same iterate: {flips} of {2 * P_INNER * N_S * len(act)}; cost "
        f"diff / sum(ydy) {err_c:.3e}, l_w rel {err_w:.3e} (tol "
        f"{tol_c:.0e}); known mass - purity {err_m:.2e}; inactive members "
        f"bit-unchanged: {frozen}; member {b0} bit-identical to K3: "
        f"{same_k3}"
        + (f"; kernel {res['ms']:.4f} ms (all {n_b} active), plain "
           f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.6f} ms"
           if timed else ""))
    check(np.isfinite([err_a, err_c, err_w]).all(), "K6 non-finite")
    check(err_a <= tol_a, f"K6 alpha differs from its twin by {err_a}")
    check(dtype_name == "float32" or flips == 0,
          f"K6 float64 vertex choices differ ({flips})")
    check(max(err_c, err_w) <= tol_c, "K6 cost / l_w differ")
    check(err_m <= 10 * K3_TOL[dtype_name] + 1e-6,
          f"K6 known-block mass off the purity by {err_m}")
    check(frozen, "K6 changed an inactive member")
    return res


def phase_k6():
    main = _k6_case("float32", timed=True)
    _k6_case("float64")
    return main


# --------------------------------- phases 5e-5g: the weighted bootstrap's K4-K6
def _k4w_case(n_u, dtype_name, n_b, steps, n_ct=N_CT, lagged=False,
              inactive=(), seed=50, timed=False, label="", data=None):
    """K4 with its weights operand (resample multiplicities per member)
    against its twin; inactive members bit-unchanged; all-ones weights
    against the unweighted K4, bit for bit. ``data`` as for ``_k4_case``
    (the weight rows keep the state dtype)."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import ACTIVE
    from demethify_tpu_torch.ops.cuda_multi import (
        u_phase_grams_multi, u_phase_grams_multi_plain)

    dtype = getattr(torch, dtype_name)
    ydt, rtt, alpha_b, uut_b, scal_b = _multi_inputs(
        N_CPG, N_S, n_ct, n_u, n_b, dtype, seed, inactive)
    if data is not None:
        ydt = ydt.to(getattr(torch, data))
        rtt = None if rtt is None else rtt.to(ydt.dtype)
    w = resample_weights(n_b, N_CPG, dtype, seed)
    a1 = alpha_b[:, :-n_u] if n_ct else None
    a2 = alpha_b[:, -n_u:]
    uk, sk = uut_b.clone(), scal_b.clone()
    gk, bk, qk = u_phase_grams_multi(ydt, rtt, a1, a2, uk, sk, steps, lagged,
                                     weights=w)
    up, sp = uut_b.clone(), scal_b.clone()
    gp, bp, qp = u_phase_grams_multi_plain(ydt, rtt, a1, a2, up, sp, steps,
                                           lagged, weights=w)
    u1, s1 = uut_b.clone(), scal_b.clone()
    g1, b1, q1 = u_phase_grams_multi(ydt, rtt, a1, a2, u1, s1, steps, lagged,
                                     weights=torch.ones_like(w))
    u0, s0 = uut_b.clone(), scal_b.clone()
    g0, b0, q0 = u_phase_grams_multi(ydt, rtt, a1, a2, u0, s0, steps, lagged)
    torch.cuda.synchronize()
    act = [b for b in range(n_b) if b not in inactive]
    ina = list(inactive)
    err_u = float((uk[act] - up[act]).abs().max())
    scale = gp[act].abs().amax(dim=(1, 2, 3))
    err_g = float(((gk[act] - gp[act]).abs().amax(dim=(1, 2, 3))
                   / scale).max())
    err_b = float(((bk[act] - bp[act]).abs().amax(dim=(1, 2))
                   / scale).max())
    err_q = float(((qk[act] - qp[act]).abs() / qp[act].abs()).max())
    err_s = float(((sk[act] - sp[act]).abs()
                   / sp[act].abs().clamp_min(1e-30)).max())
    frozen = (torch.equal(uk[ina], uut_b[ina])
              and torch.equal(sk[ina], scal_b[ina])) if ina else True
    ones_equal = (torch.equal(u1, u0) and torch.equal(s1, s0)
                  and torch.equal(g1[act], g0[act])
                  and torch.equal(b1[act], b0[act])
                  and torch.equal(q1[act], q0[act]))
    # the weights reach the Grams (and only the Grams: u is the same)
    moved = float(((gk[act] - g0[act]).abs().amax(dim=(1, 2, 3))
                   / scale).min())
    same_u = torch.equal(uk, u0)
    tol = TOL[dtype_name]
    res = {"n": N_CPG, "n_ct": n_ct, "n_u": n_u, "members": n_b,
           "inactive": ina, "steps": steps, "lagged": lagged,
           "dtype": dtype_name, "u_max_abs": err_u, "gu_rel": err_g,
           "b_u_rel": err_b, "usq_rel": err_q, "scal_rel": err_s,
           "frozen_unchanged": frozen, "ones_equal_unweighted": ones_equal}
    if timed:
        s_all = scal_b.clone()
        s_all[:, ACTIVE] = 1.0
        u_all = uut_b.clone()
        res["ms"] = median_ms(lambda: u_phase_grams_multi(
            ydt, rtt, a1, a2, u_all, s_all, steps, lagged, weights=w),
            inner=3)
        res["unweighted_ms"] = median_ms(lambda: u_phase_grams_multi(
            ydt, rtt, a1, a2, u_all, s_all, steps, lagged), inner=3)
        res["plain_ms"] = median_ms(lambda: u_phase_grams_multi_plain(
            ydt, rtt, a1, a2, up, sp, steps, lagged, weights=w), reps=3,
            inner=1, warmup=1)
        n_bytes, flops = u_phase_work(N_CPG, N_S, n_ct, n_u, steps,
                                      uut_b.element_size(),
                                      ydt.element_size(), n_b, weighted=True)
        res["bound_ms"], res["bound_by"] = bound(n_bytes, flops, dtype_name)
    log(f"[K4w]{label} N={N_CPG} n_s={N_S} n_ct={n_ct} n_u={n_u} B={n_b} "
        f"(inactive {ina}){' lagged' if lagged else ''} {steps} steps "
        f"{dtype_name} state, {str(ydt.dtype)[6:]} data, resample weights: "
        f"active u/u_prev max|diff| "
        f"{err_u:.3e} (tol {tol['u']:.0e}); gu rel {err_g:.3e}, b_u rel "
        f"{err_b:.3e}, usq rel {err_q:.3e} (tol {tol['gram']:.0e}); scalars "
        f"rel {err_s:.3e}; inactive members bit-unchanged: {frozen}; "
        f"all-ones weights bit-identical to unweighted K4: {ones_equal}; u "
        f"bit-identical to unweighted K4: {same_u}; weighted vs unweighted "
        f"gu rel (min over members) {moved:.3e}"
        + (f"; kernel {res['ms']:.4f} ms (all {n_b} active), unweighted "
           f"{res['unweighted_ms']:.4f} ms ({res['ms'] / res['unweighted_ms']:.3f}x), "
           f"plain {res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
           f"({res['bound_by']})" if timed else ""))
    check(np.isfinite([err_u, err_g, err_b, err_q]).all(), "K4w non-finite")
    check(err_u <= tol["u"], f"K4w u differs from its twin by {err_u}")
    check(max(err_g, err_b, err_q) <= tol["gram"],
          f"K4w Grams differ from the twin by {max(err_g, err_b, err_q)}")
    check(err_s <= tol["gram"], f"K4w scalars differ by {err_s}")
    check(frozen, "K4w changed an inactive member")
    check(ones_equal, "K4 with all-ones weights differs from unweighted K4")
    check(same_u, "K4's weights changed the U steps")
    # resample weights move a sum over 1M sites by ~1e-3 of itself, 20x
    # above the float32 tolerance
    check(moved > 1e-4, "K4's weights did not reach the Grams")
    return res


def phase_k4_weighted():
    inactive = (3, 7, 11, 30)
    main = _k4w_case(N_U, "float32", 32, N_INNER, inactive=inactive,
                     timed=True, label="[bootstrap]")
    _k4w_case(N_U, "float64", 32, N_INNER, inactive=inactive)
    uns = _k4w_case(U_N_U, "float32", 8, N_INNER, n_ct=0, lagged=True,
                    inactive=(5,), seed=51, timed=True,
                    label="[unsupervised]")
    _k4w_case(U_N_U, "float64", 8, N_INNER, n_ct=0, lagged=True,
              inactive=(5,), seed=51)
    pur = _k4w_case(N_U, "float32", 8, P_INNER, inactive=(2,), seed=52,
                    timed=True, label="[purity]")
    _k4w_case(N_U, "float64", 8, P_INNER, inactive=(2,), seed=52)
    return main, uns, pur


def phase_k4_bf16(k4, k4w):
    """K4's bf16 form (Y, D, Rt in bf16, state float32) against its twin:
    unweighted at the restarts' shape (B = 16) and lagged without a known
    block (n_u = 3, B = 8), weighted at the bootstrap's (B = 32), each
    timed beside float32 K4 at the same B (``k4``, ``k4w``: the timed
    float32 cases of phases 5b and 5e)."""
    main = _k4_case(N_U, "float32", 16, N_INNER, inactive=(3, 7, 11),
                    timed=True, label="[bf16 restarts]", data="bfloat16")
    _k4_case(U_N_U, "float32", 8, N_INNER, n_ct=0, lagged=True,
             inactive=(5,), seed=21, label="[bf16 unsupervised]",
             data="bfloat16")
    weighted = _k4w_case(N_U, "float32", 32, N_INNER, inactive=(3, 7, 11, 30),
                         timed=True, label="[bf16 bootstrap]",
                         data="bfloat16")
    for name, bf, f32 in (("K4 B=16", main, k4), ("K4w B=32", weighted, k4w)):
        log(f"[K4 bf16] {name}: bf16 data {bf['ms']:.4f} ms against float32 "
            f"{f32['ms']:.4f} ms ({bf['ms'] / f32['ms']:.3f}x); bound "
            f"{bf['bound_ms']:.4f} ms ({bf['bound_by']}) against "
            f"{f32['bound_ms']:.4f} ms")
    return main, weighted


def _expanded(n_b, *blocks):
    """Shared known blocks copied out per member (B, ...), contiguous."""
    return tuple(x.expand(n_b, *x.shape).contiguous() for x in blocks)


def _k5w_case(n_ct, n_u, dtype_name, n_b, inactive, seed=60, timed=False):
    """K5 with per-member known blocks against its twin; and per-member
    copies of shared blocks against the shared-block launch, bit for
    bit."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import ACTIVE, COST, N_SCAL
    from demethify_tpu_torch.ops.cuda_small import (
        alpha_phase_full_multi, alpha_phase_full_multi_plain)

    (gtt, bt, gu, bu, usq, ydy, alpha_b, alpha_prev_b,
     scal_b) = _glue_multi_inputs(n_ct, n_u, dtype_name, n_b, inactive, seed,
                                  weighted=True)
    args = (gtt, bt, gu, bu, usq, ydy)
    ak, apk, sk = alpha_b.clone(), alpha_prev_b.clone(), scal_b.clone()
    alpha_phase_full_multi(*args, ak, apk, sk, N_INNER, n_u)
    ap_, app, sp = alpha_b.clone(), alpha_prev_b.clone(), scal_b.clone()
    alpha_phase_full_multi_plain(*args, ap_, app, sp, N_INNER, n_u)
    # the shared-block form (the restarts' K5) against per-member copies
    (sgtt, sbt, sgu, sbu, susq, sydy, s_alpha, s_prev,
     s_scal) = _glue_multi_inputs(n_ct, n_u, dtype_name, n_b, inactive,
                                  seed + 1)
    outs = []
    for known in ((sgtt, sbt, sydy), _expanded(n_b, sgtt, sbt, sydy)):
        a, ap, sc = s_alpha.clone(), s_prev.clone(), s_scal.clone()
        alpha_phase_full_multi(known[0], known[1], sgu, sbu, susq, known[2],
                               a, ap, sc, N_INNER, n_u)
        outs.append((a, ap, sc))
    torch.cuda.synchronize()
    shared_same = all(torch.equal(x, y) for x, y in zip(*outs))
    act = [b for b in range(n_b) if b not in inactive]
    ina = list(inactive)
    err_a = float(torch.maximum((ak[act] - ap_[act]).abs().max(),
                                (apk[act] - app[act]).abs().max()))
    scale = ydy.sum(1)[act]
    err_c = float(((sk[act, COST] - sp[act, COST]).abs() / scale).max())
    err_s = float(((sk[act, :N_SCAL] - sp[act, :N_SCAL]).abs()
                   / sp[act, :N_SCAL].abs().clamp_min(1e-30)).max())
    flags = torch.equal(sk[:, ACTIVE], sp[:, ACTIVE])
    frozen = (torch.equal(ak[ina], alpha_b[ina])
              and torch.equal(apk[ina], alpha_prev_b[ina])
              and torch.equal(sk[ina], scal_b[ina])) if ina else True
    p = n_ct + n_u
    tol = TOL[dtype_name]
    res = {"p": p, "n_ct": n_ct, "members": n_b, "inactive": ina,
           "dtype": dtype_name, "alpha_max_abs": err_a,
           "cost_rel_to_sum_ydy": err_c, "scal_rel": err_s,
           "frozen_unchanged": frozen, "shared_equals_copies": shared_same}
    if timed:
        s_all = scal_b.clone()
        s_all[:, ACTIVE] = 1.0
        a_all, ap_all = alpha_b.clone(), alpha_prev_b.clone()
        res["ms"] = median_ms(lambda: alpha_phase_full_multi(
            *args, a_all, ap_all, s_all, N_INNER, n_u), inner=20)
        res["plain_ms"] = median_ms(lambda: alpha_phase_full_multi_plain(
            *args, ap_, app, sp, N_INNER, n_u), inner=5)
        n_bytes, flops = glue_work(p, N_S, n_ct, N_INNER,
                                   alpha_b.element_size(), n_b,
                                   own_known=True)
        res["bound_ms"], res["bound_by"] = bound(n_bytes, flops, dtype_name)
    log(f"[K5w] B={n_b} (inactive {ina}) p={p} n_ct={n_ct} n_s={N_S} "
        f"{N_INNER} steps {dtype_name}, per-member weighted known blocks: "
        f"active alpha/alpha_prev max|diff| {err_a:.3e} (tol "
        f"{tol['alpha']:.0e}); cost diff / sum(ydy) {err_c:.3e}, scalars rel "
        f"{err_s:.3e} (tol {tol['cost']:.0e}); active flags equal: {flags}; "
        f"inactive members bit-unchanged: {frozen}; shared blocks "
        f"bit-identical to per-member copies of them: {shared_same}"
        + (f"; kernel {res['ms']:.4f} ms (all {n_b} active), plain "
           f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.6f} ms"
           if timed else ""))
    check(np.isfinite([err_a, err_c, err_s]).all(), "K5w non-finite")
    check(err_a <= tol["alpha"], f"K5w alpha differs by {err_a}")
    check(max(err_c, err_s) <= tol["cost"], "K5w cost / scalars differ")
    check(flags and frozen, "K5w active flags or an inactive member differ")
    check(shared_same, "K5: shared blocks differ from per-member copies")
    return res


def phase_k5_weighted():
    main = _k5w_case(N_CT, N_U, "float32", 32, (2, 9), timed=True)
    _k5w_case(N_CT, N_U, "float64", 32, (2, 9))
    _k5w_case(0, U_N_U, "float32", 8, (4,), seed=61)
    _k5w_case(0, U_N_U, "float64", 8, (4,), seed=61)
    return main


def _k6w_case(dtype_name, n_b=8, inactive=(5,), seed=70, timed=False):
    """K6 with per-member known blocks against its twin; and per-member
    copies of shared blocks against the shared-block launch, bit for
    bit."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import ACTIVE, COST, L_W
    from demethify_tpu_torch.ops.cuda_small import (
        fw_phase_full_multi, fw_phase_full_multi_plain)

    rng = np.random.default_rng(seed)
    purity = None

    def inputs(weighted, sd):
        nonlocal purity
        (gtt, bt, gu, bu, _, ydy, alpha_b, _,
         scal_b) = _glue_multi_inputs(N_CT, N_U, dtype_name, n_b, inactive,
                                      sd, weighted=weighted)
        if purity is None:
            purity = torch.as_tensor(rng.uniform(0.3, 0.9, size=N_S),
                                     device=DEV, dtype=alpha_b.dtype)
        alpha_b = torch.cat([
            alpha_b[:, :N_CT] / alpha_b[:, :N_CT].sum(1, keepdim=True)
            * purity,
            alpha_b[:, N_CT:] / alpha_b[:, N_CT:].sum(1, keepdim=True)
            * (1 - purity)], dim=1).contiguous()
        return (gtt, bt, gu, bu, ydy), alpha_b, scal_b

    args, alpha_b, scal_b = inputs(True, seed)
    ak, sk = alpha_b.clone(), scal_b.clone()
    fw_phase_full_multi(*args, ak, purity, sk, P_INNER, N_U)
    ap_, sp = alpha_b.clone(), scal_b.clone()
    fw_phase_full_multi_plain(*args, ap_, purity, sp, P_INNER, N_U)
    (sgtt, sbt, sgu, sbu, sydy), s_alpha, s_scal = inputs(False, seed + 1)
    outs = []
    for known in ((sgtt, sbt, sydy), _expanded(n_b, sgtt, sbt, sydy)):
        a, sc = s_alpha.clone(), s_scal.clone()
        fw_phase_full_multi(known[0], known[1], sgu, sbu, known[2], a,
                            purity, sc, P_INNER, N_U)
        outs.append((a, sc))
    torch.cuda.synchronize()
    shared_same = all(torch.equal(x, y) for x, y in zip(*outs))
    act = [b for b in range(n_b) if b not in inactive]
    ina = list(inactive)
    err_a = float((ak[act] - ap_[act]).abs().max())
    scale = args[4].sum(1)[act]
    err_c = float(((sk[act, COST] - sp[act, COST]).abs() / scale).max())
    err_w = float(((sk[act, L_W] - sp[act, L_W]).abs()
                   / sp[act, L_W].abs()).max())
    frozen = (torch.equal(ak[ina], alpha_b[ina])
              and torch.equal(sk[ina], scal_b[ina])) if ina else True
    flips = _fw_flips_multi(args, alpha_b, purity, scal_b, N_U, P_INNER, act)
    tol_a = K3_TOL[dtype_name] + 4.0 * flips / P_INNER
    tol_c = TOL[dtype_name]["cost"] + 4.0 * flips / P_INNER
    res = {"p": N_CT + N_U, "members": n_b, "inactive": ina,
           "dtype": dtype_name, "alpha_max_abs": err_a,
           "cost_rel_to_sum_ydy": err_c, "l_w_rel": err_w, "flips": flips,
           "frozen_unchanged": frozen, "shared_equals_copies": shared_same}
    if timed:
        s_all = scal_b.clone()
        s_all[:, ACTIVE] = 1.0
        a_all = alpha_b.clone()
        res["ms"] = median_ms(lambda: fw_phase_full_multi(
            *args, a_all, purity, s_all, P_INNER, N_U), inner=10)
        res["plain_ms"] = median_ms(lambda: fw_phase_full_multi_plain(
            *args, ap_, purity, sp, P_INNER, N_U), reps=3, inner=1,
            warmup=1)
        n_bytes, flops = glue_work(N_CT + N_U, N_S, N_CT, P_INNER,
                                   alpha_b.element_size(), n_b, fw=True,
                                   own_known=True)
        res["bound_ms"], res["bound_by"] = bound(n_bytes, flops, dtype_name)
    log(f"[K6w] B={n_b} (inactive {ina}) p={N_CT + N_U} n_s={N_S} {P_INNER} "
        f"steps {dtype_name}, per-member weighted known blocks: active alpha "
        f"max|diff| {err_a:.3e} (tol {tol_a:.1e}); vertex flips {flips}; "
        f"cost diff / sum(ydy) {err_c:.3e}, l_w rel {err_w:.3e} (tol "
        f"{tol_c:.0e}); inactive members bit-unchanged: {frozen}; shared "
        f"blocks bit-identical to per-member copies of them: {shared_same}"
        + (f"; kernel {res['ms']:.4f} ms (all {n_b} active), plain "
           f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.6f} ms"
           if timed else ""))
    check(np.isfinite([err_a, err_c, err_w]).all(), "K6w non-finite")
    check(err_a <= tol_a, f"K6w alpha differs from its twin by {err_a}")
    check(dtype_name == "float32" or flips == 0,
          f"K6w float64 vertex choices differ ({flips})")
    check(max(err_c, err_w) <= tol_c, "K6w cost / l_w differ")
    check(frozen, "K6w changed an inactive member")
    check(shared_same, "K6: shared blocks differ from per-member copies")
    return res


def phase_k6_weighted():
    main = _k6w_case("float32", timed=True)
    _k6w_case("float64")
    return main


# ---------------------------------------------------------------- phase 6
def make_problem(dtype=np.float32, seed=0, n_cpg=None):
    """bench.py's workload recipe (numpy, seeded), at N_CPG sites unless
    n_cpg says otherwise."""
    n_cpg = N_CPG if n_cpg is None else n_cpg
    rng = np.random.default_rng(seed)
    Rt = rng.uniform(size=(n_cpg, N_CT)).astype(dtype)
    at = rng.dirichlet(np.ones(N_CT + N_U), size=N_S).T.astype(dtype)
    ut = rng.uniform(size=(n_cpg, N_U)).astype(dtype)
    y = np.clip(np.hstack([Rt, ut]) @ at
                + 0.01 * rng.normal(size=(n_cpg, N_S)), 0, 1).astype(dtype)
    d = (rng.poisson(50, size=(n_cpg, N_S)) + 1).astype(dtype)
    u0 = rng.uniform(size=(n_cpg, N_U)).astype(dtype)
    a0 = rng.dirichlet(np.ones(N_CT + N_U), size=N_S).T.astype(dtype)
    return u0, a0, y, d, Rt


def purity_draw(seed=0):
    """The purity path's known-block masses, one per sample."""
    return np.random.default_rng(seed + 100).uniform(0.3, 0.9, size=N_S)


def unsupervised_init(n_cpg, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed + 200)
    return (rng.uniform(size=(n_cpg, U_N_U)).astype(dtype),
            rng.dirichlet(np.ones(U_N_U), size=N_S).T.astype(dtype))


def _compare(name, shape, kernel, plain, tol, n_want):
    """Kernel solver result against the plain solver's: cost traces and
    final alpha."""
    (_, ak, ik), (_, ap, ip) = kernel, plain
    tk = ik["trace"].double().cpu().numpy()
    tp = ip["trace"].double().cpu().numpy()
    err_c = float(np.max(np.abs(tk - tp) / np.abs(tp)))
    err_a = float((ak - ap).abs().max())
    log(f"[solver] {name} {shape}: kernel vs plain solver cost trace max "
        f"rel diff {err_c:.3e} (tol {tol['cost']:.0e}), alpha max|diff| "
        f"{err_a:.3e} (tol {tol['alpha']:.0e}); n_iter "
        f"{ik['n_iter']}/{ip['n_iter']}; cost {tk[0]:.6e} -> {tk[-1]:.6e}")
    check(ik["n_iter"] == ip["n_iter"] == n_want, f"{name}: n_iter differs")
    check(np.isfinite(tk).all(), f"{name}: non-finite kernel cost trace")
    check(err_c <= tol["cost"] and err_a <= tol["alpha"],
          f"{name}: trajectories differ")


def phase_solver_trajectory():
    import torch

    from demethify_tpu_torch import state
    from demethify_tpu_torch.solvers import fused
    from demethify_tpu_torch.solvers.partial_ref import partial_ref_solve
    from demethify_tpu_torch.solvers.purity import purity_solve
    from demethify_tpu_torch.solvers.unsupervised import unsupervised_solve

    problem = make_problem(np.float64, seed=1, n_cpg=N_TRAJ)
    for name in ("float64", "float32"):
        t = state.from_numpy(*problem, device=DEV,
                             dtype=getattr(torch, name))
        kw = dict(n_iter1=50, n_iter2=N_INNER, tol=0.0, record_trace=True)
        _compare(f"partial-ref 50x{N_INNER} {name}", f"N={N_TRAJ}",
                 fused.partial_ref_solve_fused(*t, N_U, **kw),
                 partial_ref_solve(*t, N_U, **kw), TRAJ_TOL[name], 50)

    t = state.from_numpy(*problem, device=DEV, dtype=torch.float64)
    pur = state.purity_from_numpy(purity_draw(1), device=DEV,
                                  dtype=torch.float64)
    kw = dict(n_iter1=20, n_iter2=P_INNER, tol=0.0, record_trace=True)
    _compare(f"purity 20x{P_INNER} float64", f"N={N_TRAJ}",
             fused.purity_solve_fused(*t, pur, N_U, **kw),
             purity_solve(*t, pur, N_U, **kw), TRAJ_TOL["float64"], 20)

    u0, a0 = unsupervised_init(N_TRAJ, np.float64, seed=1)
    u, alpha, y, d, _ = state.from_numpy(u0, a0, problem[2], problem[3],
                                         None, device=DEV,
                                         dtype=torch.float64)
    kw = dict(n_iter1=50, n_iter2=N_INNER, tol=0.0, record_trace=True)
    _compare(f"unsupervised 50x{N_INNER} n_u={U_N_U} float64",
             f"N={N_TRAJ}",
             fused.unsupervised_solve_fused(u, alpha, y, d, U_N_U, **kw),
             unsupervised_solve(u, alpha, y, d, U_N_U, **kw),
             TRAJ_TOL["float64"], 50)


def phase_bf16_solvers():
    """The kernel solvers on bf16 storage (Y, D, R in bf16, state float32)
    against the plain solvers on the card, at 200k sites, with the float32
    trajectory tolerances: partial-reference and unsupervised, 50 x 20.
    The bf16_compute form against the same solver on the CPU, where it
    runs the kernels' twins (the plain solvers have no such form), at
    BF16C_TRAJ_TOL, on the problems of two seeds."""
    import torch

    from demethify_tpu_torch import state
    from demethify_tpu_torch.solvers import fused
    from demethify_tpu_torch.solvers.partial_ref import partial_ref_solve
    from demethify_tpu_torch.solvers.unsupervised import unsupervised_solve

    problem = make_problem(np.float32, seed=1, n_cpg=N_TRAJ)
    kw = dict(n_iter1=50, n_iter2=N_INNER, tol=0.0, record_trace=True)
    t = state.from_numpy(*problem, device=DEV, dtype=torch.bfloat16)
    check(t[2].dtype == torch.bfloat16 and t[0].dtype == torch.float32,
          "bf16 storage: from_numpy dtypes")
    reset_counts()
    kernel = fused.partial_ref_solve_fused(*t, N_U, **kw)
    check(read_counts()["u_phase_grams[bf16]"] == 50,
          f"bf16 partial-ref solve launches {read_counts()}")
    _compare(f"partial-ref 50x{N_INNER} bf16 data", f"N={N_TRAJ}", kernel,
             partial_ref_solve(*t, N_U, **kw), TRAJ_TOL["float32"], 50)
    for seed in (1, 2):
        prob = problem if seed == 1 else make_problem(np.float32, seed=seed,
                                                      n_cpg=N_TRAJ)
        t_dev = state.from_numpy(*prob, device=DEV, dtype=torch.bfloat16)
        t_cpu = state.from_numpy(*prob, device="cpu", dtype=torch.bfloat16)
        reset_counts()
        kernel = fused.partial_ref_solve_fused(*t_dev, N_U, bf16_compute=True,
                                               **kw)
        check(read_counts()["u_phase_grams[bf16_compute]"] == 50,
              f"bf16_compute solve launches {read_counts()}")
        twins = fused.partial_ref_solve_fused(*t_cpu, N_U, bf16_compute=True,
                                              **kw)
        _compare(f"partial-ref 50x{N_INNER} bf16_compute, card vs CPU twins",
                 f"N={N_TRAJ} seed {seed}", kernel,
                 tuple(x.to(DEV) if torch.is_tensor(x) else x
                       for x in twins[:2]) + (twins[2],), BF16C_TRAJ_TOL, 50)
    u0, a0 = unsupervised_init(N_TRAJ, np.float32, seed=1)
    u, alpha, y, d, _ = state.from_numpy(u0, a0, problem[2], problem[3], None,
                                         device=DEV, dtype=torch.bfloat16)
    _compare(f"unsupervised 50x{N_INNER} n_u={U_N_U} bf16 data",
             f"N={N_TRAJ}",
             fused.unsupervised_solve_fused(u, alpha, y, d, U_N_U, **kw),
             unsupervised_solve(u, alpha, y, d, U_N_U, **kw),
             TRAJ_TOL["float32"], 50)


def _member_inits(n_cpg, n_b, n_ct, n_u, seed, purity=None, n_s=N_S):
    """B members' seeded initial factors (numpy): u (B, n_cpg, n_u) and
    alpha (B, p, n_s), the known rows scaled to ``purity`` when given."""
    rng = np.random.default_rng(seed + 300)
    u_b = rng.uniform(size=(n_b, n_cpg, n_u))
    a_b = np.stack([rng.dirichlet(np.ones(n_ct + n_u), size=n_s).T
                    for _ in range(n_b)])
    if purity is not None:
        a_b[:, :n_ct] *= purity / a_b[:, :n_ct].sum(1, keepdims=True)
        a_b[:, n_ct:] *= (1 - purity) / a_b[:, n_ct:].sum(1, keepdims=True)
    return u_b, a_b


def _multi_vs_members(tag, multi, members, against, tol):
    """The multi solver's members against per-member solves: n_iter each,
    cost trace and alpha max|diff|; 'bit-identical' when u, alpha, cost
    and trace are all equal."""
    import torch

    u_b, a_b, info = multi
    n_iters, errs_a, errs_c, same = [], [], [], []
    for b, (u1, a1, i1) in enumerate(members):
        n_iters.append((int(info["n_iter"][b]), int(i1["n_iter"])))
        errs_a.append(float((a_b[b] - a1).abs().max()))
        tk = info["trace"][b].double().cpu().numpy()
        t1 = i1["trace"].double().cpu().numpy()
        live = ~np.isnan(t1)
        errs_c.append(float(np.max(np.abs(tk[live] - t1[live])
                                   / np.abs(t1[live]))))
        same.append(torch.equal(u_b[b], u1) and torch.equal(a_b[b], a1)
                    and bool((info["cost"][b] == i1["cost"]).item())
                    and np.array_equal(tk, t1, equal_nan=True))
    verdict = ("bit-identical" if all(same) else
               f"alpha max|diff| {max(errs_a):.3e}, cost trace max rel "
               f"diff {max(errs_c):.3e} (tol {tol:.0e})")
    log(f"[multi] {tag} vs {against}: n_iter per member (multi, other) "
        f"{n_iters}; {verdict}")
    check(all(m == o for m, o in n_iters), f"{tag}: n_iter differs")
    check(max(errs_a) <= tol and max(errs_c) <= tol,
          f"{tag}: members differ from {against}")
    return all(same), n_iters


def phase_multi_solvers():
    """The three multi-member kernel solvers, float64 at 200k sites, from
    the same stacked inits: against the plain solver on each member, and
    against the sequential single-member kernel solver."""
    import torch

    from demethify_tpu_torch import state
    from demethify_tpu_torch.solvers import fused
    from demethify_tpu_torch.solvers.partial_ref import partial_ref_solve
    from demethify_tpu_torch.solvers.purity import purity_solve
    from demethify_tpu_torch.solvers.unsupervised import unsupervised_solve

    n_b, f64 = 4, torch.float64
    _, _, y, d, Rt = make_problem(np.float64, seed=1, n_cpg=N_TRAJ)
    purity = purity_draw(1)
    pur = state.purity_from_numpy(purity, device=DEV, dtype=f64)
    modes = (
        ("partial-ref", N_CT, N_U, None, Rt, 50, N_INNER,
         fused.partial_ref_solve_fused_multi, fused.partial_ref_solve_fused,
         partial_ref_solve, ()),
        ("purity", N_CT, N_U, purity, Rt, 20, P_INNER,
         fused.purity_solve_fused_multi, fused.purity_solve_fused,
         purity_solve, (pur,)),
        ("unsupervised", 0, U_N_U, None, None, 50, N_INNER,
         fused.unsupervised_solve_fused_multi, fused.unsupervised_solve_fused,
         unsupervised_solve, ()))
    identical = {}
    for name, n_ct, n_u, pu, R, n1, n2, multi, single, plain, extra in modes:
        u_b, a_b = _member_inits(N_TRAJ, n_b, n_ct, n_u, seed=len(name),
                                 purity=pu)
        u_b, a_b, yt, dt, Rtt = state.from_numpy_batch(
            u_b, a_b, y, d, R, device=DEV, dtype=f64)
        data = (yt, dt) if Rtt is None else (yt, dt, Rtt)
        kw = dict(n_iter1=n1, n_iter2=n2, tol=0.0, record_trace=True)
        res = multi(u_b, a_b, *data, *extra, n_u, **kw)
        tag = f"{name} B={n_b} {n1}x{n2} float64 N={N_TRAJ}"
        _multi_vs_members(tag, res, [plain(u_b[b], a_b[b], *data, *extra,
                                           n_u, **kw) for b in range(n_b)],
                          "the plain solver per member",
                          TRAJ_TOL["float64"]["cost"])
        identical[name], _ = _multi_vs_members(
            tag, res, [single(u_b[b], a_b[b], *data, *extra, n_u, **kw)
                       for b in range(n_b)],
            "the sequential single-member kernel solver", 1e-12)

    # a loose relative tolerance: the members stop at different iterations
    u_b, a_b = _member_inits(N_TRAJ, 6, N_CT, N_U, seed=9)
    u_b, a_b, yt, dt, Rtt = state.from_numpy_batch(u_b, a_b, y, d, Rt,
                                                   device=DEV, dtype=f64)
    kw = dict(n_iter1=400, n_iter2=N_INNER, tol=LOOSE_TOL, tol_relative=True,
              record_trace=True)
    res = fused.partial_ref_solve_fused_multi(u_b, a_b, yt, dt, Rtt, N_U,
                                              **kw)
    identical["loose tol"], n_iters = _multi_vs_members(
        f"partial-ref B=6 tol={LOOSE_TOL:g} relative float64", res,
        [fused.partial_ref_solve_fused(u_b[b], a_b[b], yt, dt, Rtt, N_U,
                                       **kw) for b in range(6)],
        "the sequential single-member kernel solver", 1e-12)
    check(len({m for m, _ in n_iters}) > 1,
          f"loose tol: every member stopped at the same iteration {n_iters}")
    return identical


def phase_weighted_solvers():
    """The three multi-member kernel solvers with ``row_weights_b`` (the
    weighted bootstrap; B = 4 resample weight rows, float64, 200k sites)
    against the plain solver with ``row_weights`` on each member: n_iter,
    cost trace (rtol 1e-9), alpha and u."""
    import torch

    from demethify_tpu_torch import state
    from demethify_tpu_torch.solvers import fused
    from demethify_tpu_torch.solvers.partial_ref import partial_ref_solve
    from demethify_tpu_torch.solvers.purity import purity_solve
    from demethify_tpu_torch.solvers.unsupervised import unsupervised_solve

    n_b, f64 = 4, torch.float64
    _, _, y, d, Rt = make_problem(np.float64, seed=2, n_cpg=N_TRAJ)
    purity = purity_draw(2)
    pur = state.purity_from_numpy(purity, device=DEV, dtype=f64)
    w_b = resample_weights(n_b, N_TRAJ, f64, seed=80)
    modes = (
        ("partial-ref", N_CT, N_U, None, Rt, 50, N_INNER,
         fused.partial_ref_solve_fused_multi, partial_ref_solve, ()),
        ("purity", N_CT, N_U, purity, Rt, 20, P_INNER,
         fused.purity_solve_fused_multi, purity_solve, (pur,)),
        ("unsupervised", 0, U_N_U, None, None, 50, N_INNER,
         fused.unsupervised_solve_fused_multi, unsupervised_solve, ()))
    tol = TRAJ_TOL["float64"]["cost"]
    for name, n_ct, n_u, pu, R, n1, n2, multi, plain, extra in modes:
        u_b, a_b = _member_inits(N_TRAJ, n_b, n_ct, n_u, seed=20 + len(name),
                                 purity=pu)
        u_b, a_b, yt, dt, Rtt = state.from_numpy_batch(
            u_b, a_b, y, d, R, device=DEV, dtype=f64)
        data = (yt, dt) if Rtt is None else (yt, dt, Rtt)
        kw = dict(n_iter1=n1, n_iter2=n2, tol=0.0, record_trace=True)
        res = multi(u_b, a_b, *data, *extra, n_u, row_weights_b=w_b, **kw)
        members = [plain(u_b[b], a_b[b], *data, *extra, n_u,
                         row_weights=w_b[b], **kw) for b in range(n_b)]
        err_u = max(float((res[0][b] - m[0]).abs().max())
                    for b, m in enumerate(members))
        _multi_vs_members(
            f"weighted {name} B={n_b} {n1}x{n2} float64 N={N_TRAJ}", res,
            members, "the plain weighted solver per member", tol)
        log(f"[multi] weighted {name}: u max|diff| {err_u:.3e} (tol "
            f"{tol:.0e})")
        check(err_u <= tol, f"weighted {name}: u differs from plain")


# ---------------------------------------------------------------- phase 7
def _enqueue_only_ms(t, n_iter, purity=None):
    """ms per outer iteration of the same launches as a solve, with no host
    read in between: the device-bound loop the termination read stalls.
    t = (u, alpha, y, d, Rt): K1 + K2 (partial reference), K1 + K3 given
    ``purity``, or, with Rt None, K1 lagged without a known block + K2
    (unsupervised)."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import (
        A_ALPHA, A_U, DMAX2, L_H_PREV, L_W, L_W_PREV, N_SCAL, RT_SQ,
        u_phase_grams)
    from demethify_tpu_torch.ops.cuda_small import (
        alpha_phase_full, fw_phase_full)
    from demethify_tpu_torch.ops.gram import known_block_grams

    u, alpha, y, d, Rt = t
    n_u = u.shape[1]
    if Rt is None:
        Rt = y.new_empty((y.shape[0], 0))
    ydt = torch.cat([y.T, d.T]).contiguous()
    rtt = Rt.T.contiguous()
    uut = torch.cat([u.T, u.T]).contiguous()
    alpha, alpha_prev = alpha.clone(), alpha.clone()
    gtt, bt, ydy = (x.contiguous() for x in known_block_grams(Rt, d, y))
    dmax2 = d.max() ** 2
    scal = torch.zeros(N_SCAL, device=y.device, dtype=y.dtype)
    scal[A_U] = scal[A_ALPHA] = 1.0
    scal[L_W] = scal[L_W_PREV] = torch.sum(alpha[-n_u:] ** 2) * dmax2
    scal[L_H_PREV] = (torch.sum(Rt * Rt) + torch.sum(u * u)) * dmax2
    scal[RT_SQ], scal[DMAX2] = torch.sum(Rt * Rt), dmax2
    inner = N_INNER if purity is None else P_INNER
    lagged = Rt.shape[1] == 0

    def run():
        for _ in range(n_iter):
            gu, bu, usq = u_phase_grams(ydt, rtt, alpha[:-n_u],
                                        alpha[-n_u:], uut, scal, inner,
                                        lagged)
            if purity is None:
                alpha_phase_full(gtt, bt, gu, bu, usq, ydy, alpha,
                                 alpha_prev, scal, inner, n_u)
            else:
                fw_phase_full(gtt, bt, gu, bu, ydy, alpha, purity, scal,
                              inner, n_u)
    return median_ms(run, reps=3, warmup=1) / n_iter


def _drive(tag, what, call, n_outer, enqueue_ms=None, n_sites=N_CPG):
    """One full-width run through an entry point, with the counters set to
    0 just before and read just after. Returns (result, ms per outer
    iteration, launches)."""
    import torch

    reset_counts()
    t0 = time.perf_counter()
    res, ms = timed_ms(call)
    wall = time.perf_counter() - t0
    launches = read_counts()
    ms_iter = ms / n_outer
    extra = ""
    if enqueue_ms is not None:
        share = max(0.0, 1.0 - enqueue_ms / ms_iter)
        extra = (f"; same launches without the per-iteration cost read "
                 f"{enqueue_ms:.4f} ms/iter -> host-read share {share:.3f}")
    log(f"[{tag}] {what}: {ms_iter:.4f} ms per outer iteration (CUDA "
        f"events), {n_sites * n_outer / (ms / 1e3):.4e} site-iters/s, wall "
        f"{wall:.3f} s{extra}; launches {launches}")
    check(res.n_iter == n_outer, f"{tag} ran {res.n_iter} iterations")
    check(bool(torch.isfinite(res.proportions).all())
          and bool(torch.isfinite(res.u).all()), f"non-finite {tag} output")
    check(float(res.u.min()) >= 0 and float(res.u.max()) <= 1,
          f"{tag}: u off [0, 1]")
    trace = res.trace.cpu().numpy()
    check(np.isfinite(trace).all() and trace[-1] < trace[0],
          f"{tag}: cost did not decrease")
    return res, ms_iter, launches


def _per_iter_ms(call, n_outer):
    """(result, device ms per outer iteration) of one solver call."""
    res, ms = timed_ms(call)
    return res, ms / n_outer


def phase_main_path(problem32, card):
    import torch

    from demethify_tpu_torch import state
    from demethify_tpu_torch.solvers.api import partial_reference_deconv
    from demethify_tpu_torch.solvers.fused import partial_ref_solve_fused
    from demethify_tpu_torch.solvers.partial_ref import partial_ref_solve

    t = state.from_numpy(*problem32, device=DEV, dtype=torch.float32)
    u0, a0, y, d, Rt = t
    enqueue_ms = _enqueue_only_ms(t, 200)
    kw = dict(n_iter1=N_OUTER, n_iter2=N_INNER, tol=0.0, record_trace=True)
    partial_reference_deconv(y, d, Rt, N_U, init_provided=(u0, a0),
                             **dict(kw, n_iter1=5))                # warm
    torch.cuda.synchronize()
    res, ms_iter, launches = _drive(
        "main", f"bench workload 1M x 10, 5+1, float32, {N_OUTER}x{N_INNER}, "
        f"tol=0 via solvers.api.partial_reference_deconv, card {card}",
        lambda: partial_reference_deconv(y, d, Rt, N_U,
                                         init_provided=(u0, a0), **kw),
        N_OUTER, enqueue_ms)
    check(expect_counts(launches, u_phase_grams=N_OUTER,
                        alpha_phase_full=N_OUTER),
          f"launch counts {launches} != {N_OUTER} outer iterations")
    props = res.proportions
    check(res.u.shape == (N_CPG, N_U) and props.shape == (N_CT + N_U, N_S),
          "main path output shapes")
    check(float((props.sum(0) - 1).abs().max()) < 1e-4, "alpha off simplex")

    # the plain solver on the card, same workload, as the reference. In
    # float32 the two agree on the final cost; alpha drifts apart along
    # the objective's flat direction (rounding amplified over 1000
    # iterations), so it is reported here and held tightly in float64.
    (_, a_p, info_p), plain_ms = _per_iter_ms(
        lambda: partial_ref_solve(u0, a0, y, d, Rt, N_U, **kw), N_OUTER)
    c_k, c_p = float(res.cost), float(info_p["cost"])
    err_c = abs(c_k - c_p) / abs(c_p)
    err_a = float((props - a_p).abs().max())
    log(f"[main] plain solver, same workload: {plain_ms:.4f} ms per outer "
        f"iteration; final cost kernel {c_k:.6e} plain {c_p:.6e} (rel diff "
        f"{err_c:.3e}, tol {TRAJ_TOL['float32']['cost']:.0e}); alpha "
        f"max|diff| {err_a:.3e} (float32 drift, not held)")
    check(err_c <= TRAJ_TOL["float32"]["cost"], "final cost vs plain")

    t64 = state.from_numpy(*problem32, device=DEV, dtype=torch.float64)
    kw64 = dict(n_iter1=N_OUTER, n_iter2=N_INNER, tol=0.0)
    _, a_k64, i_k64 = partial_ref_solve_fused(*t64, N_U, **kw64)
    _, a_p64, i_p64 = partial_ref_solve(*t64, N_U, **kw64)
    err_a64 = float((a_k64 - a_p64).abs().max())
    err_c64 = abs(float(i_k64["cost"]) / float(i_p64["cost"]) - 1)
    log(f"[main] same workload in float64, kernel vs plain solver after "
        f"{N_OUTER}x{N_INNER}: alpha max|diff| {err_a64:.3e} (tol "
        f"{LONG_TOL64['alpha']:.0e}), cost rel diff {err_c64:.3e} (tol "
        f"{LONG_TOL64['cost']:.0e})")
    check(err_a64 <= LONG_TOL64["alpha"] and err_c64 <= LONG_TOL64["cost"],
          "float64 long run: kernel solver differs from plain")
    return launches


def phase_purity_path(problem32, card):
    import torch

    from demethify_tpu_torch import state
    from demethify_tpu_torch.solvers.api import purity_deconv
    from demethify_tpu_torch.solvers.fused import purity_solve_fused
    from demethify_tpu_torch.solvers.purity import purity_solve

    t = state.from_numpy(*problem32, device=DEV, dtype=torch.float32)
    u0, a0, y, d, Rt = t
    purity = purity_draw(0)
    pur = state.purity_from_numpy(purity, device=DEV, dtype=torch.float32)
    enqueue_ms = _enqueue_only_ms(t, 10, purity=pur)
    kw = dict(n_iter1=P_OUTER, n_iter2=P_INNER, tol=0.0, record_trace=True)
    purity_deconv(y, d, Rt, N_U, pur, init_provided=(u0, a0),
                  **dict(kw, n_iter1=2))                             # warm
    torch.cuda.synchronize()
    res, ms_iter, launches = _drive(
        "purity", f"1M x 10, 5+1, purity in [0.3, 0.9], float32, "
        f"{P_OUTER}x{P_INNER}, tol=0 via solvers.api.purity_deconv, card "
        f"{card}",
        lambda: purity_deconv(y, d, Rt, N_U, pur, init_provided=(u0, a0),
                              **kw), P_OUTER, enqueue_ms)
    check(expect_counts(launches, u_phase_grams=P_OUTER,
                        fw_phase_full=P_OUTER),
          f"purity launch counts {launches}")
    props = res.proportions
    err_m = float((props[:N_CT].sum(0) - pur).abs().max())
    log(f"[purity] known-block mass - purity: max {err_m:.3e} (tol 1e-5)")
    check(err_m <= 1e-5, "purity path: known-block mass off the purity")

    t64 = state.from_numpy(*problem32, device=DEV, dtype=torch.float64)
    pur64 = pur.double()
    kw64 = dict(n_iter1=P_OUTER, n_iter2=P_INNER, tol=0.0)
    (_, a_k64, i_k64), k_ms = _per_iter_ms(
        lambda: purity_solve_fused(*t64, pur64, N_U, **kw64), P_OUTER)
    (_, a_p64, i_p64), plain_ms = _per_iter_ms(
        lambda: purity_solve(*t64, pur64, N_U, **kw64), P_OUTER)
    err_a64 = float((a_k64 - a_p64).abs().max())
    err_c64 = abs(float(i_k64["cost"]) / float(i_p64["cost"]) - 1)
    log(f"[purity] same run in float64: kernel {k_ms:.4f} ms, plain solver "
        f"{plain_ms:.4f} ms per outer iteration; alpha max|diff| "
        f"{err_a64:.3e} (tol {LONG_TOL64['alpha']:.0e}), cost rel diff "
        f"{err_c64:.3e} (tol {LONG_TOL64['cost']:.0e})")
    check(err_a64 <= LONG_TOL64["alpha"] and err_c64 <= LONG_TOL64["cost"],
          "purity float64: kernel solver differs from plain")
    return launches, ms_iter, plain_ms


def phase_unsupervised_path(problem32, card):
    import torch

    from demethify_tpu_torch import state
    from demethify_tpu_torch.solvers.api import unsupervised_deconv
    from demethify_tpu_torch.solvers.unsupervised import unsupervised_solve

    u0, a0 = unsupervised_init(N_CPG)
    u0, a0, y, d, _ = state.from_numpy(u0, a0, problem32[2], problem32[3],
                                       None, device=DEV,
                                       dtype=torch.float32)
    enqueue_ms = _enqueue_only_ms((u0, a0, y, d, None), 200)
    kw = dict(n_iter1=N_OUTER, n_iter2=N_INNER, tol=0.0, record_trace=True)
    unsupervised_deconv(y, d, U_N_U, init_provided=(u0, a0),
                        **dict(kw, n_iter1=5))                       # warm
    torch.cuda.synchronize()
    res, ms_iter, launches = _drive(
        "unsupervised", f"1M x 10, n_u={U_N_U}, float32, "
        f"{N_OUTER}x{N_INNER}, tol=0 via solvers.api.unsupervised_deconv, "
        f"card {card}",
        lambda: unsupervised_deconv(y, d, U_N_U, init_provided=(u0, a0),
                                    **kw), N_OUTER, enqueue_ms)
    check(expect_counts(launches, u_phase_grams=N_OUTER,
                        alpha_phase_full=N_OUTER),
          f"unsupervised launch counts {launches}")
    check(res.u.shape == (N_CPG, U_N_U)
          and res.proportions.shape == (U_N_U, N_S), "unsupervised shapes")
    check(float((res.proportions.sum(0) - 1).abs().max()) < 1e-4,
          "unsupervised alpha off simplex")
    n_plain = min(50, N_OUTER)
    (_, _, info_p), plain_ms = _per_iter_ms(
        lambda: unsupervised_solve(u0, a0, y, d, U_N_U,
                                   **dict(kw, n_iter1=n_plain)), n_plain)
    trace = res.trace.cpu().numpy()
    err_c = abs(float(info_p["cost"]) / trace[n_plain - 1] - 1)
    log(f"[unsupervised] plain solver, same workload, first {n_plain} "
        f"iterations: {plain_ms:.4f} ms per outer iteration; its cost at "
        f"{n_plain} vs the kernel solver's: rel diff {err_c:.3e} (tol "
        f"{TRAJ_TOL['float32']['cost']:.0e})")
    check(err_c <= TRAJ_TOL["float32"]["cost"], "unsupervised cost vs plain")
    return launches, ms_iter, plain_ms


def phase_restarts(problem32, card, k4_times):
    """Batched random restarts at full width through ``solvers.api``, each
    with the launch counters set to 0 just before and read just after,
    beside the sequential loop's figure (one single-member kernel solve of
    restart 0's init, shorter)."""
    import torch

    from demethify_tpu_torch import state
    from demethify_tpu_torch.solvers import fused
    from demethify_tpu_torch.solvers.api import (
        partial_reference_deconv, purity_deconv, restart_generators,
        restart_route, unsupervised_deconv)
    from demethify_tpu_torch.solvers.init import (
        init_partial, init_purity, init_unsupervised)

    _, _, y, d, Rt = state.from_numpy(*problem32, device=DEV,
                                      dtype=torch.float32)
    pur = state.purity_from_numpy(purity_draw(0), device=DEV,
                                  dtype=torch.float32)
    seed = 3
    cases = (
        ("partial-ref", N_U, 16, N_OUTER, N_INNER, "alpha_phase_full_multi",
         lambda **kw: partial_reference_deconv(y, d, Rt, N_U, **kw),
         lambda g: init_partial(g, "uniform_", y, d, Rt, N_U),
         lambda u, a, **kw: fused.partial_ref_solve_fused(u, a, y, d, Rt,
                                                          N_U, **kw)),
        ("purity", N_U, 8, P_OUTER, P_INNER, "fw_phase_full_multi",
         lambda **kw: purity_deconv(y, d, Rt, N_U, pur, **kw),
         lambda g: init_purity(g, "uniform_", y, d, Rt, N_U),
         lambda u, a, **kw: fused.purity_solve_fused(u, a, y, d, Rt, pur,
                                                     N_U, **kw)),
        ("unsupervised", U_N_U, 8, N_OUTER, N_INNER, "alpha_phase_full_multi",
         lambda **kw: unsupervised_deconv(y, d, U_N_U, **kw),
         lambda g: init_unsupervised(g, "uniform_", y, d, U_N_U),
         lambda u, a, **kw: fused.unsupervised_solve_fused(u, a, y, d, U_N_U,
                                                           **kw)))
    out = {}
    for name, n_u, n_r, n1, n2, glue, deconv, init, single in cases:
        check(restart_route(DEV, n_u, N_S, n_r) == "batch",
              f"{name}: restarts not routed to the batch")
        free = fused.free_device_bytes(DEV)
        n_ct = 0 if name == "unsupervised" else N_CT
        cap = fused.max_multi_members(N_CPG, N_S, n_ct, n_u, 4, 4, free)
        log(f"[restarts {name}] member cap {cap} at {free / 1e9:.2f} GB free")
        check(cap >= n_r, f"{name}: {n_r} restarts would run in chunks")
        kw = dict(n_iter1=n1, n_iter2=n2, tol=0.0, record_trace=True,
                  seed=seed, n_restarts=n_r)
        deconv(**dict(kw, n_iter1=2))                               # warm
        torch.cuda.synchronize()
        _, ms_iter, launches = _drive(
            f"restarts {name}", f"1M x 10, n_u={n_u}, {n_r} restarts, "
            f"float32, {n1}x{n2}, tol=0 via solvers.api, card {card}",
            lambda: deconv(**kw), n1)
        check(expect_counts(launches, u_phase_grams_multi=n1, **{glue: n1}),
              f"{name} restart launch counts {launches}")
        u0, a0 = init(restart_generators(seed, n_r, DEV)[0])
        n_seq = max(2, n1 // 10)
        _, seq_ms = _per_iter_ms(
            lambda: single(u0, a0, n_iter1=n_seq, n_iter2=n2, tol=0.0),
            n_seq)
        k4_ms = k4_times[name]
        log(f"[restarts {name}] {ms_iter / n_r:.4f} ms per outer iteration "
            f"per restart batched ({n_r} members) against {seq_ms:.4f} for "
            f"the sequential loop (one single-member kernel solve, "
            f"{n_seq} iterations) -> {seq_ms * n_r / ms_iter:.2f}x; K4 alone "
            f"at this shape {k4_ms:.4f} ms ({k4_ms / n_r:.4f} per member)")
        out[name] = {"restarts": n_r, "ms_per_iter": ms_iter,
                     "ms_per_iter_per_restart": ms_iter / n_r,
                     "sequential_ms_per_iter": seq_ms, "launches": launches}
    return out


def phase_bootstrap_parity():
    """bootstrap_ci on the card against bootstrap_ci on the CPU (the plain
    twins and solvers), float64, 20k sites, B = 4, with the same injected
    resample draws and inits, both layouts, three iterative modes."""
    import torch

    from demethify_tpu_torch import state
    from demethify_tpu_torch.uncertainty.bootstrap import bootstrap_ci

    n, n_b = 20_000, 4
    _, _, y, d, Rt = make_problem(np.float64, seed=3, n_cpg=n)
    purity = purity_draw(3)
    rng = np.random.default_rng(90)
    indices = rng.integers(0, n, size=(n_b, n))
    for name, n_u, R, pu, n1, n2 in (
            ("partial-ref", N_U, Rt, None, 30, N_INNER),
            ("purity", N_U, Rt, purity, 10, P_INNER),
            ("unsupervised", U_N_U, None, None, 30, N_INNER)):
        n_ct = 0 if R is None else N_CT
        u_b, a_b = _member_inits(n, n_b, n_ct, n_u, seed=90, purity=pu)
        inits = list(zip(u_b, a_b))
        for method in ("weights", "resample"):
            out = {}
            for dev in (DEV, "cpu"):
                _, _, yt, dt, Rtt = state.from_numpy(
                    None, None, y, d, R, device=dev, dtype=torch.float64)
                out[dev] = bootstrap_ci(
                    yt, dt, Rtt, n_u, level=90, n_bootstrap=n_b,
                    n_iter1=n1, n_iter2=n2, tol=0.0, method=method,
                    purity=pu, indices=indices, inits=inits)
            err = max(float(np.abs(a - b).max())
                      for a, b in zip(out[DEV], out["cpu"]))
            log(f"[bootstrap] {name} {method} B={n_b} {n1}x{n2} float64 "
                f"N={n}: card vs CPU with the same draws and inits, CI "
                f"bounds max|diff| {err:.3e} (tol 1e-8)")
            check(err <= 1e-8, f"bootstrap {name} {method}: card vs CPU")


def phase_bootstrap(problem32, card):
    """Bootstrap CIs at full width through ``bootstrap_ci``, each run with
    the launch counters set to 0 just before and read just after: the
    weights layout in the three iterative modes (K4 weighted + K5/K6 with
    per-member blocks) and the resample layout (K1 + K2 per replicate)."""
    import torch

    from demethify_tpu_torch import state
    from demethify_tpu_torch.solvers import fused
    from demethify_tpu_torch.uncertainty.bootstrap import (
        _percentiles, bootstrap_ci)

    _, _, y, d, Rt = state.from_numpy(*problem32, device=DEV,
                                      dtype=torch.float32)
    pur = state.purity_from_numpy(purity_draw(0), device=DEV,
                                  dtype=torch.float32)
    cases = (
        ("weights partial-ref", "weights", N_U, Rt, None, 32, N_OUTER,
         N_INNER, dict(u_phase_grams_multi=N_OUTER,
                       alpha_phase_full_multi=N_OUTER)),
        ("weights purity", "weights", N_U, Rt, pur, 8, P_OUTER, P_INNER,
         dict(u_phase_grams_multi=P_OUTER, fw_phase_full_multi=P_OUTER)),
        ("weights unsupervised", "weights", U_N_U, None, None, 8, N_OUTER,
         N_INNER, dict(u_phase_grams_multi=N_OUTER,
                       alpha_phase_full_multi=N_OUTER)),
        ("resample partial-ref", "resample", N_U, Rt, None, 4, 200,
         N_INNER, dict(u_phase_grams=800, alpha_phase_full=800)))
    out = {}
    for name, method, n_u, R, pu, n_b, n1, n2, want in cases:
        n_ct = 0 if R is None else N_CT
        p = n_ct + n_u
        if method == "weights":
            free = fused.free_device_bytes(DEV)
            cap = fused.max_multi_members(N_CPG, N_S, n_ct, n_u, 4, 4, free,
                                          weighted=True)
            log(f"[bootstrap {name}] member cap {cap} at {free / 1e9:.2f} "
                f"GB free")
            check(cap >= n_b, f"{name}: {n_b} replicates would run in "
                              f"chunks")

        def run(n_iter1, n_boot=n_b):
            return bootstrap_ci(y, d, R, n_u, level=95, n_bootstrap=n_boot,
                                n_iter1=n_iter1, n_iter2=n2, tol=0.0,
                                purity=pu, seed=5, method=method)

        run(2, 2)                                                  # warm
        # the fixed cost: draws, inits, weighted set-up, copies to the
        # host and percentiles, with 2 outer iterations
        _, fixed_ms = timed_ms(lambda: run(2))
        reset_counts()
        t0 = time.perf_counter()
        (lo_p, hi_p, lo_u, hi_u), ms = timed_ms(lambda: run(n1))
        wall = time.perf_counter() - t0
        launches = read_counts()
        per = ms / (n_b * n1)
        marginal = (ms - fixed_ms) / (n_b * (n1 - 2))
        # the host's share of the fixed cost: the percentiles of the
        # replicates' u, (B, n_cpg, n_u), in numpy
        u_all = np.random.default_rng(0).uniform(
            size=(n_b, N_CPG, n_u)).astype(np.float32)
        t0 = time.perf_counter()
        _percentiles(u_all, 95)
        pct_ms = (time.perf_counter() - t0) * 1e3
        log(f"[bootstrap {name}] 1M x 10, n_u={n_u}, B={n_b} replicates, "
            f"float32, {n1}x{n2}, tol=0 via uncertainty.bootstrap_ci, card "
            f"{card}: {ms:.1f} ms ({per:.4f} ms per replicate and outer "
            f"iteration, set-up and percentiles included), wall "
            f"{wall:.3f} s; the same with 2 outer iterations {fixed_ms:.1f} "
            f"ms (of which the host's percentiles of u {pct_ms:.1f} ms), so "
            f"{marginal:.4f} ms per replicate and further outer iteration; "
            f"launches {launches}")
        check(expect_counts(launches, **want),
              f"{name}: launch counts {launches} != {want}")
        check(lo_p.shape == hi_p.shape == (p, N_S)
              and lo_u.shape == hi_u.shape == (N_CPG, n_u),
              f"{name}: CI shapes")
        check(np.isfinite(lo_p).all() and np.isfinite(hi_u).all()
              and (lo_p <= hi_p).all() and (lo_u <= hi_u).all()
              and lo_p.min() >= 0 and hi_p.max() <= 1 + 1e-6
              and lo_u.min() >= 0 and hi_u.max() <= 1,
              f"{name}: CI bounds out of order or range")
        out[name] = {"ms_per_rep_iter": per, "marginal": marginal,
                     "launches": launches}
    w, r = out["weights partial-ref"], out["resample partial-ref"]
    log(f"[bootstrap] per replicate and outer iteration, all in (further "
        f"iterations): weights layout {w['ms_per_rep_iter']:.4f} "
        f"({w['marginal']:.4f}) ms at B = 32 against "
        f"{r['ms_per_rep_iter']:.4f} ({r['marginal']:.4f}) for the resample "
        f"layout (sequential single solves)")
    return out


def _load_and_solve(problem, dtype, solve):
    """from_numpy of ``problem`` in ``dtype`` storage, then ``solve(t)``:
    (what solve returns, the MB the loaded data hold on the device, the
    solve's peak MB above them)."""
    import gc

    import torch

    from demethify_tpu_torch import state

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t = state.from_numpy(*problem, device=DEV, dtype=dtype)
    torch.cuda.synchronize()
    loaded = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = solve(t)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return out, (loaded - base) / 1e6, (peak - loaded) / 1e6


def phase_bf16_paths(problem32, card):
    """The paths with bf16 storage at full width, each with the launch
    counters set to 0 just before and read just after: the main path beside
    the float32 run from the same init in this process (ms per outer
    iteration, peak device memory); the bf16_compute form through
    ``fused.partial_ref_solve_fused``; the purity and unsupervised paths;
    16 batched restarts; the weights bootstrap at B = 32. Alpha on bf16
    storage is held to the JAX package's own bf16 bounds (max|d alpha| <
    0.05 against the float32 solve from the same init, column sums within
    1e-3) after the main path's 1000 x 20, and both forms to
    BF16_SHORT_TOL at that test's schedule, 30 x 5, here at full width.
    bf16_compute's alpha after 1000 x 20 is reported with its column
    sums held: it drifts along the objective's flat direction, as two
    float32 solvers drift apart there (the port's and the JAX package's
    float32 solves differ by 0.11 after 1000 x 20 on 200k sites of this
    workload on a CPU, ``python -m tests.test_torch_bf16 200000 1000``)."""
    import torch

    from demethify_tpu_torch import state
    from demethify_tpu_torch.solvers import fused
    from demethify_tpu_torch.solvers.api import (
        partial_reference_deconv, purity_deconv, unsupervised_deconv)
    from demethify_tpu_torch.uncertainty.bootstrap import bootstrap_ci

    bf16 = torch.bfloat16
    kw = dict(n_iter1=N_OUTER, n_iter2=N_INNER, tol=0.0, record_trace=True)
    out = {}
    for name, dtype in (("float32", torch.float32), ("bf16", bf16)):
        def main_run(t):
            u0, a0, y, d, Rt = t
            partial_reference_deconv(y, d, Rt, N_U, init_provided=(u0, a0),
                                     **dict(kw, n_iter1=5))        # warm
            torch.cuda.synchronize()
            return _drive(
                f"{name} main", f"1M x 10, 5+1, {name} storage, "
                f"{N_OUTER}x{N_INNER}, tol=0 via "
                f"solvers.api.partial_reference_deconv, card {card}",
                lambda: partial_reference_deconv(
                    y, d, Rt, N_U, init_provided=(u0, a0), **kw), N_OUTER)
        (res, ms_iter, launches), data_mb, peak_mb = _load_and_solve(
            problem32, dtype, main_run)
        k1 = "u_phase_grams" + ("[bf16]" if dtype == bf16 else "")
        check(expect_counts(launches, **{k1: N_OUTER,
                                         "alpha_phase_full": N_OUTER}),
              f"{name} main path launches {launches}")
        log(f"[{name} main] device memory: data {data_mb:.1f} MB, the "
            f"solve's peak above it {peak_mb:.1f} MB, together "
            f"{data_mb + peak_mb:.1f} MB (torch.cuda.max_memory_allocated)")
        out[name] = {"ms_per_iter": ms_iter, "launches": launches,
                     "data_mb": data_mb, "peak_mb": peak_mb,
                     "alpha": res.proportions.float()}
    a32, a16 = out["float32"]["alpha"], out["bf16"]["alpha"]
    err_a = float((a16 - a32).abs().max())
    err_s = float((a16.sum(0) - 1).abs().max())
    log(f"[bf16 main] {out['bf16']['ms_per_iter']:.4f} ms per outer "
        f"iteration against float32 {out['float32']['ms_per_iter']:.4f} "
        f"({out['bf16']['ms_per_iter'] / out['float32']['ms_per_iter']:.3f}"
        f"x); peak device memory (data + solve) "
        f"{out['bf16']['data_mb'] + out['bf16']['peak_mb']:.1f} MB against "
        f"{out['float32']['data_mb'] + out['float32']['peak_mb']:.1f} MB; "
        f"alpha vs the float32 solve after {N_OUTER}x{N_INNER} max|diff| "
        f"{err_a:.3e} (tol 5e-2), column sums within {err_s:.1e} of 1 (tol "
        f"1e-3)")
    check(err_a < 5e-2 and err_s < 1e-3,
          "bf16 main path: alpha vs the float32 solve")

    u0, a0, y, d, Rt = state.from_numpy(*problem32, device=DEV, dtype=bf16)
    fused.partial_ref_solve_fused(u0, a0, y, d, Rt, N_U,
                                  **dict(kw, n_iter1=5), bf16_compute=True)
    torch.cuda.synchronize()
    reset_counts()
    (_, a_c, info), ms = timed_ms(lambda: fused.partial_ref_solve_fused(
        u0, a0, y, d, Rt, N_U, bf16_compute=True, **kw))
    launches = read_counts()
    err_c = float((a_c - a32).abs().max())
    err_cs = float((a_c.sum(0) - 1).abs().max())
    trace = info["trace"].cpu().numpy()
    log(f"[bf16_compute main] 1M x 10, 5+1, {N_OUTER}x{N_INNER}, tol=0 via "
        f"solvers.fused.partial_ref_solve_fused(bf16_compute=True), card "
        f"{card}: {ms / N_OUTER:.4f} ms per outer iteration; alpha vs the "
        f"float32 solve max|diff| {err_c:.3e} (drift, not held), column "
        f"sums within {err_cs:.1e} of 1 (tol 1e-3); launches {launches}")
    check(expect_counts(launches, **{"u_phase_grams[bf16_compute]": N_OUTER,
                                     "alpha_phase_full": N_OUTER}),
          f"bf16_compute launches {launches}")
    check(info["n_iter"] == N_OUTER and np.isfinite(trace).all()
          and trace[-1] < trace[0] and err_cs < 1e-3,
          "bf16_compute main path")
    out["bf16_compute"] = {"ms_per_iter": ms / N_OUTER, "launches": launches}

    # the JAX package's own bf16 test (tests/test_solvers.py,
    # TestBfloat16Storage) at its schedule, here at full width
    jkw = dict(n_iter1=30, n_iter2=5, tol=0.0)
    t32 = state.from_numpy(*problem32, device=DEV, dtype=torch.float32)
    a_ref = fused.partial_ref_solve_fused(*t32, N_U, **jkw)[1]
    for form, extra in (("bf16", {}), ("bf16_compute",
                                       {"bf16_compute": True})):
        a_f = fused.partial_ref_solve_fused(u0, a0, y, d, Rt, N_U, **jkw,
                                            **extra)[1]
        err_f = float((a_f - a_ref).abs().max())
        err_fs = float((a_f.sum(0) - 1).abs().max())
        log(f"[{form} 30x5] 1M x 10, 5+1, the JAX package's bf16 test at its "
            f"schedule: alpha vs the float32 solve max|diff| {err_f:.3e} (tol "
            f"{BF16_SHORT_TOL['alpha']:.0e}), column sums within "
            f"{err_fs:.1e} of 1 (tol {BF16_SHORT_TOL['sum']:.0e})")
        check(err_f < BF16_SHORT_TOL["alpha"]
              and err_fs < BF16_SHORT_TOL["sum"],
              f"{form}: alpha vs float32 at 30 x 5")

    pur = state.purity_from_numpy(purity_draw(0), device=DEV, dtype=bf16)
    pkw = dict(n_iter1=P_OUTER, n_iter2=P_INNER, tol=0.0, record_trace=True)
    purity_deconv(y, d, Rt, N_U, pur, init_provided=(u0, a0),
                  **dict(pkw, n_iter1=2))                            # warm
    torch.cuda.synchronize()
    res, ms_iter, launches = _drive(
        "bf16 purity", f"1M x 10, 5+1, bf16 storage, {P_OUTER}x{P_INNER}, "
        f"tol=0 via solvers.api.purity_deconv, card {card}",
        lambda: purity_deconv(y, d, Rt, N_U, pur, init_provided=(u0, a0),
                              **pkw), P_OUTER)
    check(expect_counts(launches, **{"u_phase_grams[bf16]": P_OUTER,
                                     "fw_phase_full": P_OUTER}),
          f"bf16 purity launches {launches}")
    err_m = float((res.proportions[:N_CT].sum(0) - pur.float()).abs().max())
    log(f"[bf16 purity] known-block mass - bf16 purity: max {err_m:.3e} "
        f"(tol 1e-5)")
    check(err_m <= 1e-5, "bf16 purity: known-block mass off the purity")
    out["purity"] = {"ms_per_iter": ms_iter, "launches": launches}

    uu0, ua0 = unsupervised_init(N_CPG)
    uu0, ua0, _, _, _ = state.from_numpy(uu0, ua0, problem32[2], problem32[3],
                                         None, device=DEV, dtype=bf16)
    unsupervised_deconv(y, d, U_N_U, init_provided=(uu0, ua0),
                        **dict(kw, n_iter1=5))                       # warm
    torch.cuda.synchronize()
    _, ms_iter, launches = _drive(
        "bf16 unsupervised", f"1M x 10, n_u={U_N_U}, bf16 storage, "
        f"{N_OUTER}x{N_INNER}, tol=0 via solvers.api.unsupervised_deconv, "
        f"card {card}",
        lambda: unsupervised_deconv(y, d, U_N_U, init_provided=(uu0, ua0),
                                    **kw), N_OUTER)
    check(expect_counts(launches, **{"u_phase_grams[bf16]": N_OUTER,
                                     "alpha_phase_full": N_OUTER}),
          f"bf16 unsupervised launches {launches}")
    out["unsupervised"] = {"ms_per_iter": ms_iter, "launches": launches}

    n_r = 16
    free = fused.free_device_bytes(DEV)
    cap = fused.max_multi_members(N_CPG, N_S, N_CT, N_U, 4, 2, free)
    log(f"[bf16 restarts] member cap {cap} at {free / 1e9:.2f} GB free "
        f"(float32 storage: "
        f"{fused.max_multi_members(N_CPG, N_S, N_CT, N_U, 4, 4, free)})")
    rkw = dict(kw, seed=3, n_restarts=n_r)
    partial_reference_deconv(y, d, Rt, N_U, **dict(rkw, n_iter1=2))  # warm
    torch.cuda.synchronize()
    _, ms_iter, launches = _drive(
        "bf16 restarts", f"1M x 10, 5+1, {n_r} restarts, bf16 storage, "
        f"{N_OUTER}x{N_INNER}, tol=0 via solvers.api, card {card}",
        lambda: partial_reference_deconv(y, d, Rt, N_U, **rkw), N_OUTER)
    check(expect_counts(launches, **{"u_phase_grams_multi[bf16]": N_OUTER,
                                     "alpha_phase_full_multi": N_OUTER}),
          f"bf16 restart launches {launches}")
    out["restarts"] = {"ms_per_iter": ms_iter, "launches": launches,
                       "restarts": n_r}

    n_b = 32

    def boot(n_iter1, n_boot=n_b):
        return bootstrap_ci(y, d, Rt, N_U, level=95, n_bootstrap=n_boot,
                            n_iter1=n_iter1, n_iter2=N_INNER, tol=0.0,
                            seed=5, method="weights")

    boot(2, 2)                                                      # warm
    _, fixed_ms = timed_ms(lambda: boot(2))
    reset_counts()
    (lo_p, hi_p, lo_u, hi_u), ms = timed_ms(lambda: boot(N_OUTER))
    launches = read_counts()
    marginal = (ms - fixed_ms) / (n_b * (N_OUTER - 2))
    log(f"[bf16 bootstrap] weights layout, 1M x 10, 5+1, B={n_b}, bf16 "
        f"storage, {N_OUTER}x{N_INNER}, tol=0 via uncertainty.bootstrap_ci, "
        f"card {card}: {ms:.1f} ms ({ms / (n_b * N_OUTER):.4f} ms per "
        f"replicate and outer iteration, all in), {marginal:.4f} ms per "
        f"replicate and further outer iteration; launches {launches}")
    check(expect_counts(launches, **{"u_phase_grams_multi[bf16]": N_OUTER,
                                     "alpha_phase_full_multi": N_OUTER}),
          f"bf16 bootstrap launches {launches}")
    check(np.isfinite(lo_p).all() and (lo_p <= hi_p).all()
          and (lo_u <= hi_u).all(), "bf16 bootstrap intervals")
    out["bootstrap"] = {"ms_per_rep_iter": ms / (n_b * N_OUTER),
                        "marginal": marginal, "launches": launches}
    return out


# ---------------------------------------------------------------- phase 8
def _write_fixture(root, seed=7):
    n = N_CLI
    rng = np.random.default_rng(seed)
    R = rng.uniform(size=(n, N_CT + 1))
    alpha = rng.dirichlet(np.ones(N_CT + 1), size=N_S).T
    cov = rng.poisson(30, size=(n, N_S)) + 1
    meth = np.clip(R @ alpha + 0.01 * rng.normal(size=(n, N_S)), 0, 1)
    pos = np.arange(n)
    ref = os.path.join(root, "ref.bed")
    with open(ref, "w") as f:
        f.write("chrom\tstart\tend\t"
                + "\t".join(f"celltype{c + 1}" for c in range(N_CT)) + "\n")
        np.savetxt(f, np.column_stack([pos, pos + 1, R[:, :N_CT]]),
                   fmt=["chr1\t%d", "%d"] + ["%.6f"] * N_CT,
                   delimiter="\t")
    samples = []
    for s in range(N_S):
        path = os.path.join(root, f"sample{s + 1}.bed")
        with open(path, "w") as f:
            f.write("chrom\tstart\tend\tvalid_coverage\tcount_modified\t"
                    "percent_modified\n")
            np.savetxt(f, np.column_stack(
                [pos, pos + 1, cov[:, s], np.rint(meth[:, s] * cov[:, s]),
                 100 * meth[:, s]]),
                fmt=["chr1\t%d", "%d", "%d", "%d", "%.4f"], delimiter="\t")
        samples.append(path)
    return samples, ref


def _read_csv(path):
    with open(path) as f:
        header = f.readline().strip().split(",")
        rows = [ln.strip().split(",") for ln in f if ln.strip()]
    return header, rows


def _read_ci(path, index=True):
    """A confidence-interval CSV ("(lo, hi)" cells) -> (lower, upper)."""
    import csv

    with open(path, newline="") as f:
        rows = list(csv.reader(f))[1:]
    cells = [r[1:] if index else r for r in rows]
    pairs = np.array([[[float(x) for x in c.strip("()").split(",")]
                       for c in r] for r in cells])
    return pairs[..., 0], pairs[..., 1]


def phase_cli():
    """The CLI in float32 storage (the default) and with ``--dtype
    bfloat16``, whose runs must launch the bf16 forms of K1 and K4."""
    from demethify_tpu_torch.cli import main as cli_main

    percent = [float(p) for p in np.linspace(10, 70, N_S)]
    modes = (
        ("supervised", True, [], N_CT),
        ("partial-ref", True, ["--nbunknown", "1", "--iterations", "500",
                               "20"], N_CT + 1),
        ("purity", True, ["--nbunknown", "1", "--purity",
                          *(f"{p:g}" for p in percent)], N_CT + 1),
        ("unsupervised", False, ["--nbunknown", str(U_N_U), "--iterations",
                                 "500", "20"], U_N_U))
    with tempfile.TemporaryDirectory() as root:
        samples, ref = _write_fixture(root)
        for storage in ("float32", "bfloat16"):
            _cli_runs(cli_main, root, samples, ref, modes, percent, storage)


def _cli_runs(cli_main, root, samples, ref, modes, percent, storage):
    """The four modes, ``--restart 4`` and ``--confidence 95 8`` in both
    layouts, with ``--dtype storage``, checking the launches of each."""
    import torch

    sfx = "" if storage == "float32" else "[bf16]"
    k1, k4 = "u_phase_grams" + sfx, "u_phase_grams_multi" + sfx
    other = "u_phase_grams" + ("[bf16]" if not sfx else "")
    dflag = ["--dtype", storage]
    for mode, with_ref, extra, n_rows in modes:
        before = read_counts()
        outdir = os.path.join(root, f"{mode}-{storage}")
        t0 = time.perf_counter()
        rc = cli_main(["--methfreq", *samples, "--bedmethyl",
                       "--noprint", "--outdir", outdir, "--device", DEV,
                       *dflag, *(["--ref", ref] if with_ref else []),
                       *extra])
        wall = time.perf_counter() - t0
        check(rc == 0, f"CLI {mode} exit {rc}")
        header, rows = _read_csv(
            os.path.join(outdir, "celltypes_proportions.csv"))
        props = np.array([[float(x) for x in r[1:]] for r in rows])
        labels = [r[0] for r in rows]
        check(header[0] == "Cell types" and len(header) == N_S + 1,
              "CLI header")
        check(props.shape == (n_rows, N_S), f"CLI {mode} shape")
        check(np.abs(props.sum(axis=0) - 1).max() <= 1e-5,
              f"CLI {mode} proportions do not sum to 1")
        moved = {k: v - before[k] for k, v in read_counts().items()}
        if mode != "supervised":
            prof_header, prof = _read_csv(os.path.join(
                outdir, "methylation_profile_estimate.csv"))
            check(len(prof) == N_CLI, f"CLI {mode} profile rows")
            check(moved[k1] > 0 and moved[other] == 0,
                  f"CLI {mode} {storage} launches {moved}")
        if mode == "purity":
            check(moved["fw_phase_full"] > 0, "CLI purity launched no K3")
            # the known-block mass, in the storage dtype (the CSV keeps
            # six digits)
            mass = torch.tensor(1 - np.asarray(percent) / 100).to(
                getattr(torch, storage)).double().numpy()
            check(np.abs(props[:N_CT].sum(0) - mass).max() <= 1e-5,
                  "CLI purity: known mass != 1 - p/100")
        if mode == "unsupervised":
            want = [f"unknown_cell_{i + 1}" for i in range(U_N_U)]
            check(labels == want and len(prof_header) == U_N_U,
                  f"CLI unsupervised labels {labels}")
            check(moved["alpha_phase_full"] > 0,
                  "CLI unsupervised launched no K2")
        log(f"[cli] {mode} {storage}: exit 0 in {wall:.2f} s, proportions "
            f"{props.shape} column sums within "
            f"{np.abs(props.sum(axis=0) - 1).max():.1e} of 1, launches "
            f"{moved}")
    # --restart 4 on the card: the batched kernels, not K1
    for mode, with_ref, extra, n_rows in modes[1:]:
        before = read_counts()
        outdir = os.path.join(root, f"{mode}-restart-{storage}")
        t0 = time.perf_counter()
        rc = cli_main(["--methfreq", *samples, "--bedmethyl",
                       "--noprint", "--outdir", outdir, "--device", DEV,
                       "--restart", "4", *dflag,
                       *(["--ref", ref] if with_ref else []), *extra])
        wall = time.perf_counter() - t0
        check(rc == 0, f"CLI {mode} --restart 4 exit {rc}")
        _, rows = _read_csv(
            os.path.join(outdir, "celltypes_proportions.csv"))
        props = np.array([[float(x) for x in r[1:]] for r in rows])
        check(props.shape == (n_rows, N_S)
              and np.abs(props.sum(axis=0) - 1).max() <= 1e-5,
              f"CLI {mode} --restart 4 proportions")
        moved = {k: v - before[k] for k, v in read_counts().items()}
        check(moved[k4] > 0 and moved[k1] == 0,
              f"CLI {mode} --restart 4 launches {moved}")
        log(f"[cli] {mode} {storage} --restart 4: exit 0 in {wall:.2f} s, "
            f"launches {moved}")
    # --confidence 95 8 on the card, both layouts, all four modes
    for mode, with_ref, extra, n_rows in modes:
        for cimethod in ("resample", "weights"):
            before = read_counts()
            outdir = os.path.join(root, f"{mode}-ci-{cimethod}-{storage}")
            t0 = time.perf_counter()
            rc = cli_main(["--methfreq", *samples, "--bedmethyl",
                           "--noprint", "--outdir", outdir, "--device",
                           DEV, "--confidence", "95", "8", "--cimethod",
                           cimethod, *dflag,
                           *(["--ref", ref] if with_ref else []), *extra])
            wall = time.perf_counter() - t0
            check(rc == 0, f"CLI {mode} --confidence exit {rc}")
            lo, hi = _read_ci(os.path.join(
                outdir, "confidence_interval_celltypes_proportions.csv"))
            check(lo.shape == (n_rows, N_S) and (lo <= hi).all()
                  and lo.min() >= 0 and hi.max() <= 1 + 1e-6,
                  f"CLI {mode} --confidence proportion intervals")
            if mode != "supervised":
                ulo, uhi = _read_ci(os.path.join(
                    outdir, "confidence_interval_methylation_estimate.csv"),
                    index=False)
                check(ulo.shape == (N_CLI, n_rows - (N_CT if with_ref
                                                      else 0))
                      and (ulo <= uhi).all(),
                      f"CLI {mode} --confidence profile intervals")
            moved = {k: v - before[k] for k, v in read_counts().items()}
            if mode != "supervised":
                batched = moved[k4] > 0
                check(batched == (cimethod == "weights")
                      and moved[k1] + moved[k4] > 0,
                      f"CLI {mode} --cimethod {cimethod} launches "
                      f"{moved}")
            log(f"[cli] {mode} {storage} --confidence 95 8 --cimethod "
                f"{cimethod}: "
                f"exit 0 in {wall:.2f} s, intervals {lo.shape}, launches "
                f"{moved}")


# ------------------------------------------------------ parent/change timing
# ------------------------------------------------------------ phase 9
# The envelope: the shapes the kernels once refused (wide n_s, n_u > 8,
# p > 32, bf16_compute in the direct form, the weights bootstrap in the
# direct form), the row masks and Rt folded into the data block.
# K1 and K4 against their twins at n_s in {64, 128, 256, 500} with
# 25 + 4 and n_s = 256 with 5 + 1, in float32, float64 and bf16 storage
WIDE_SHAPES = ((64, 25, 4), (128, 25, 4), (256, 25, 4), (500, 25, 4),
               (256, 5, 1))
N_WIDE = 200_000
# the cohort path: 1M sites x 100 samples against the 25-type panel
COHORT = (1_000_000, 100, 25, 4)


def phase_layouts():
    """Each kernel's shared-memory plan in Python against the ``*_smem``
    exports of its sources (``cuda_kernels.u_phase_smem``,
    ``cuda_small.glue_smem``), over a grid of shapes in both layouts."""
    from demethify_tpu_torch.ops import _build
    from demethify_tpu_torch.ops.cuda_kernels import SMEM_LIMIT, u_phase_smem
    from demethify_tpu_torch.ops.cuda_small import glue_smem

    lib = _build.load().lib
    bad, n_checked = [], 0
    for itemsize in (4, 8):
        for n_s in (1, 2, 6, 10, 64, 88, 100, 107, 108, 189, 190, 217, 218,
                    256, 500, 512):
            for n_ct, n_u in ((0, 1), (0, 3), (5, 1), (5, 2), (25, 4),
                              (25, 9), (25, 16), (60, 4)):
                for layout in ("resident", "wide"):
                    sfx = "" if layout == "resident" else "_wide"
                    k1 = getattr(lib, f"dm_u_phase_grams{sfx}_smem")
                    k4 = getattr(lib, f"dm_u_phase_grams_multi{sfx}_smem")
                    for direct in (False, True):
                        for bf16c in (False, True):
                            want = k1(itemsize, n_s, n_ct, n_u, int(direct),
                                      int(bf16c))
                            got = u_phase_smem(layout, itemsize, n_s, n_ct,
                                               n_u, direct, bf16c)
                            n_checked += 1
                            if want != got:
                                bad.append(("K1", layout, itemsize, n_s,
                                            n_ct, n_u, direct, bf16c))
                    for weighted in (False, True):
                        want = k4(itemsize, n_s, n_ct, n_u, int(weighted))
                        got = u_phase_smem(layout, itemsize, n_s, n_ct, n_u,
                                           weighted=weighted)
                        n_checked += 1
                        if want != got:
                            bad.append(("K4", layout, itemsize, n_s, n_ct,
                                        n_u, weighted))
        for p in (1, 6, 32, 33, 40, 64, 100, 170, 200):
            for n_s in (1, 10, 100):
                n_warps, smem = glue_smem(itemsize, p, n_s)
                want = lib.dm_glue_smem(itemsize, p, n_s)
                n_checked += 1
                if want != smem:
                    bad.append(("glue", itemsize, p, n_s, want, smem))
    log(f"[layouts] {n_checked} shared-memory plans: Python against the "
        f"kernels' *_smem exports, {len(bad)} differ {bad[:5]}; the card's "
        f"limit {SMEM_LIMIT} bytes")
    check(not bad, "shared-memory plans differ from the kernels'")


@contextlib.contextmanager
def forced_layout(layout):
    """K1 and K4 launch in ``layout`` ("resident" or "wide") inside the
    block, whatever ``cuda_kernels.u_phase_layout`` would plan (the shape
    must fit that layout's shared memory)."""
    from demethify_tpu_torch.ops import cuda_kernels

    plan = cuda_kernels.u_phase_layout

    def forced(name, itemsize, n_s, n_ct, n_u, direct=False, bf16c=False,
               weighted=False):
        return layout, cuda_kernels.u_phase_smem(
            layout, itemsize, n_s, n_ct, n_u, direct, bf16c, weighted)

    cuda_kernels.u_phase_layout = forced
    try:
        yield
    finally:
        cuda_kernels.u_phase_layout = plan


def _layout_bits(n, n_s, n_ct, n_u, dtype_name, n_b=0, data=None, seed=50,
                 steps=N_INNER):
    """K1 (n_b = 0) or K4 (n_b members) in the resident layout and in the
    wide layout forced, at a shape both take: the same bits?"""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import u_phase_grams
    from demethify_tpu_torch.ops.cuda_multi import u_phase_grams_multi

    dtype = getattr(torch, dtype_name)
    if n_b:
        ydt, rtt, alpha, uut, scal = _multi_inputs(n, n_s, n_ct, n_u, n_b,
                                                   dtype, seed)
        a1, a2 = alpha[:, :n_ct], alpha[:, n_ct:]
        fn = u_phase_grams_multi
    else:
        ydt, rtt, alpha, uut, scal = _k1_inputs(n, n_s, n_ct, n_u, dtype,
                                                seed)
        a1, a2 = alpha[:n_ct], alpha[n_ct:]
        fn = u_phase_grams
    if data is not None:
        ydt, rtt = ydt.to(getattr(torch, data)), rtt.to(getattr(torch, data))
    outs = []
    for layout in ("resident", "wide"):
        u, sc = uut.clone(), scal.clone()
        with forced_layout(layout):
            outs.append((u, sc, *fn(ydt, rtt, a1, a2, u, sc, steps)))
    same = all(torch.equal(x, y) for x, y in zip(*outs))
    log(f"[layouts] {'K4 B=' + str(n_b) if n_b else 'K1'} N={n} n_s={n_s} "
        f"n_ct={n_ct} n_u={n_u} {dtype_name} state, "
        f"{str(ydt.dtype)[6:]} data: wide layout forced bit-identical to "
        f"the resident layout: {same}")
    check(same, "the wide layout differs from the resident layout")
    return same


def phase_narrow_bits():
    """At the shapes the kernels took before the wide layout, the plan is
    the resident layout (the kernel's one layout then) unless the wide one
    fits at least twice its blocks per SM (``cuda_kernels.u_phase_layout``)
    -- and the wide layout gives the resident one's bits, at the main
    path's shape (which plans resident) and at shapes that plan wide."""
    from demethify_tpu_torch.ops.cuda_kernels import (
        SMEM_LIMIT, blocks_per_sm, gram_form, u_phase_layout, u_phase_smem)

    n_shapes, n_wide = 0, 0
    for itemsize in (4, 8):
        for n_s in range(1, 513):
            for n_ct, n_u in ((0, 3), (5, 1), (5, 2), (25, 4), (25, 8)):
                direct = not gram_form(n_u, n_s)
                p = n_ct + n_u
                for x_rows in (0, n_u):
                    old = itemsize * ((2 * n_s + p + (n_s if direct else 0)
                                       + x_rows) * 129 + p * n_s)
                    if old > SMEM_LIMIT or (x_rows and direct):
                        continue
                    bf16c = bool(x_rows) and itemsize == 4
                    weighted = bool(x_rows) and itemsize == 8
                    layout, _ = u_phase_layout("K1", itemsize, n_s, n_ct,
                                               n_u, direct, bf16c, weighted)
                    wide = u_phase_smem("wide", itemsize, n_s, n_ct, n_u,
                                        direct, bf16c, weighted)
                    want = ("wide" if not direct and blocks_per_sm(wide)
                            >= 2 * blocks_per_sm(old) else "resident")
                    n_shapes += 1
                    n_wide += layout == "wide"
                    check(layout == want,
                          f"a shape of the old layout plans {layout}")
    log(f"[layouts] {n_shapes} shapes that the single layout took before "
        f"the wide one existed: {n_shapes - n_wide} plan the resident "
        f"layout, {n_wide} the wide one (at least twice the blocks per SM)")
    main = _layout_bits(N_CPG, N_S, N_CT, N_U, "float32")
    _layout_bits(N_WIDE, 64, 25, 4, "float64", seed=51)
    _layout_bits(N_WIDE, 100, 25, 4, "float32", data="bfloat16", seed=52)
    _layout_bits(N_WIDE, 100, 5, 1, "float32", seed=55)
    _layout_bits(N_WIDE, N_S, N_CT, N_U, "float32", n_b=4, seed=53)
    _layout_bits(N_WIDE, 64, 25, 12, "float64", seed=54)
    return main


def phase_wide_kernels():
    """K1 and K4 (B = 4, one member inactive) against their twins at the
    wide shapes, each storage; the one-off K1 launch at 1M x 500,
    25 + 4, float64 with its partial buffer. Returns the timed cases of
    n_s = 500, 25 + 4, float64 (the JSON rows of the wide forms)."""
    out = {}
    for n_s, n_ct, n_u in WIDE_SHAPES:
        for dt, data in (("float32", None), ("float64", None),
                         ("float32", "bfloat16")):
            tag = f"[wide n_s={n_s} {n_ct}+{n_u} {data or dt}]"
            k1 = _k1_case(N_WIDE, n_u, dt, n_s=n_s, n_ct=n_ct, data=data,
                          seed=60 + n_s, timed=True, inner=1, reps=3,
                          label=tag)
            k4 = _k4_case(n_u, dt, 4, N_INNER, n_ct=n_ct, inactive=(1,),
                          seed=61 + n_s, timed=True, label=tag, data=data,
                          n=N_WIDE, n_s=n_s, quick=True)
            out[(n_s, n_ct, n_u, data or dt)] = (k1, k4)
    return out


def phase_partial_buffer():
    """One K1 launch at 1M sites x 500 samples, 25 + 4, float64 (Y + D
    8 GB): its partial buffer, time and bound."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import (
        A_U, L_W, L_W_PREV, N_SCAL, SITES_PER_BLOCK, gram_entries,
        u_phase_grams, u_phase_layout)

    n, n_s, n_ct, n_u = 1_000_000, 500, 25, 4
    g = torch.Generator(device=DEV).manual_seed(70)
    f64 = torch.float64
    ydt = torch.rand((2 * n_s, n), generator=g, device=DEV, dtype=f64)
    ydt[n_s:] = torch.floor(ydt[n_s:] * 100) + 1
    rtt = torch.rand((n_ct, n), generator=g, device=DEV, dtype=f64)
    e = torch.empty((n_ct + n_u, n_s), device=DEV, dtype=f64).exponential_(
        generator=g)
    alpha = e / e.sum(0)
    uut = torch.rand((2 * n_u, n), generator=g, device=DEV, dtype=f64)
    scal = torch.zeros(N_SCAL, device=DEV, dtype=f64)
    scal[A_U], scal[L_W] = 1.5, float(torch.sum(alpha[-n_u:] ** 2)) * 1e4
    scal[L_W_PREV] = scal[L_W]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    (gu, bu, usq), ms = timed_ms(lambda: u_phase_grams(
        ydt, rtt, alpha[:n_ct].contiguous(), alpha[n_ct:].contiguous(), uut,
        scal, N_INNER))
    peak = torch.cuda.max_memory_allocated() - base
    partial = 8 * gram_entries(n_s, n_ct, n_u) * -(-n // SITES_PER_BLOCK)
    yd = ydt.numel() * 8
    layout = u_phase_layout("K1", 8, n_s, n_ct, n_u)[0]
    b_ms, b_by = bound(*u_phase_work(n, n_s, n_ct, n_u, N_INNER, 8, 8),
                       "float64")
    finite = bool(torch.isfinite(gu).all() and torch.isfinite(bu).all()
                  and torch.isfinite(usq))
    log(f"[partial buffer] K1 at N={n} n_s={n_s} 25+4 float64 ({layout} "
        f"layout): one launch {ms:.2f} ms (bound {b_ms:.3f} ms, {b_by}); "
        f"partial buffer {partial / 1e9:.3f} GB against Y + D "
        f"{yd / 1e9:.3f} GB ({partial / yd:.3f} of it); the launch's peak "
        f"device memory above its inputs {peak / 1e9:.3f} GB; outputs "
        f"finite: {finite}")
    check(partial <= 0.5 * yd, "K1's partial buffer exceeds half of Y + D")
    check(finite, "K1 at 1M x 500: non-finite Grams")
    return {"partial_bytes": partial, "yd_bytes": yd, "ms": ms}


def phase_state_cols():
    """n_u in {9, 12, 16} (the state in scratch columns) in K1 (gram form
    at n_s = 100, direct at n_s = 10 and, in the wide layout, at
    n_s = 80 with 25 + 16) and K4 (B = 4), float64; n_u = 12 in float32.
    Returns K1's and K4's timed n_u = 12 cases."""
    timed = timed4 = None
    for n_u in (9, 12, 16):
        r = _k1_case(N_WIDE, n_u, "float64", n_s=100, n_ct=5, seed=80 + n_u,
                     timed=n_u == 12, inner=1, reps=3,
                     label="[n_u>8 gram]")
        timed = r if n_u == 12 else timed
        _k1_case(N_WIDE, n_u, "float64", n_s=10, n_ct=5, seed=81 + n_u,
                 label="[n_u>8 direct]")
        r4 = _k4_case(n_u, "float64", 4, N_INNER, n_ct=5, inactive=(2,),
                      seed=82 + n_u, label="[n_u>8]", n=N_WIDE, n_s=100,
                      timed=n_u == 12, quick=True)
        timed4 = r4 if n_u == 12 else timed4
    _k1_case(N_WIDE, 16, "float64", n_s=80, n_ct=25, seed=97,
             label="[n_u>8 direct, wide]")
    _k1_case(N_WIDE, 12, "float32", n_s=100, n_ct=5, seed=98,
             label="[n_u>8 gram]")
    _k1_case(N_WIDE, 12, "float32", n_s=10, n_ct=5, seed=99,
             label="[n_u>8 direct]")
    _k4_case(12, "float32", 4, N_INNER, n_ct=5, inactive=(2,), seed=100,
             label="[n_u>8]", n=N_WIDE, n_s=100)
    return timed, timed4


def phase_wide_glue():
    """K2, K3, K5 and K6 at p in {33, 40, 64} against their twins, float32
    and float64. Returns the timed p = 40 float64 cases."""
    timed = {}
    for p in (33, 40, 64):
        for dt in ("float64", "float32"):
            t = p == 40 and dt == "float64"
            k2 = _k2_case(p - 4, dt, n_u=4, seed=110 + p, timed=t)
            k3 = _k3_case(p - 1, dt, seed=111 + p, timed=t)
            k5 = _k5_case(p - 4, 4, dt, 8, (3,), seed=112 + p, timed=t)
            k6 = _k6_case(dt, n_ct=p - 1, seed=113 + p, timed=t)
            if t:
                timed = {"k2": k2, "k3": k3, "k5": k5, "k6": k6}
    # a block of 32 float64 warps of the register form passes the card's
    # registers: the launchers cap the warps, which then loop over columns
    for dt in ("float64", "float32"):
        _k2_case(25, dt, n_u=4, seed=114, n_s=100)
        _k2_case(33, dt, n_u=4, seed=115, n_s=100)
        _k3_case(28, dt, seed=116, n_s=100)
    return timed


def phase_masks():
    """K2 and K5 with row masks against their twins, the all-ones masks
    bit-identical to none. Returns the timed float64 cases."""
    p = N_CT + 3
    k2 = _k2_case(N_CT, "float64", n_u=3, seed=120, timed=True,
                  mask=[1, 1, 0, 1, 1, 1, 0, 1])
    _k2_case(N_CT, "float32", n_u=3, seed=121, mask=[1] * p)
    _k2_case(N_CT, "float64", n_u=3, seed=122, mask=[1] * p)
    _k2_case(36, "float64", n_u=4, seed=123, mask=[1] * 38 + [0, 0])
    masks = np.ones((8, p))
    masks[0, -2:] = 0
    masks[1, -1] = 0
    masks[2, 0] = 0
    masks[5, [1, 6]] = 0
    reset_counts()
    _k5_case(N_CT, 3, "float32", 8, (4,), seed=125, mask=masks)
    check_launches = read_counts()["alpha_phase_full_multi{masked}"]
    k5 = _k5_case(N_CT, 3, "float64", 8, (4,), seed=124, timed=True,
                  mask=masks)
    k5["launches"] = check_launches
    return {"k2": k2, "k5": k5}


def _padded_init(n, n_s, n_ct, n_u, n_u_max, seed, dtype):
    """A rank-n_u init (u, alpha) on the card, its zero-padded rank-n_u_max
    form and the mask of its rows."""
    import torch

    g = torch.Generator(device=DEV).manual_seed(seed)
    u = torch.rand((n, n_u), generator=g, device=DEV, dtype=dtype)
    e = torch.empty((n_ct + n_u, n_s), device=DEV, dtype=dtype).exponential_(
        generator=g)
    a = e / e.sum(0)
    u_pad = torch.zeros((n, n_u_max), device=DEV, dtype=dtype)
    u_pad[:, :n_u] = u
    a_pad = torch.zeros((n_ct + n_u_max, n_s), device=DEV, dtype=dtype)
    a_pad[:n_ct + n_u] = a
    mask = (torch.arange(n_ct + n_u_max, device=DEV) < n_ct + n_u)
    return u, a, u_pad, a_pad, mask


def _wide_problem(n, n_s, n_ct, n_u, dtype, seed):
    """y, d, Rt (n, ...) of a simulated cohort on the card, made in bulk
    from a seed: Rt and the true u uniform, proportions Dirichlet(1),
    coverage Poisson(50) + 1, y the mixture plus N(0, 0.01^2), clipped."""
    import torch

    g = torch.Generator(device=DEV).manual_seed(seed)
    p = n_ct + n_u
    R = torch.rand((n, p), generator=g, device=DEV, dtype=dtype)
    e = torch.empty((p, n_s), device=DEV, dtype=dtype).exponential_(
        generator=g)
    y = (R @ (e / e.sum(0)) + 0.01 * torch.randn(
        (n, n_s), generator=g, device=DEV, dtype=dtype)).clamp(0, 1)
    d = (torch.poisson(torch.full((n, n_s), 50.0, device=DEV),
                       generator=g) + 1).to(dtype)
    return y, d, R[:, :n_ct].contiguous()


def phase_mask_paths(card):
    """The padded masked solve on the card: ``partial_ref_solve_fused
    (row_mask=)`` (K1, then K2 with the mask every iteration) against the
    lower-rank solve, float64, 200k sites, 5 + 1 padded to 5 + 3, 50 x 20,
    with the counters set to 0 just before and read just after."""
    import torch

    from demethify_tpu_torch.solvers import fused

    n, n_s, n_ct, n_u_max = N_WIDE, N_S, N_CT, 3
    f64 = torch.float64
    y, d, Rt = _wide_problem(n, n_s, n_ct, n_u_max, f64, seed=130)
    kw = dict(n_iter1=50, n_iter2=N_INNER, tol=0.0, record_trace=True)
    out = {}
    u, a, u_pad, a_pad, mask = _padded_init(n, n_s, n_ct, 1, n_u_max, 131,
                                            f64)
    reset_counts()
    (pu, pa, pinfo), ms = timed_ms(lambda: fused.partial_ref_solve_fused(
        u_pad, a_pad, y, d, Rt, n_u_max, row_mask=mask, **kw))
    out["single"] = read_counts()
    lu, la, linfo = fused.partial_ref_solve_fused(u, a, y, d, Rt, 1, **kw)
    zero = bool((pu[:, 1:] == 0).all() and (pa[n_ct + 1:] == 0).all())
    err_a = float((pa[:n_ct + 1] - la).abs().max())
    err_u = float((pu[:, :1] - lu).abs().max())
    tk, tl = (x["trace"].cpu().numpy() for x in (pinfo, linfo))
    err_c = float(np.max(np.abs(tk - tl) / np.abs(tl)))
    log(f"[masks] padded partial_ref_solve_fused(row_mask=) N={n} n_s={n_s} "
        f"{n_ct}+1 padded to {n_ct}+{n_u_max}, 50x{N_INNER} float64, card "
        f"{card}: {ms / 50:.4f} ms per outer iteration; inactive u columns "
        f"and alpha rows exactly 0: {zero}; against the lower-rank solve: "
        f"alpha max|diff| {err_a:.3e}, u {err_u:.3e} (tol "
        f"{TRAJ_TOL['float64']['alpha']:.0e}), cost trace rel {err_c:.3e} "
        f"(tol {TRAJ_TOL['float64']['cost']:.0e}); launches "
        f"{out['single']}")
    check(zero, "padded masked solve: inactive rows moved")
    check(max(err_a, err_u) <= TRAJ_TOL["float64"]["alpha"]
          and err_c <= TRAJ_TOL["float64"]["cost"],
          "padded masked solve differs from the lower-rank solve")
    check(expect_counts(out["single"], u_phase_grams=50,
                        alpha_phase_full=50,
                        **{"alpha_phase_full{masked}": 50}),
          f"padded solve launches {out['single']}")

    return out


def phase_rt_folded():
    """K1 with Rt folded into the data block ([Y.T; D.T; Rt.T], rtt None)
    against the unfolded launch on the same data: bit for bit, at the main
    path's shape in float32 and a wide shape in float64. Counts its
    launches (no solver keeps Rt folded). Returns (timed case, launches)."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import (
        u_phase_grams, u_phase_grams_plain, u_phase_layout)

    res = {}
    for n, n_s, n_ct, n_u, dt in ((N_CPG, N_S, N_CT, N_U, "float32"),
                                  (N_WIDE, 256, 25, 4, "float64")):
        ydt, rtt, alpha, uut, scal = _k1_inputs(n, n_s, n_ct, n_u,
                                                getattr(torch, dt), 150)
        folded = torch.cat([ydt, rtt]).contiguous()
        a1, a2 = alpha[:n_ct], alpha[n_ct:]
        u0, s0 = uut.clone(), scal.clone()
        ref = u_phase_grams(ydt, rtt, a1, a2, u0, s0, N_INNER)
        reset_counts()
        u1, s1 = uut.clone(), scal.clone()
        got = u_phase_grams(folded, None, a1, a2, u1, s1, N_INNER)
        launches = read_counts()
        same = (all(torch.equal(x, y) for x, y in zip(got, ref))
                and torch.equal(u0, u1) and torch.equal(s0, s1))
        if n == N_CPG:
            res["ms"] = median_ms(lambda: u_phase_grams(
                folded, None, a1, a2, u1, s1, N_INNER), inner=10)
            res["unfolded_ms"] = median_ms(lambda: u_phase_grams(
                ydt, rtt, a1, a2, u0, s0, N_INNER), inner=10)
            up, sp = uut.clone(), scal.clone()
            res["plain_ms"] = median_ms(lambda: u_phase_grams_plain(
                folded, None, a1, a2, up, sp, N_INNER), reps=3, inner=2,
                warmup=1)
            res["launches"] = launches["u_phase_grams{rt folded}"]
            res["max_abs_err"] = 0.0 if same else float("nan")
            res["bound_ms"], res["bound_by"] = bound(
                *u_phase_work(n, n_s, n_ct, n_u, N_INNER, 4, 4), dt)
        log(f"[rt folded] K1 N={n} n_s={n_s} {n_ct}+{n_u} {dt}: Rt folded "
            f"into [Y.T; D.T; Rt.T] bit-identical to the unfolded launch: "
            f"{same}; launches {launches['u_phase_grams{rt folded}']}"
            + (f"; folded {res['ms']:.4f} ms, unfolded "
               f"{res['unfolded_ms']:.4f} ms" if n == N_CPG else ""))
        check(same, "folded-Rt K1 differs from the unfolded launch")
        wide = u_phase_layout("K1", ydt.element_size(), n_s, n_ct,
                              n_u)[0] == "wide"
        check(expect_counts(launches, u_phase_grams=1,
                            **{"u_phase_grams{rt folded}": 1,
                               "u_phase_grams{wide}": int(wide)}),
              f"the folded launch was not counted: {launches}")
    return res


def phase_bf16c_direct(card):
    """K1's bf16_compute form in the direct dataflow (n_u^2 > 3 n_s)
    against its twin; then ``partial_ref_solve_fused(bf16_compute=True)``
    at a direct shape (200k x 2 samples, 5 + 3, bf16 storage, 30 x 5) on
    the card against the same call on the CPU (the twins), with the
    counters set to 0 just before the card's run. Returns (timed case,
    launches)."""
    import torch

    from demethify_tpu_torch.solvers import fused

    main = _k1_case(N_CPG, 2, "float32", n_s=1, data="bfloat16",
                    bf16_compute=True, timed=True, seed=160,
                    label="[bf16_compute direct]")
    _k1_case(N_CPG, 3, "float32", n_s=2, data="bfloat16", bf16_compute=True,
             seed=161, label="[bf16_compute direct]")
    _k1_case(N_WIDE, 16, "float32", n_s=20, n_ct=25, data="bfloat16",
             bf16_compute=True, seed=162,
             label="[bf16_compute direct, n_u>8]")
    n, n_s, n_ct, n_u = N_WIDE, 2, N_CT, 3
    y, d, Rt = (x.to(torch.bfloat16) for x in _wide_problem(
        n, n_s, n_ct, n_u, torch.float32, seed=163))
    g = torch.Generator(device=DEV).manual_seed(164)
    u0 = torch.rand((n, n_u), generator=g, device=DEV)
    e = torch.empty((n_ct + n_u, n_s), device=DEV).exponential_(generator=g)
    a0 = e / e.sum(0)
    kw = dict(n_iter1=30, n_iter2=5, tol=0.0, record_trace=True,
              bf16_compute=True)
    reset_counts()
    card_out, ms = timed_ms(lambda: fused.partial_ref_solve_fused(
        u0, a0, y, d, Rt, n_u, **kw))
    launches = read_counts()
    cpu_out = fused.partial_ref_solve_fused(
        *(x.cpu() for x in (u0, a0, y, d, Rt)), n_u, **kw)
    tk, tc = (o[2]["trace"].double().cpu().numpy()
              for o in (card_out, cpu_out))
    err_c = float(np.max(np.abs(tk - tc) / np.abs(tc)))
    err_a = float((card_out[1].cpu() - cpu_out[1]).abs().max())
    log(f"[bf16_compute direct] partial_ref_solve_fused(bf16_compute=True) "
        f"N={n} n_s={n_s} {n_ct}+{n_u} (direct form) bf16 storage, 30x5, "
        f"card {card}: {ms / 30:.4f} ms per outer iteration; card vs CPU "
        f"twins: cost trace rel {err_c:.3e} (tol "
        f"{BF16C_TRAJ_TOL['cost']:.0e}), alpha max|diff| {err_a:.3e} (tol "
        f"{BF16C_TRAJ_TOL['alpha']:.0e}); launches {launches}")
    check(err_c <= BF16C_TRAJ_TOL["cost"]
          and err_a <= BF16C_TRAJ_TOL["alpha"],
          "bf16_compute direct: card differs from its CPU twins")
    check(expect_counts(launches, alpha_phase_full=30,
                        **{"u_phase_grams[bf16_compute]": 30,
                           "u_phase_grams{bf16_compute direct}": 30}),
          f"bf16_compute direct launches {launches}")
    main["launches"] = launches["u_phase_grams{bf16_compute direct}"]
    return main


def phase_bootstrap_direct():
    """The weights bootstrap in the direct form (n_u^2 > 3 n_s: 2 samples,
    5 + 3) on the card against the CPU with the same injected draws and
    inits, float64, 20k sites, B = 4, in the partial-reference and purity
    modes: the plain weighted solvers on the card's tensors, so no kernel
    launches (counted)."""
    import torch

    from demethify_tpu_torch import state
    from demethify_tpu_torch.uncertainty.bootstrap import bootstrap_ci

    n, n_s, n_u, n_b = 20_000, 2, 3, 4
    y, d, Rt = (x.cpu().numpy() for x in _wide_problem(
        n, n_s, N_CT, n_u, torch.float64, seed=170))
    rng = np.random.default_rng(171)
    indices = rng.integers(0, n, size=(n_b, n))
    purity = rng.uniform(0.3, 0.9, size=n_s)
    for name, pu, n1, n2 in (("partial-ref", None, 30, N_INNER),
                             ("purity", purity, 10, 100)):
        a_b = np.stack([rng.dirichlet(np.ones(N_CT + n_u), size=n_s).T
                        for _ in range(n_b)])
        if pu is not None:
            a_b[:, :N_CT] *= pu / a_b[:, :N_CT].sum(1, keepdims=True)
            a_b[:, N_CT:] *= (1 - pu) / a_b[:, N_CT:].sum(1, keepdims=True)
        inits = list(zip(rng.uniform(size=(n_b, n, n_u)), a_b))
        out = {}
        for dev in (DEV, "cpu"):
            _, _, yt, dt, Rtt = state.from_numpy(None, None, y, d, Rt,
                                                 device=dev,
                                                 dtype=torch.float64)
            reset_counts()
            out[dev] = bootstrap_ci(
                yt, dt, Rtt, n_u, level=90, n_bootstrap=n_b, n_iter1=n1,
                n_iter2=n2, tol=0.0, method="weights", purity=pu,
                indices=indices, inits=inits)
            if dev == DEV:
                launches = read_counts()
        err = max(float(np.abs(a - b).max())
                  for a, b in zip(out[DEV], out["cpu"]))
        log(f"[bootstrap direct] {name} weights layout, direct form "
            f"(n_u={n_u}, n_s={n_s}), B={n_b} {n1}x{n2} float64 N={n}: card "
            f"vs CPU with the same draws and inits, CI bounds max|diff| "
            f"{err:.3e} (tol 1e-8); kernel launches on the card "
            f"{sum(launches.values())} (the plain weighted solvers)")
        check(err <= 1e-8, f"bootstrap direct {name}: card vs CPU")
        check(expect_counts(launches), "the direct-form bootstrap launched "
              "a kernel")


def _envelope_vs_plain(tag, n_b, y, d, Rt, n_u, pur, n1, n2, seed):
    """The kernel solver an envelope path runs (``fused.*_solve_fused``,
    or its ``_multi`` form for n_b > 1 restarts) against the plain solver
    on the same data from the same seeded inits over n1 x n2, tol = 0:
    cost trace and alpha at ``TRAJ_TOL`` of the data's dtype (each member
    for the multi solver)."""
    import torch

    from demethify_tpu_torch.solvers import fused
    from demethify_tpu_torch.solvers.partial_ref import partial_ref_solve
    from demethify_tpu_torch.solvers.purity import purity_solve

    n, n_s = y.shape
    n_ct = Rt.shape[1]
    name = str(y.dtype).replace("torch.", "")
    u_b, a_b = _member_inits(
        n, n_b, n_ct, n_u, seed, n_s=n_s,
        purity=None if pur is None else pur.cpu().numpy())
    u_b, a_b = (torch.as_tensor(x, device=DEV, dtype=y.dtype)
                for x in (u_b, a_b))
    kw = dict(n_iter1=n1, n_iter2=n2, tol=0.0, record_trace=True)
    extra = () if pur is None else (pur,)
    plain = partial_ref_solve if pur is None else purity_solve
    members = [plain(u_b[b], a_b[b], y, d, Rt, *extra, n_u, **kw)
               for b in range(n_b)]
    shape = f"N={n} n_s={n_s} {n_ct}+{n_u} {name}"
    if n_b == 1:
        single = (fused.partial_ref_solve_fused if pur is None
                  else fused.purity_solve_fused)
        _compare(f"{tag} {n1}x{n2}", shape,
                 single(u_b[0], a_b[0], y, d, Rt, *extra, n_u, **kw),
                 members[0], TRAJ_TOL[name], n1)
        return
    multi = (fused.partial_ref_solve_fused_multi if pur is None
             else fused.purity_solve_fused_multi)
    tol = TRAJ_TOL[name]
    check(tol["cost"] == tol["alpha"], "one tolerance per member check")
    _multi_vs_members(f"{tag} B={n_b} {n1}x{n2} {shape}",
                      multi(u_b, a_b, y, d, Rt, *extra, n_u, **kw), members,
                      "the plain solver per member", tol["cost"])


def phase_envelope_paths(card):
    """The wide forms on paths through ``solvers.api``, each run with the
    counters set to 0 just before and read just after: partial-reference
    at 1M x 100, 25 + 4 in float64 (K1 in the wide layout, 100 x 20), its
    restarts (B = 4, 200k sites, 50 x 20: K4 wide); and 25 + 12 at
    200k x 100, float64 (p = 37 and n_u > 8: K1 and K4 wide with the
    state in scratch columns, K2, K3, K5 and K6 in the wide form): partial-
    reference 50 x 20, purity 10 x 100, and both with 4 restarts. Before
    each, the kernel solver that path runs against the plain solver on
    the same data and inits over a short schedule (``_envelope_vs_plain``:
    20 x 20, purity 5 x 100, restarts per member). Returns each run's
    launches by name."""
    import torch

    from demethify_tpu_torch.solvers.api import (
        partial_reference_deconv, purity_deconv)

    out = {}
    f64 = torch.float64
    n, n_s, n_ct, n_u = COHORT
    y, d, Rt = _wide_problem(n, n_s, n_ct, n_u, f64, seed=180)
    _envelope_vs_plain("wide path", 1, y, d, Rt, n_u, None, 20, N_INNER, 10)
    _, ms_it, out["wide"] = _drive(
        "wide path", f"partial-ref 1M x 100, 25+4, float64, 100x{N_INNER}, "
        f"card {card}", lambda: partial_reference_deconv(
            y, d, Rt, n_u, n_iter1=100, n_iter2=N_INNER, tol=0.0,
            record_trace=True, seed=4), 100, n_sites=n)
    check(expect_counts(out["wide"], u_phase_grams=100, alpha_phase_full=100,
                        **{"u_phase_grams{wide}": 100}),
          f"wide path launches {out['wide']}")
    del y, d, Rt
    y, d, Rt = _wide_problem(N_WIDE, n_s, n_ct, n_u, f64, seed=181)
    _envelope_vs_plain("wide restarts", 4, y, d, Rt, n_u, None, 20, N_INNER,
                       11)
    _, _, out["wide restarts"] = _drive(
        "wide restarts", f"partial-ref 200k x 100, 25+4, float64, 4 "
        f"restarts, 50x{N_INNER}", lambda: partial_reference_deconv(
            y, d, Rt, n_u, n_iter1=50, n_iter2=N_INNER, tol=0.0,
            record_trace=True, seed=5, n_restarts=4), 50, n_sites=N_WIDE)
    check(expect_counts(out["wide restarts"], u_phase_grams_multi=50,
                        alpha_phase_full_multi=50,
                        **{"u_phase_grams_multi{wide}": 50}),
          f"wide restart launches {out['wide restarts']}")

    n_u = 12
    y, d, Rt = _wide_problem(N_WIDE, n_s, n_ct, n_u, f64, seed=182)
    pur = torch.linspace(0.3, 0.9, n_s, device=DEV, dtype=f64)
    runs = (
        ("p>32", 50, N_INNER, 1, None, "alpha_phase_full",
         lambda n1, n2, r: partial_reference_deconv(
             y, d, Rt, n_u, n_iter1=n1, n_iter2=n2, tol=0.0,
             record_trace=True, seed=6, n_restarts=r)),
        ("p>32 purity", 10, 100, 1, pur, "fw_phase_full",
         lambda n1, n2, r: purity_deconv(
             y, d, Rt, n_u, pur, n_iter1=n1, n_iter2=n2, tol=0.0,
             record_trace=True, seed=7, n_restarts=r)),
        ("p>32 restarts", 20, N_INNER, 4, None, "alpha_phase_full_multi",
         lambda n1, n2, r: partial_reference_deconv(
             y, d, Rt, n_u, n_iter1=n1, n_iter2=n2, tol=0.0,
             record_trace=True, seed=8, n_restarts=r)),
        ("p>32 purity restarts", 5, 100, 4, pur, "fw_phase_full_multi",
         lambda n1, n2, r: purity_deconv(
             y, d, Rt, n_u, pur, n_iter1=n1, n_iter2=n2, tol=0.0,
             record_trace=True, seed=9, n_restarts=r)))
    for tag, n1, n2, r, pu, glue, call in runs:
        _envelope_vs_plain(tag, r, y, d, Rt, n_u, pu,
                           20 if pu is None else 5, n2, 12 + r)
        k = "u_phase_grams_multi" if r > 1 else "u_phase_grams"
        _, _, out[tag] = _drive(
            tag, f"200k x 100, {n_ct}+{n_u} (p = {n_ct + n_u}), float64, "
            f"{r} restart(s), {n1}x{n2}",
            lambda: call(n1, n2, r), n1, n_sites=N_WIDE)
        check(expect_counts(out[tag], **{k: n1, glue: n1,
                                         f"{k}{{n_u>8}}": n1,
                                         f"{k}{{wide}}": n1,
                                         f"{glue}{{p>32}}": n1}),
              f"{tag} launches {out[tag]}")
    return out


def _cohort_k1_k2(y, d, Rt, alpha, n_u):
    """K1 and K2 at the cohort shape: median device ms (CUDA events) of
    back-to-back launches beside their bounds, and K1 in the resident
    layout forced (the same bits; the plan there is the wide one) for
    comparison."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import (
        A_ALPHA, A_U, DMAX2, L_H_PREV, L_W, L_W_PREV, N_SCAL, RT_SQ,
        u_phase_grams)
    from demethify_tpu_torch.ops.cuda_small import alpha_phase_full
    from demethify_tpu_torch.ops.gram import known_block_grams

    n, n_s = y.shape
    n_ct = Rt.shape[1]
    ydt = torch.cat([y.T, d.T]).contiguous()
    rtt = Rt.T.contiguous()
    u = torch.rand((n_u, n), device=DEV)
    uut = torch.cat([u, u]).contiguous()
    scal = torch.zeros(N_SCAL, device=DEV)
    dmax2 = float(d.max()) ** 2
    scal[A_U], scal[L_W] = 1.5, float(torch.sum(alpha[-n_u:] ** 2)) * dmax2
    scal[L_W_PREV] = scal[L_W]
    a1, a2 = alpha[:n_ct].contiguous(), alpha[n_ct:].contiguous()
    res = {}
    res["k1_ms"] = median_ms(lambda: u_phase_grams(
        ydt, rtt, a1, a2, uut, scal, N_INNER), reps=5, inner=2)
    with forced_layout("resident"):
        res["k1_resident_ms"] = median_ms(lambda: u_phase_grams(
            ydt, rtt, a1, a2, uut, scal, N_INNER), reps=5, inner=2)
    res["k1_bound_ms"], res["k1_bound_by"] = bound(
        *u_phase_work(n, n_s, n_ct, n_u, N_INNER, 4, 4), "float32")
    gu, bu, usq = u_phase_grams(ydt, rtt, a1, a2, uut, scal, N_INNER)
    gtt, bt, ydy = (x.contiguous() for x in known_block_grams(Rt, d, y))
    scal[A_ALPHA], scal[RT_SQ], scal[DMAX2] = 1.0, float(
        torch.sum(Rt * Rt)), dmax2
    scal[L_H_PREV] = (scal[RT_SQ] + usq) * dmax2
    al, ap = alpha.clone(), alpha.clone()
    res["k2_ms"] = median_ms(lambda: alpha_phase_full(
        gtt, bt, gu, bu, usq.reshape(1), ydy, al, ap, scal, N_INNER, n_u),
        inner=20)
    res["k2_bound_ms"], res["k2_bound_by"] = bound(
        *glue_work(n_ct + n_u, n_s, n_ct, N_INNER, 4), "float32")
    return res


def phase_cohort(card):
    """The cohort path at full width: ``partial_reference_deconv`` at 1M
    sites x 100 samples, 25 known + 4 unknown, float32, 1000 x 20,
    tol = 0, with the counters set to 0 just before and read just after;
    K1's and K2's times at that shape with their bounds; and the kernel
    solver against the plain solver over 20 x 20 at the same width."""
    import torch

    from demethify_tpu_torch.solvers.api import partial_reference_deconv
    from demethify_tpu_torch.solvers.partial_ref import partial_ref_solve

    n, n_s, n_ct, n_u = COHORT
    y, d, Rt = _wide_problem(n, n_s, n_ct, n_u, torch.float32, seed=190)
    g = torch.Generator(device=DEV).manual_seed(191)
    u0 = torch.rand((n, n_u), generator=g, device=DEV)
    e = torch.empty((n_ct + n_u, n_s), device=DEV).exponential_(generator=g)
    a0 = e / e.sum(0)
    kw = dict(n_iter2=N_INNER, tol=0.0, record_trace=True,
              init_provided=(u0, a0))
    partial_reference_deconv(y, d, Rt, n_u, n_iter1=2, **kw)        # warm
    res, ms_iter, launches = _drive(
        "cohort", f"partial-ref 1M x 100, 25+4, float32, {N_OUTER}x"
        f"{N_INNER}, tol=0 via solvers.api.partial_reference_deconv, card "
        f"{card}", lambda: partial_reference_deconv(y, d, Rt, n_u,
                                                    n_iter1=N_OUTER, **kw),
        N_OUTER, n_sites=n)
    check(expect_counts(launches, u_phase_grams=N_OUTER,
                        alpha_phase_full=N_OUTER,
                        **{"u_phase_grams{wide}": N_OUTER}),
          f"cohort launches {launches}")
    props = res.proportions
    check(res.u.shape == (n, n_u) and props.shape == (n_ct + n_u, n_s),
          "cohort output shapes")
    check(float((props.sum(0) - 1).abs().max()) < 1e-4,
          "cohort alpha off the simplex")
    times = _cohort_k1_k2(y, d, Rt, a0, n_u)
    log(f"[cohort] K1 at 1M x 100, 25+4 float32 (wide layout): "
        f"{times['k1_ms']:.4f} ms (bound {times['k1_bound_ms']:.4f} ms, "
        f"{times['k1_bound_by']}); the resident layout forced "
        f"{times['k1_resident_ms']:.4f} ms; K2 {times['k2_ms']:.4f} ms (bound "
        f"{times['k2_bound_ms']:.6f} ms, {times['k2_bound_by']}); K1 + K2 "
        f"{times['k1_ms'] + times['k2_ms']:.4f} of {ms_iter:.4f} ms per "
        f"outer iteration")
    kw20 = dict(n_iter1=20, n_iter2=N_INNER, tol=0.0, record_trace=True)
    kern = partial_reference_deconv(y, d, Rt, n_u, init_provided=(u0, a0),
                                    **kw20)
    (_, a_p, info_p), plain_ms = _per_iter_ms(
        lambda: partial_ref_solve(u0, a0, y, d, Rt, n_u, **kw20), 20)
    tk = kern.trace.double().cpu().numpy()
    tp = info_p["trace"].double().cpu().numpy()
    err_c = float(np.max(np.abs(tk - tp) / np.abs(tp)))
    err_a = float((kern.proportions - a_p).abs().max())
    log(f"[cohort] kernel solver vs plain solver over 20x{N_INNER} at the "
        f"same width: cost trace max rel diff {err_c:.3e} (tol "
        f"{TRAJ_TOL['float32']['cost']:.0e}), alpha max|diff| {err_a:.3e} "
        f"(tol {TRAJ_TOL['float32']['alpha']:.0e}); plain solver "
        f"{plain_ms:.4f} ms per outer iteration")
    check(err_c <= TRAJ_TOL["float32"]["cost"]
          and err_a <= TRAJ_TOL["float32"]["alpha"],
          "cohort: kernel solver differs from the plain solver")
    times.update(ms_iter=ms_iter, launches=launches, plain_ms=plain_ms)
    return times


def k1_main_outputs(root, path):
    """Saves K1's outputs (u, u_prev, scalars, gu, b_u, usq) at the main
    path's shape (1M x 10, 5 + 1, float32, 20 steps, ``_k1_inputs`` seed
    0, one launch) from the tree at ``root`` to ``path``, for a bit-for-bit
    comparison of two trees on one card:

        python3 -c 'import chip_smoke; chip_smoke.k1_main_outputs("DIR", "OUT.pt")'
    """
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import u_phase_grams

    ydt, rtt, alpha, uut, scal = _k1_inputs(N_CPG, N_S, N_CT, N_U,
                                            torch.float32, 0)
    gu, bu, usq = u_phase_grams(ydt, rtt, alpha[:-N_U], alpha[-N_U:], uut,
                                scal, N_INNER)
    torch.save({k: v.cpu() for k, v in dict(
        uut=uut, scal=scal, gu=gu, bu=bu, usq=usq).items()}, path)


def same_outputs(path_a, path_b):
    """Prints whether two ``k1_main_outputs`` files hold the same bits."""
    import torch

    a, b = torch.load(path_a), torch.load(path_b)
    same = {k: torch.equal(a[k], b[k]) for k in a}
    print(json.dumps({"a": path_a, "b": path_b, "bit_identical": same}),
          flush=True)


def time_main_path(root):
    """Times the single-restart main path of the tree at ``root`` on one
    GPU and prints one JSON line: the card's ``nvidia-smi`` name and power
    limit, K1 and K2 at the main path's shape (the timed cases of phases
    3 and 4), K4 and K5 at the partial-reference restart path's shape
    (B = 16, shared known blocks: the timed cases of phase 5; K5 also
    queued behind a device sleep, its device time alone) and the
    main path's ms per outer iteration, 300 x 20 through
    ``solvers.api.partial_reference_deconv`` on ``make_problem``'s data
    (tol = 0), five times, and the same call at 1 x 20 (the solve's fixed
    cost, set-up and result, plus one iteration), seven times. Two trees unpacked side by side, a change and
    its parent, are compared on one card by timing them in turns, one
    process each (parent, change, change, parent):

        python3 -c 'import chip_smoke; chip_smoke.time_main_path("DIR")'
    """
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    from demethify_tpu_torch import state
    from demethify_tpu_torch.solvers.api import partial_reference_deconv

    check(torch.cuda.is_available(), "time_main_path needs a GPU")
    card = phase_device()
    k1 = _k1_case(N_CPG, N_U, "float32", timed=True)
    k2 = _k2_case(N_CT, "float32", timed=True)
    k4 = _k4_case(N_U, "float32", 16, N_INNER, inactive=(3, 7, 11),
                  timed=True, label="[restarts]")
    k5 = _k5_case(N_CT, N_U, "float32", 16, (2, 9), timed=True)
    u0, a0, y, d, Rt = state.from_numpy(*make_problem(), device=DEV,
                                        dtype=torch.float32)
    kw = dict(n_iter2=N_INNER, tol=0.0, init_provided=(u0, a0))
    partial_reference_deconv(y, d, Rt, N_U, n_iter1=5, **kw)        # warm
    n_iter, main_ms = 300, []
    for _ in range(5):
        res, ms = timed_ms(lambda: partial_reference_deconv(
            y, d, Rt, N_U, n_iter1=n_iter, **kw))
        check(res.n_iter == n_iter, f"main path ran {res.n_iter} iterations")
        main_ms.append(ms / n_iter)
    one_ms = [timed_ms(lambda: partial_reference_deconv(
        y, d, Rt, N_U, n_iter1=1, **kw))[1] for _ in range(7)]
    print(json.dumps({"root": root, "card": card, "k1_ms": k1["ms"],
                      "k2_ms": k2["ms"], "k4_ms": k4["ms"], "k5_ms": k5["ms"],
                      "k5_queued_ms": k5["queued_ms"],
                      "main_ms_per_iter": main_ms,
                      "one_iteration_solve_ms": one_ms}), flush=True)



# K1 (B = 0) and K4 (B members) shapes that both layouts take:
# (B, n_s, n_ct, n_u, steps, state, data, lagged, weighted); the main
# path's shape first, then its storages and schedules, the direct form,
# n_u > 8 and n_s from 10 to the resident layout's limit
LAYOUT_TIMES = (
    (0, 10, 5, 1, 20, "float32", None, False, False),
    (0, 10, 5, 1, 20, "float64", None, False, False),
    (0, 10, 5, 1, 20, "float32", "bfloat16", False, False),
    (0, 10, 5, 1, 500, "float32", None, False, False),
    (0, 10, 0, 3, 20, "float32", None, True, False),
    (0, 5, 5, 4, 20, "float32", None, False, False),
    (0, 16, 5, 8, 20, "float32", None, False, False),
    (0, 10, 5, 12, 20, "float32", None, False, False),
    (0, 100, 5, 12, 20, "float32", None, False, False),
    (0, 25, 5, 1, 20, "float32", None, False, False),
    (0, 50, 5, 1, 20, "float32", None, False, False),
    (0, 100, 5, 1, 20, "float32", None, False, False),
    (0, 200, 5, 1, 20, "float32", None, False, False),
    (0, 10, 25, 4, 20, "float32", None, False, False),
    (0, 25, 25, 4, 20, "float32", None, False, False),
    (0, 50, 25, 4, 20, "float32", None, False, False),
    (0, 100, 25, 4, 20, "float32", None, False, False),
    (0, 128, 25, 4, 20, "float32", None, False, False),
    (0, 50, 5, 1, 20, "float64", None, False, False),
    (0, 100, 5, 1, 20, "float64", None, False, False),
    (0, 25, 25, 4, 20, "float64", None, False, False),
    (0, 50, 25, 4, 20, "float64", None, False, False),
    (0, 88, 25, 4, 20, "float64", None, False, False),
    (16, 10, 5, 1, 20, "float32", None, False, False),
    (32, 10, 5, 1, 20, "float32", None, False, True),
    (4, 50, 25, 4, 20, "float32", None, False, False),
    (4, 100, 25, 4, 20, "float32", None, False, False),
)


def time_layouts(n=N_CPG):
    """Times K1 and K4 in the resident and in the wide layout, each forced,
    at every shape of ``LAYOUT_TIMES`` on ``n`` sites: the median device
    ms of back-to-back launches (CUDA events), in the order resident,
    wide, wide, resident, and the resident layout's shared memory and
    blocks per SM beside the wide layout's. Prints one line per shape and
    one JSON line:

        python3 -c 'import chip_smoke; chip_smoke.time_layouts()'
    """
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import (
        SMEM_LIMIT, blocks_per_sm, gram_form, u_phase_grams, u_phase_smem)
    from demethify_tpu_torch.ops.cuda_multi import u_phase_grams_multi

    check(torch.cuda.is_available(), "time_layouts needs a GPU")
    card = phase_device()
    rows = []
    for n_b, n_s, n_ct, n_u, steps, dt, data, lagged, weighted in (
            LAYOUT_TIMES):
        dtype = getattr(torch, dt)
        weights = None
        if n_b:
            ydt, rtt, alpha, uut, scal = _multi_inputs(n, n_s, n_ct, n_u,
                                                       n_b, dtype, 210)
            a1, a2 = alpha[:, :n_ct], alpha[:, n_ct:]
            if weighted:
                weights = resample_weights(n_b, n, dtype, 211)
            fn = functools.partial(u_phase_grams_multi, weights=weights)
        else:
            ydt, rtt, alpha, uut, scal = _k1_inputs(n, n_s, n_ct, n_u, dtype,
                                                    210)
            a1, a2 = alpha[:n_ct], alpha[n_ct:]
            fn = u_phase_grams
        if n_ct == 0:
            rtt = a1 = None
        if data is not None:
            ydt = ydt.to(getattr(torch, data))
            rtt = None if rtt is None else rtt.to(getattr(torch, data))
        direct = not gram_form(n_u, n_s)
        smem = {lay: u_phase_smem(lay, uut.element_size(), n_s, n_ct, n_u,
                                  direct, weighted=weighted)
                for lay in ("resident", "wide")}
        check(smem["resident"] <= SMEM_LIMIT,
              f"n_s={n_s} {n_ct}+{n_u} does not fit the resident layout")
        inner = 10 if n_s * (n_ct + n_u) * max(n_b, 1) <= 2000 else 2
        ms = {"resident": [], "wide": []}
        for lay in ("resident", "wide", "wide", "resident"):
            u, sc = uut.clone(), scal.clone()
            with forced_layout(lay):
                ms[lay].append(median_ms(lambda: fn(
                    ydt, rtt, a1, a2, u, sc, steps, lagged), inner=inner))
        per_sm = {lay: blocks_per_sm(b) for lay, b in smem.items()}
        row = {"B": n_b, "n_s": n_s, "n_ct": n_ct, "n_u": n_u,
               "steps": steps, "state": dt, "data": data or dt,
               "lagged": lagged, "weighted": weighted,
               "form": "direct" if direct else "gram",
               "resident_ms": ms["resident"], "wide_ms": ms["wide"],
               "wide_over_resident": statistics.mean(ms["wide"])
               / statistics.mean(ms["resident"]),
               "smem": smem, "blocks_per_sm": per_sm}
        rows.append(row)
        log(f"[layout times] {'K4 B=' + str(n_b) if n_b else 'K1'} "
            f"N={n} n_s={n_s} {n_ct}+{n_u} {row['form']} {steps} steps "
            f"{dt} state {data or dt} data{' lagged' if lagged else ''}"
            f"{' weighted' if weighted else ''}: resident "
            f"{ms['resident']} ms ({smem['resident']} B, "
            f"{per_sm['resident']} blocks/SM), wide {ms['wide']} ms "
            f"({smem['wide']} B, {per_sm['wide']} blocks/SM); wide / "
            f"resident {row['wide_over_resident']:.4f}")
        del ydt, rtt, alpha, uut, scal, weights
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "n": n, "layout_times": rows}),
          flush=True)


def _envelope_rows(wide, k1_state, k4_state, glue, masks, folded,
                   k1_bf16c_direct, mask_paths, env):
    """The kernels JSON line's rows of the envelope's forms. ``launches``
    is each form's count from the path run named in ``path``; the
    folded-Rt form and K5's masks have no solver route, so their counts
    are their checks'."""
    src = "demethify_tpu_torch/csrc/"
    k1_src, k4_src = src + "u_phase_grams", src + "u_phase_grams_multi"
    k1_at = "demethify_tpu/ops/pallas_kernels.py:218"
    k4_at = "demethify_tpu/ops/pallas_kernels.py:828"
    w1, w4 = wide[(500, 25, 4, "float64")]
    n_ct40 = 40 - 4

    def row(name, source, replaces, case, launches, path, err=None,
            bound_ms=None, bound_by=None):
        if err is None:
            err = case.get("alpha_max_abs", case.get("u_max_abs"))
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": case["ms"],
                "plain_ms": case["plain_ms"],
                "bound_ms": case["bound_ms"] if bound_ms is None
                else bound_ms,
                "bound_by": case["bound_by"] if bound_by is None
                else bound_by, "library_ms": None, "path": path}

    k3_b = bound(*glue_work(40, N_S, 39, P_INNER, 8, fw=True), "float64")
    return [
        row("u_phase_grams{wide}", k1_src + "_wide.cu",
            k1_at + " (lane tile shrunk by fused.py:76-108, via :612)", w1,
            env["wide"]["u_phase_grams{wide}"],
            "partial-ref 1M x 100, 25+4, float64, 100x20 (times: n_s=500)"),
        row("u_phase_grams_multi{wide}", k4_src + "_wide.cu",
            k4_at + " (via :1123)", w4,
            env["wide restarts"]["u_phase_grams_multi{wide}"],
            "4 restarts 200k x 100, 25+4, float64 (times: n_s=500, B=4)"),
        row("u_phase_grams{n_u>8}", k1_src + ".cu",
            k1_at + " (no n_u cap, via :499)", k1_state,
            env["p>32"]["u_phase_grams{n_u>8}"],
            "partial-ref 200k x 100, 25+12, float64 (times: 5+12, n_s=100, "
            "float64)"),
        row("u_phase_grams_multi{n_u>8}", k4_src + ".cu",
            k4_at + " (no n_u cap, via :1123)", k4_state,
            env["p>32 restarts"]["u_phase_grams_multi{n_u>8}"],
            "4 restarts 200k x 100, 25+12, float64 (times: 5+12, B=4, "
            "float64)"),
        row("alpha_phase_full{p>32}", src + "alpha_phase_full.cu",
            "demethify_tpu/ops/pallas_small.py:261 (p > 32)", glue["k2"],
            env["p>32"]["alpha_phase_full{p>32}"],
            "partial-ref 200k x 100, 25+12 (times: p=40, float64)"),
        row("fw_phase_full{p>32}", src + "fw_phase_full.cu",
            "demethify_tpu/ops/pallas_small.py:636 (p > 32)", glue["k3"],
            env["p>32 purity"]["fw_phase_full{p>32}"],
            "purity 200k x 100, 25+12 (times: p=40, float64)",
            bound_ms=k3_b[0], bound_by=k3_b[1]),
        row("alpha_phase_full_multi{p>32}", src + "alpha_phase_full.cu",
            "demethify_tpu/ops/pallas_small.py:388 (p > 32, via :485)",
            glue["k5"], env["p>32 restarts"]["alpha_phase_full_multi{p>32}"],
            "4 restarts 200k x 100, 25+12 (times: p=40, B=8, float64)"),
        row("fw_phase_full_multi{p>32}", src + "fw_phase_full.cu",
            "demethify_tpu/ops/pallas_small.py:571 (p > 32, via :592)",
            glue["k6"],
            env["p>32 purity restarts"]["fw_phase_full_multi{p>32}"],
            "4 purity restarts 200k x 100, 25+12 (times: p=40, B=8, "
            "float64)"),
        row("u_phase_grams{bf16_compute direct}", k1_src + ".cu",
            k1_at + " (bf16_compute direct fallback :299-311, via :499)",
            k1_bf16c_direct, k1_bf16c_direct["launches"],
            "partial_ref_solve_fused(bf16_compute=True) 200k x 2, 5+3, "
            "bf16 (times: 1M x 1, 5+2)"),
        row("alpha_phase_full{masked}", src + "alpha_phase_full.cu",
            "demethify_tpu/ops/pallas_small.py:261 (row_mask :281-282, via "
            ":299)", masks["k2"],
            mask_paths["single"]["alpha_phase_full{masked}"],
            "padded partial_ref_solve_fused(row_mask=) 200k x 10"),
        row("alpha_phase_full_multi{masked}", src + "alpha_phase_full.cu",
            "demethify_tpu/ops/pallas_small.py:388 (row_mask_b :409-410, "
            "via :485)", masks["k5"], masks["k5"]["launches"],
            "its float32 check against the twin (no solver route runs "
            "K5's masks)"),
        row("u_phase_grams{rt folded}", k1_src + ".cu",
            k1_at + " (rt_folded :650-674, via :612)", folded,
            folded["launches"],
            "its bit check against the unfolded launch (no solver keeps Rt "
            "folded)", err=folded["max_abs_err"])]

def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "demethify_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository (the "
              "demethify_tpu_torch package is missing)", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    k1 = phase_k1()
    k1_bf16, k1_bf16c = phase_k1_bf16()
    k2 = phase_k2()
    k3 = phase_k3()
    k4, k4_uns, k4_pur = phase_k4()
    k5 = phase_k5()
    k6 = phase_k6()
    k4w, _, _ = phase_k4_weighted()
    k4_bf16, k4w_bf16 = phase_k4_bf16(k4, k4w)
    k5w = phase_k5_weighted()
    k6w = phase_k6_weighted()
    phase_layouts()
    phase_narrow_bits()
    wide = phase_wide_kernels()
    partial = phase_partial_buffer()
    k1_state, k4_state = phase_state_cols()
    glue = phase_wide_glue()
    masks = phase_masks()
    folded = phase_rt_folded()
    k1_bf16c_direct = phase_bf16c_direct(card)
    phase_solver_trajectory()
    phase_bf16_solvers()
    identical = phase_multi_solvers()
    phase_weighted_solvers()
    phase_bootstrap_parity()
    phase_bootstrap_direct()
    problem32 = make_problem(np.float32, seed=0)
    launches = phase_main_path(problem32, card)
    p_launches, _, _ = phase_purity_path(problem32, card)
    phase_unsupervised_path(problem32, card)
    restarts = phase_restarts(problem32, card, {
        "partial-ref": k4["ms"], "purity": k4_pur["ms"],
        "unsupervised": k4_uns["ms"]})
    boot = phase_bootstrap(problem32, card)
    bf16 = phase_bf16_paths(problem32, card)
    mask_paths = phase_mask_paths(card)
    env = phase_envelope_paths(card)
    cohort = phase_cohort(card)
    phase_cli()
    check("jax" not in sys.modules, "jax was imported")
    check(not any(m == "demethify_tpu" or m.startswith("demethify_tpu.")
                  for m in sys.modules), "a JAX-package module was imported")
    from demethify_tpu_torch.isolation import jax_package_references

    refs = jax_package_references(HERE)
    check(not refs, f"the port reaches the JAX package's files: {refs}")
    log(f"[done] no jax, no JAX-package module and no path into the JAX "
        f"package in the port's sources; multi-member solvers bit-identical "
        f"to the sequential kernel solves: {identical}")
    k1_b = bound(*u_phase_work(N_CPG, N_S, N_CT, N_U, N_INNER, 4, 4),
                 "float32")
    k2_b = bound(*glue_work(N_CT + N_U, N_S, N_CT, N_INNER, 4), "float32")
    k3_b = bound(*glue_work(N_CT + N_U, N_S, N_CT, P_INNER, 4, fw=True),
                 "float32")
    kernels = {"kernels": [
        {"name": "u_phase_grams", "route": "cuda",
         "source": "demethify_tpu_torch/csrc/u_phase_grams.cu",
         "replaces": "demethify_tpu/ops/pallas_kernels.py:218 (via :612 "
                     "and :499)",
         "launches": launches["u_phase_grams"],
         "max_abs_err": k1["u_max_abs"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"], "bound_ms": k1_b[0],
         "bound_by": k1_b[1], "library_ms": None},
        {"name": "alpha_phase_full", "route": "cuda",
         "source": "demethify_tpu_torch/csrc/alpha_phase_full.cu",
         "replaces": "demethify_tpu/ops/pallas_small.py:261",
         "launches": launches["alpha_phase_full"],
         "max_abs_err": k2["alpha_max_abs"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2_b[0],
         "bound_by": k2_b[1], "library_ms": None},
        {"name": "fw_phase_full", "route": "cuda",
         "source": "demethify_tpu_torch/csrc/fw_phase_full.cu",
         "replaces": "demethify_tpu/ops/pallas_small.py:636",
         "launches": p_launches["fw_phase_full"],
         "max_abs_err": k3["alpha_max_abs"], "ms": k3["ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3_b[0],
         "bound_by": k3_b[1], "library_ms": None},
        {"name": "u_phase_grams_multi", "route": "cuda",
         "source": "demethify_tpu_torch/csrc/u_phase_grams_multi.cu",
         "replaces": "demethify_tpu/ops/pallas_kernels.py:828 (via :1123)",
         "launches": restarts["partial-ref"]["launches"][
             "u_phase_grams_multi"],
         "max_abs_err": k4["u_max_abs"], "ms": k4["ms"],
         "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
         "bound_by": k4["bound_by"], "library_ms": None},
        {"name": "alpha_phase_full_multi", "route": "cuda",
         "source": "demethify_tpu_torch/csrc/alpha_phase_full.cu",
         "replaces": "demethify_tpu/ops/pallas_small.py:388 (via :485)",
         "launches": restarts["partial-ref"]["launches"][
             "alpha_phase_full_multi"],
         "max_abs_err": k5["alpha_max_abs"], "ms": k5["ms"],
         "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"],
         "bound_by": k5["bound_by"], "library_ms": None},
        {"name": "fw_phase_full_multi", "route": "cuda",
         "source": "demethify_tpu_torch/csrc/fw_phase_full.cu",
         "replaces": "demethify_tpu/ops/pallas_small.py:571 (via :592)",
         "launches": restarts["purity"]["launches"]["fw_phase_full_multi"],
         "max_abs_err": k6["alpha_max_abs"], "ms": k6["ms"],
         "plain_ms": k6["plain_ms"], "bound_ms": k6["bound_ms"],
         "bound_by": k6["bound_by"], "library_ms": None},
        {"name": "u_phase_grams_multi[weights]", "route": "cuda",
         "source": "demethify_tpu_torch/csrc/u_phase_grams_multi.cu",
         "replaces": "demethify_tpu/ops/pallas_kernels.py:828 (weights "
                     "operand :1015-1120, via :1123)",
         "launches": boot["weights partial-ref"]["launches"][
             "u_phase_grams_multi"],
         "max_abs_err": k4w["u_max_abs"], "ms": k4w["ms"],
         "plain_ms": k4w["plain_ms"], "bound_ms": k4w["bound_ms"],
         "bound_by": k4w["bound_by"], "library_ms": None},
        {"name": "alpha_phase_full_multi[per-member known blocks]",
         "route": "cuda",
         "source": "demethify_tpu_torch/csrc/alpha_phase_full.cu",
         "replaces": "demethify_tpu/ops/pallas_small.py:388 (per-member "
                     "gtt/bt/ydy, via :485)",
         "launches": boot["weights partial-ref"]["launches"][
             "alpha_phase_full_multi"],
         "max_abs_err": k5w["alpha_max_abs"], "ms": k5w["ms"],
         "plain_ms": k5w["plain_ms"], "bound_ms": k5w["bound_ms"],
         "bound_by": k5w["bound_by"], "library_ms": None},
        {"name": "fw_phase_full_multi[per-member known blocks]",
         "route": "cuda",
         "source": "demethify_tpu_torch/csrc/fw_phase_full.cu",
         "replaces": "demethify_tpu/ops/pallas_small.py:571 (per-member "
                     "gtt/bt/ydy, via :592)",
         "launches": boot["weights purity"]["launches"][
             "fw_phase_full_multi"],
         "max_abs_err": k6w["alpha_max_abs"], "ms": k6w["ms"],
         "plain_ms": k6w["plain_ms"], "bound_ms": k6w["bound_ms"],
         "bound_by": k6w["bound_by"], "library_ms": None},
        {"name": "u_phase_grams[bf16]", "route": "cuda",
         "source": "demethify_tpu_torch/csrc/u_phase_grams.cu",
         "replaces": "demethify_tpu/ops/pallas_kernels.py:218 (bf16 blocks "
                     ":255-265, via :499)",
         "launches": bf16["bf16"]["launches"]["u_phase_grams[bf16]"],
         "max_abs_err": k1_bf16["u_max_abs"], "ms": k1_bf16["ms"],
         "plain_ms": k1_bf16["plain_ms"], "bound_ms": k1_bf16["bound_ms"],
         "bound_by": k1_bf16["bound_by"], "library_ms": None},
        {"name": "u_phase_grams[bf16_compute]", "route": "cuda",
         "source": "demethify_tpu_torch/csrc/u_phase_grams.cu",
         "replaces": "demethify_tpu/ops/pallas_kernels.py:218 "
                     "(bf16_compute :229-311, :464-479, via :499)",
         "launches": bf16["bf16_compute"]["launches"][
             "u_phase_grams[bf16_compute]"],
         "max_abs_err": k1_bf16c["u_max_abs"], "ms": k1_bf16c["ms"],
         "plain_ms": k1_bf16c["plain_ms"], "bound_ms": k1_bf16c["bound_ms"],
         "bound_by": k1_bf16c["bound_by"], "library_ms": None},
        {"name": "u_phase_grams_multi[bf16]", "route": "cuda",
         "source": "demethify_tpu_torch/csrc/u_phase_grams_multi.cu",
         "replaces": "demethify_tpu/ops/pallas_kernels.py:828 (bf16 blocks "
                     ":835-836, :853, via :1123)",
         "launches": bf16["restarts"]["launches"][
             "u_phase_grams_multi[bf16]"],
         "max_abs_err": k4_bf16["u_max_abs"], "ms": k4_bf16["ms"],
         "plain_ms": k4_bf16["plain_ms"], "bound_ms": k4_bf16["bound_ms"],
         "bound_by": k4_bf16["bound_by"], "library_ms": None},
        {"name": "u_phase_grams_multi[bf16,weights]", "route": "cuda",
         "source": "demethify_tpu_torch/csrc/u_phase_grams_multi.cu",
         "replaces": "demethify_tpu/ops/pallas_kernels.py:828 (bf16 blocks "
                     "with the weights operand :1015-1120, via :1123)",
         "launches": bf16["bootstrap"]["launches"][
             "u_phase_grams_multi[bf16]"],
         "max_abs_err": k4w_bf16["u_max_abs"], "ms": k4w_bf16["ms"],
         "plain_ms": k4w_bf16["plain_ms"], "bound_ms": k4w_bf16["bound_ms"],
         "bound_by": k4w_bf16["bound_by"], "library_ms": None}]}
    kernels["kernels"].extend(_envelope_rows(
        wide, k1_state, k4_state, glue, masks, folded, k1_bf16c_direct,
        mask_paths, env))
    log(f"[done] K1's partial buffer at 1M x 500, 25+4, float64: "
        f"{partial['partial_bytes'] / 1e9:.3f} GB, "
        f"{partial['partial_bytes'] / partial['yd_bytes']:.3f} of Y + D; the "
        f"cohort path {cohort['ms_iter']:.4f} ms per outer iteration")
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
