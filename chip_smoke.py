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
6. solvers: each kernel solver against its plain solver on the card in
   float64 at 200k sites (partial-reference 50 x 20 in float32 too,
   purity 20 x 500, unsupervised 50 x 20: cost trajectories, alpha);
7. the three paths at full width, each with the launch counters set to 0
   just before it and read just after: the main path, ``bench.py``'s
   workload (1M x 10, 5 + 1, float32, 1000 x 20, tol = 0) through
   ``solvers.api.partial_reference_deconv``; the purity path (1M x 10,
   5 + 1, purity drawn in [0.3, 0.9], float32, 100 x 500) through
   ``purity_deconv``; the unsupervised path (1M x 10, n_u = 3, float32,
   1000 x 20) through ``unsupervised_deconv``; each beside the plain
   solver;
8. CLI: a simulated 50,000-site bedmethyl fixture through
   ``demethify_tpu_torch.cli.main`` in all four modes on ``--device cuda``.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

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
    from demethify_tpu_torch.ops import cuda_kernels, cuda_small

    return (cuda_kernels.u_phase_grams, cuda_small.alpha_phase_full,
            cuda_small.fw_phase_full)


def reset_counts():
    for fn in counters():
        fn.launches = 0


def read_counts():
    return {fn.__name__: fn.launches for fn in counters()}


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
             n_s=N_S, n_ct=N_CT, lagged=False, label=""):
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import (
        gram_form, u_phase_grams, u_phase_grams_plain)

    dtype = getattr(torch, dtype_name)
    ydt, rtt, alpha, uut, scal = _k1_inputs(n, n_s, n_ct, n_u, dtype, seed)
    a1, a2 = alpha[:-n_u], alpha[-n_u:]
    if n_ct == 0:
        rtt = a1 = None
    uk, sk = uut.clone(), scal.clone()
    gk, bk, qk = u_phase_grams(ydt, rtt, a1, a2, uk, sk, steps, lagged)
    up, sp = uut.clone(), scal.clone()
    gp, bp, qp = u_phase_grams_plain(ydt, rtt, a1, a2, up, sp, steps, lagged)
    torch.cuda.synchronize()
    err_u = float((uk - up).abs().max())
    scale = float(gp.abs().max())
    err_g = float((gk - gp).abs().max()) / scale
    err_b = float((bk - bp).abs().max()) / scale
    err_q = abs(float(qk) - float(qp)) / abs(float(qp))
    err_s = float((sk - sp).abs().max() / sp.abs().max())
    tol = TOL[dtype_name]
    form = "gram" if gram_form(n_u, n_s) else "direct"
    res = {"n": n, "n_s": n_s, "n_ct": n_ct, "n_u": n_u, "steps": steps,
           "lagged": lagged, "form": form, "dtype": dtype_name,
           "u_max_abs": err_u, "gu_rel": err_g, "b_u_rel": err_b,
           "usq_rel": err_q, "scal_rel": err_s, "tol_u": tol["u"],
           "tol_gram": tol["gram"]}
    if timed:
        res["ms"] = median_ms(lambda: u_phase_grams(
            ydt, rtt, a1, a2, uk, sk, steps, lagged), inner=10)
        res["plain_ms"] = median_ms(lambda: u_phase_grams_plain(
            ydt, rtt, a1, a2, up, sp, steps, lagged), reps=3, inner=2,
            warmup=1)
    log(f"[K1]{label} N={n} n_s={n_s} n_ct={n_ct} n_u={n_u} {form} form"
        f"{' lagged' if lagged else ''} {steps} steps {dtype_name}: u "
        f"max|diff| {err_u:.3e} (tol {tol['u']:.0e}); gu rel {err_g:.3e}, b_u "
        f"rel {err_b:.3e}, usq rel {err_q:.3e} (tol {tol['gram']:.0e}); "
        f"scalars rel {err_s:.3e}"
        + (f"; kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms "
           f"(median of back-to-back launches, CUDA events)" if timed
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


# ---------------------------------------------------------------- phase 4
def _small_inputs(n_ct, n_u, dtype_name, n, seed):
    """Known and new-u Gram blocks of a K1-style problem on the card."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import u_phase_grams_plain
    from demethify_tpu_torch.ops.gram import known_block_grams

    dtype = getattr(torch, dtype_name)
    ydt, rtt, alpha, uut, scal = _k1_inputs(n, N_S, n_ct, n_u, dtype, seed)
    gu, bu, usq = u_phase_grams_plain(ydt, rtt, alpha[:-n_u],
                                      alpha[-n_u:], uut, scal, 3)
    gtt, bt, ydy = (x.contiguous() for x in known_block_grams(
        rtt.T, ydt[N_S:].T, ydt[:N_S].T))
    return (gtt, bt, gu.contiguous(), bu.contiguous(), usq.reshape(1),
            ydy, alpha, ydt, rtt, scal)


def _k2_case(n_ct, dtype_name, timed=False, n=200_000, seed=3, n_u=N_U):
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import (
        A_ALPHA, COST, DMAX2, L_H_PREV, L_W, RT_SQ)
    from demethify_tpu_torch.ops.cuda_small import (
        alpha_phase_full, alpha_phase_full_plain)

    gtt, bt, gu, bu, usq, ydy, alpha, ydt, rtt, scal = _small_inputs(
        n_ct, n_u, dtype_name, n, seed)
    dmax2 = ydt[N_S:].max() ** 2
    rt_sq = torch.sum(rtt * rtt)
    scal[A_ALPHA], scal[RT_SQ], scal[DMAX2] = 1.8, rt_sq, dmax2
    scal[L_H_PREV] = 1.05 * (rt_sq + usq[0]) * dmax2
    g = torch.Generator(device=DEV).manual_seed(seed + 1)
    e = torch.empty_like(alpha).exponential_(generator=g)
    alpha_prev = (e / e.sum(0)).contiguous()
    args = (gtt, bt, gu, bu, usq, ydy)
    ak, apk, sk = alpha.clone(), alpha_prev.clone(), scal.clone()
    alpha_phase_full(*args, ak, apk, sk, N_INNER, n_u)
    ap_, app, sp = alpha.clone(), alpha_prev.clone(), scal.clone()
    alpha_phase_full_plain(*args, ap_, app, sp, N_INNER, n_u)
    torch.cuda.synchronize()
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
            *args, ak, apk, sk, N_INNER, n_u), inner=20)
        res["plain_ms"] = median_ms(lambda: alpha_phase_full_plain(
            *args, ap_, app, sp, N_INNER, n_u), inner=20)
    log(f"[K2] p={p} n_ct={n_ct} n_s={N_S} {dtype_name}: alpha max|diff| "
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
    is (alpha_{k+1} - (1 - gamma_k) alpha_k) / gamma_k."""
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
    grad = torch.einsum("spq,kqs->kps", G, traj[:-1]) - b
    flips = 0
    for lo, hi in ((0, n_ct), (n_ct, alpha0.shape[0])):
        want = torch.argmin(grad[:, lo:hi], dim=1)
        got = torch.argmax(vert[:, lo:hi], dim=1)
        flips += int((want != got).sum())
    return flips


def _k3_case(n_ct, dtype_name, timed=False, n=200_000, seed=9):
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import COST, DMAX2, L_W
    from demethify_tpu_torch.ops.cuda_small import (
        fw_phase_full, fw_phase_full_plain)

    gtt, bt, gu, bu, _, ydy, alpha, ydt, _, scal = _small_inputs(
        n_ct, N_U, dtype_name, n, seed)
    scal[DMAX2] = ydt[N_S:].max() ** 2
    rng = np.random.default_rng(seed)
    purity = torch.as_tensor(rng.uniform(0.3, 0.9, size=N_S),
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
    log(f"[K3] p={p} n_s={N_S} {P_INNER} steps {dtype_name}: alpha "
        f"max|diff| {err_a:.3e} (tol {tol_a:.1e}); vertex choices that "
        f"differ from the twin's at the same iterate: {flips} of "
        f"{2 * P_INNER * N_S}; cost diff / sum(ydy) {err_c:.3e}, l_w rel "
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


def _drive(tag, what, call, n_outer, enqueue_ms=None):
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
        f"events), {N_CPG * n_outer / (ms / 1e3):.4e} site-iters/s, wall "
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
    check(launches == {"u_phase_grams": N_OUTER,
                       "alpha_phase_full": N_OUTER, "fw_phase_full": 0},
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
    check(launches == {"u_phase_grams": P_OUTER, "alpha_phase_full": 0,
                       "fw_phase_full": P_OUTER},
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
    check(launches == {"u_phase_grams": N_OUTER,
                       "alpha_phase_full": N_OUTER, "fw_phase_full": 0},
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


def phase_cli():
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
        for mode, with_ref, extra, n_rows in modes:
            before = read_counts()
            outdir = os.path.join(root, mode)
            t0 = time.perf_counter()
            rc = cli_main(["--methfreq", *samples, "--bedmethyl",
                           "--noprint", "--outdir", outdir, "--device", DEV,
                           *(["--ref", ref] if with_ref else []), *extra])
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
                check(moved["u_phase_grams"] > 0,
                      f"CLI {mode} launched no K1")
            if mode == "purity":
                check(moved["fw_phase_full"] > 0, "CLI purity launched no K3")
                mass = 1 - np.asarray(percent) / 100
                check(np.abs(props[:N_CT].sum(0) - mass).max() <= 1e-5,
                      "CLI purity: known mass != 1 - p/100")
            if mode == "unsupervised":
                want = [f"unknown_cell_{i + 1}" for i in range(U_N_U)]
                check(labels == want and len(prof_header) == U_N_U,
                      f"CLI unsupervised labels {labels}")
                check(moved["alpha_phase_full"] > 0,
                      "CLI unsupervised launched no K2")
            log(f"[cli] {mode}: exit 0 in {wall:.2f} s, proportions "
                f"{props.shape} column sums within "
                f"{np.abs(props.sum(axis=0) - 1).max():.1e} of 1, launches "
                f"{moved}")


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
    k2 = phase_k2()
    k3 = phase_k3()
    phase_solver_trajectory()
    problem32 = make_problem(np.float32, seed=0)
    launches = phase_main_path(problem32, card)
    p_launches, _, _ = phase_purity_path(problem32, card)
    phase_unsupervised_path(problem32, card)
    phase_cli()
    check("jax" not in sys.modules, "jax was imported")
    kernels = {"kernels": [
        {"name": "u_phase_grams", "route": "cuda",
         "source": "demethify_tpu_torch/csrc/u_phase_grams.cu",
         "replaces": "demethify_tpu/ops/pallas_kernels.py:218 (via :612 "
                     "and :499)",
         "launches": launches["u_phase_grams"],
         "max_abs_err": k1["u_max_abs"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"]},
        {"name": "alpha_phase_full", "route": "cuda",
         "source": "demethify_tpu_torch/csrc/alpha_phase_full.cu",
         "replaces": "demethify_tpu/ops/pallas_small.py:261",
         "launches": launches["alpha_phase_full"],
         "max_abs_err": k2["alpha_max_abs"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"]},
        {"name": "fw_phase_full", "route": "cuda",
         "source": "demethify_tpu_torch/csrc/fw_phase_full.cu",
         "replaces": "demethify_tpu/ops/pallas_small.py:636",
         "launches": p_launches["fw_phase_full"],
         "max_abs_err": k3["alpha_max_abs"], "ms": k3["ms"],
         "plain_ms": k3["plain_ms"]}]}
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
