#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure or tolerance exceeded exits
non-zero and prints no result line):

1. device: torch/CUDA versions and ``nvidia-smi`` name and power limit;
2. build: the kernels from ``demethify_tpu_torch/csrc`` (nvcc, ctypes);
3. K1 ``u_phase_grams`` against its plain PyTorch twin at the main-path
   shape (1M sites x 10 samples, 5 known + 1 unknown, 20 inner steps) in
   float32 and float64, n_u = 2 in float32, and a ragged N = 1,000,003;
4. K2 ``alpha_phase_full`` against its twin at p = 6 and p = 26;
5. solver: the kernel solver against the plain solver on the card (50 x 20
   iterations, cost trajectories), then the main path itself: the
   ``bench.py`` workload (1M x 10, 5 + 1, float32, 1000 x 20, tol = 0)
   through ``solvers.api.partial_reference_deconv``, with the launch
   counters reset just before and read just after;
6. CLI: a simulated 50,000-site bedmethyl fixture through
   ``demethify_tpu_torch.cli.main`` in supervised and partial-reference
   mode on ``--device cuda``.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# the main path's shape (bench.py's workload)
N_CPG, N_S, N_CT, N_U, N_OUTER, N_INNER = 1_000_000, 10, 5, 1, 1000, 20

# kernel-vs-twin tolerances on the card. Both sides sum in different
# orders (the kernel: 128-site blocks, then a fixed tree; the twin:
# cuBLAS / PyTorch reductions). float64: 1e-10. float32: u to 5e-5
# absolute (u in [0, 1] after 20 FISTA steps), the Gram blocks to 5e-5 of
# their largest entry (sums over 1M sites).
TOL = {"float64": {"u": 1e-10, "gram": 1e-10, "alpha": 1e-10,
                   "cost": 1e-10},
       "float32": {"u": 5e-5, "gram": 5e-5, "alpha": 5e-5, "cost": 5e-5}}
# solver trajectories: the Gram-identity cost sum(ydy) - ... cancels about
# three digits at this size (sum(ydy) ~ 3e3 x cost), so in float32 the
# two solvers' costs agree only to ~1e-3 relative; float64 is tight.
TRAJ_TOL = {"float64": {"cost": 1e-9, "alpha": 1e-9},
            "float32": {"cost": 1e-2, "alpha": 2e-3}}
# the bench workload's 1000 x 20 run in float64 (rounding grows along the
# flat direction over 1000 iterations; ~1e6 x eps on this problem)
LONG_TOL64 = {"cost": 1e-9, "alpha": 1e-6}


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def median_ms(fn, reps=7, inner=1, warmup=2):
    """Median device time of ``fn`` in ms from CUDA events over ``reps``
    repetitions of ``inner`` calls each."""
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
    ptxas = [ln.strip() for ln in lib.build_log.splitlines()
             if "entry function" in ln or "registers" in ln
             or "spill" in ln]
    log(f"[build] {lib.path} in {lib.build_seconds:.2f} s")
    for ln in ptxas:
        log(f"[build] ptxas: {ln}")


# ---------------------------------------------------------------- phase 3
def _k1_inputs(n, n_s, n_ct, n_u, dtype, seed):
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import (
        A_U, L_W, L_W_PREV, N_SCAL)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    p = n_ct + n_u
    rt = torch.rand((n_ct, n), generator=g, device=dev, dtype=dtype)
    ut_true = torch.rand((n_u, n), generator=g, device=dev, dtype=dtype)
    e = torch.empty((p, n_s), device=dev, dtype=dtype).exponential_(
        generator=g)
    alpha = (e / e.sum(0)).contiguous()
    d = torch.poisson(torch.full((n_s, n), 50.0, device=dev), generator=g)
    d = (d + 1).to(dtype)
    y = (alpha.T @ torch.cat([rt, ut_true]) + 0.01 * torch.randn(
        (n_s, n), generator=g, device=dev, dtype=dtype)).clamp(0, 1)
    u = torch.rand((n_u, n), generator=g, device=dev, dtype=dtype)
    uut = torch.cat([u, (u + 0.05 * torch.randn(
        u.shape, generator=g, device=dev, dtype=dtype)).clamp(0, 1)])
    ydt = torch.cat([y, d]).contiguous()
    l_w = torch.sum(alpha[-n_u:] ** 2) * d.max() ** 2
    scal = torch.zeros(N_SCAL, device=dev, dtype=dtype)
    scal[A_U], scal[L_W], scal[L_W_PREV] = 2.5, l_w, 0.9 * l_w
    return ydt, rt.contiguous(), alpha, uut.contiguous(), scal


def _k1_case(n, n_u, dtype_name, steps=N_INNER, seed=0, timed=False):
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import (
        u_phase_grams, u_phase_grams_plain)

    dtype = getattr(torch, dtype_name)
    ydt, rtt, alpha, uut, scal = _k1_inputs(n, N_S, N_CT, n_u, dtype, seed)
    a1, a2 = alpha[:-n_u], alpha[-n_u:]
    uk, sk = uut.clone(), scal.clone()
    gk, bk, qk = u_phase_grams(ydt, rtt, a1, a2, uk, sk, steps)
    up, sp = uut.clone(), scal.clone()
    gp, bp, qp = u_phase_grams_plain(ydt, rtt, a1, a2, up, sp, steps)
    torch.cuda.synchronize()
    err_u = float((uk - up).abs().max())
    scale = float(gp.abs().max())
    err_g = float((gk - gp).abs().max()) / scale
    err_b = float((bk - bp).abs().max()) / scale
    err_q = abs(float(qk) - float(qp)) / abs(float(qp))
    err_s = float((sk - sp).abs().max() / sp.abs().max())
    tol = TOL[dtype_name]
    res = {"n": n, "n_u": n_u, "dtype": dtype_name, "u_max_abs": err_u,
           "gu_rel": err_g, "b_u_rel": err_b, "usq_rel": err_q,
           "scal_rel": err_s, "tol_u": tol["u"], "tol_gram": tol["gram"]}
    if timed:
        res["ms"] = median_ms(lambda: u_phase_grams(
            ydt, rtt, a1, a2, uk, sk, steps), inner=10)
        res["plain_ms"] = median_ms(lambda: u_phase_grams_plain(
            ydt, rtt, a1, a2, up, sp, steps), inner=10)
    log(f"[K1] N={n} n_u={n_u} {dtype_name}: u max|diff| {err_u:.3e} "
        f"(tol {tol['u']:.0e}); gu rel {err_g:.3e}, b_u rel {err_b:.3e}, "
        f"usq rel {err_q:.3e} (tol {tol['gram']:.0e}); scalars rel "
        f"{err_s:.3e}"
        + (f"; kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms "
           f"(median of 7 x 10 launches, CUDA events)" if timed else ""))
    check(np.isfinite([err_u, err_g, err_b, err_q]).all(), "K1 non-finite")
    check(err_u <= tol["u"], f"K1 u differs from its twin by {err_u}")
    check(max(err_g, err_b, err_q) <= tol["gram"],
          f"K1 Grams differ from the twin by {max(err_g, err_b, err_q)}")
    check(err_s <= tol["gram"], f"K1 scalars differ by {err_s}")
    return res


def phase_k1():
    cases = [_k1_case(N_CPG, N_U, "float32", timed=True),
             _k1_case(N_CPG, N_U, "float64", timed=True),
             _k1_case(N_CPG, 2, "float32", seed=1),
             _k1_case(N_CPG + 3, N_U, "float32", seed=2)]
    return cases[0]


# ---------------------------------------------------------------- phase 4
def _k2_case(n_ct, dtype_name, timed=False, n=200_000, seed=3):
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import (
        A_ALPHA, COST, DMAX2, L_H_PREV, L_W, RT_SQ, u_phase_grams_plain)
    from demethify_tpu_torch.ops.cuda_small import (
        alpha_phase_full, alpha_phase_full_plain)
    from demethify_tpu_torch.ops.gram import known_block_grams

    dtype = getattr(torch, dtype_name)
    ydt, rtt, alpha, uut, scal = _k1_inputs(n, N_S, n_ct, N_U, dtype, seed)
    gu, bu, usq = u_phase_grams_plain(ydt, rtt, alpha[:-N_U],
                                      alpha[-N_U:], uut, scal, 3)
    gtt, bt, ydy = (x.contiguous() for x in known_block_grams(
        rtt.T, ydt[N_S:].T, ydt[:N_S].T))
    gu, bu, usq = gu.contiguous(), bu.contiguous(), usq.reshape(1)
    dmax2 = ydt[N_S:].max() ** 2
    rt_sq = torch.sum(rtt * rtt)
    scal[A_ALPHA], scal[RT_SQ], scal[DMAX2] = 1.8, rt_sq, dmax2
    scal[L_H_PREV] = 1.05 * (rt_sq + usq[0]) * dmax2
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    e = torch.empty_like(alpha).exponential_(generator=g)
    alpha_prev = (e / e.sum(0)).contiguous()
    args = (gtt, bt, gu, bu, usq, ydy)
    ak, apk, sk = alpha.clone(), alpha_prev.clone(), scal.clone()
    alpha_phase_full(*args, ak, apk, sk, N_INNER, N_U)
    ap_, app, sp = alpha.clone(), alpha_prev.clone(), scal.clone()
    alpha_phase_full_plain(*args, ap_, app, sp, N_INNER, N_U)
    torch.cuda.synchronize()
    err_a = float(torch.maximum((ak - ap_).abs().max(),
                                (apk - app).abs().max()))
    scale = float(ydy.sum())
    err_c = abs(float(sk[COST]) - float(sp[COST])) / scale
    err_w = abs(float(sk[L_W]) - float(sp[L_W])) / abs(float(sp[L_W]))
    err_n = abs(float(sk[A_ALPHA]) - float(sp[A_ALPHA]))
    tol = TOL[dtype_name]
    p = n_ct + N_U
    res = {"p": p, "dtype": dtype_name, "alpha_max_abs": err_a,
           "cost_rel_to_sum_ydy": err_c, "l_w_rel": err_w,
           "tol_alpha": tol["alpha"], "tol_cost": tol["cost"]}
    if timed:
        res["ms"] = median_ms(lambda: alpha_phase_full(
            *args, ak, apk, sk, N_INNER, N_U), inner=20)
        res["plain_ms"] = median_ms(lambda: alpha_phase_full_plain(
            *args, ap_, app, sp, N_INNER, N_U), inner=20)
    log(f"[K2] p={p} n_s={N_S} {dtype_name}: alpha max|diff| {err_a:.3e} "
        f"(tol {tol['alpha']:.0e}); cost diff / sum(ydy) {err_c:.3e}, l_w "
        f"rel {err_w:.3e} (tol {tol['cost']:.0e})"
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
             _k2_case(25, "float32"), _k2_case(25, "float64")]
    return cases[0]


# ---------------------------------------------------------------- phase 5
def make_problem(dtype=np.float32, seed=0, n_cpg=N_CPG):
    """bench.py's workload recipe (numpy, seeded)."""
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


def phase_solver_trajectory(problem64):
    import torch

    from demethify_tpu_torch import state
    from demethify_tpu_torch.solvers.fused import partial_ref_solve_fused
    from demethify_tpu_torch.solvers.partial_ref import partial_ref_solve

    for name in ("float64", "float32"):
        t = state.from_numpy(*problem64, device="cuda",
                             dtype=getattr(torch, name))
        kw = dict(n_iter1=50, n_iter2=N_INNER, tol=0.0, record_trace=True)
        _, ak, ik = partial_ref_solve_fused(*t, N_U, **kw)
        _, ap, ip = partial_ref_solve(*t, N_U, **kw)
        tk = ik["trace"].double().cpu().numpy()
        tp = ip["trace"].double().cpu().numpy()
        err_c = float(np.max(np.abs(tk - tp) / np.abs(tp)))
        err_a = float((ak - ap).abs().max())
        tol = TRAJ_TOL[name]
        log(f"[solver] 50x20 {name} N={problem64[2].shape[0]}: kernel vs "
            f"plain solver cost trace max rel diff {err_c:.3e} (tol "
            f"{tol['cost']:.0e}), alpha max|diff| {err_a:.3e} (tol "
            f"{tol['alpha']:.0e}); n_iter {ik['n_iter']}/{ip['n_iter']}; "
            f"cost {tk[0]:.6e} -> {tk[-1]:.6e}")
        check(ik["n_iter"] == ip["n_iter"] == 50, "n_iter differs")
        check(np.isfinite(tk).all(), "non-finite kernel cost trace")
        check(err_c <= tol["cost"] and err_a <= tol["alpha"],
              f"{name} trajectories differ")


def _enqueue_only_ms(t, n_iter):
    """ms per outer iteration of the same K1 + K2 launches with no host
    read in between (the device-bound loop the termination read stalls)."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import (
        A_ALPHA, A_U, DMAX2, L_H_PREV, L_W, L_W_PREV, N_SCAL, RT_SQ,
        u_phase_grams)
    from demethify_tpu_torch.ops.cuda_small import alpha_phase_full
    from demethify_tpu_torch.ops.gram import known_block_grams

    u, alpha, y, d, Rt = t
    ydt = torch.cat([y.T, d.T]).contiguous()
    rtt = Rt.T.contiguous()
    uut = torch.cat([u.T, u.T]).contiguous()
    alpha, alpha_prev = alpha.clone(), alpha.clone()
    gtt, bt, ydy = (x.contiguous() for x in known_block_grams(Rt, d, y))
    dmax2 = d.max() ** 2
    scal = torch.zeros(N_SCAL, device=y.device, dtype=y.dtype)
    scal[A_U] = scal[A_ALPHA] = 1.0
    scal[L_W] = scal[L_W_PREV] = torch.sum(alpha[-N_U:] ** 2) * dmax2
    scal[L_H_PREV] = (torch.sum(Rt * Rt) + torch.sum(u * u)) * dmax2
    scal[RT_SQ], scal[DMAX2] = torch.sum(Rt * Rt), dmax2

    def run():
        for _ in range(n_iter):
            gu, bu, usq = u_phase_grams(ydt, rtt, alpha[:-N_U],
                                        alpha[-N_U:], uut, scal, N_INNER)
            alpha_phase_full(gtt, bt, gu, bu, usq, ydy, alpha, alpha_prev,
                             scal, N_INNER, N_U)
    return median_ms(run, reps=3, warmup=1) / n_iter


def phase_main_path(problem32, card):
    import torch

    from demethify_tpu_torch import state
    from demethify_tpu_torch.ops import cuda_kernels, cuda_small
    from demethify_tpu_torch.solvers.api import partial_reference_deconv

    t = state.from_numpy(*problem32, device="cuda", dtype=torch.float32)
    u0, a0, y, d, Rt = t
    enqueue_ms = _enqueue_only_ms(t, 200)
    kw = dict(n_iter1=N_OUTER, n_iter2=N_INNER, tol=0.0, record_trace=True)
    partial_reference_deconv(y, d, Rt, N_U, init_provided=(u0, a0),
                             **dict(kw, n_iter1=5))                # warm
    torch.cuda.synchronize()

    cuda_kernels.u_phase_grams.launches = 0
    cuda_small.alpha_phase_full.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    res = partial_reference_deconv(y, d, Rt, N_U, init_provided=(u0, a0),
                                   **kw)
    stop.record()
    stop.synchronize()
    wall = time.perf_counter() - t0
    launches = {"u_phase_grams": cuda_kernels.u_phase_grams.launches,
                "alpha_phase_full": cuda_small.alpha_phase_full.launches}
    ms_iter = start.elapsed_time(stop) / N_OUTER
    rate = N_CPG * N_OUTER / (start.elapsed_time(stop) / 1e3)
    host_share = max(0.0, 1.0 - enqueue_ms / ms_iter)
    log(f"[main] bench workload 1M x 10, 5+1, float32, {N_OUTER}x{N_INNER}, "
        f"tol=0 via solvers.api.partial_reference_deconv: {ms_iter:.4f} ms "
        f"per outer iteration (CUDA events), {rate:.4e} site-iters/s, wall "
        f"{wall:.3f} s; same launches without the per-iteration cost read "
        f"{enqueue_ms:.4f} ms/iter -> host-read share {host_share:.3f}; "
        f"launches K1 {launches['u_phase_grams']} K2 "
        f"{launches['alpha_phase_full']}; card {card}")
    check(res.n_iter == N_OUTER, "main path ran the wrong iteration count")
    check(all(v == N_OUTER for v in launches.values()),
          f"launch counts {launches} != {N_OUTER} outer iterations")
    props = res.proportions
    check(res.u.shape == (N_CPG, N_U) and props.shape == (N_CT + N_U, N_S),
          "main path output shapes")
    check(bool(torch.isfinite(props).all()) and bool(
        torch.isfinite(res.u).all()), "non-finite main path output")
    check(float((props.sum(0) - 1).abs().max()) < 1e-4, "alpha off simplex")
    check(float(res.u.min()) >= 0 and float(res.u.max()) <= 1, "u off [0,1]")
    trace = res.trace.cpu().numpy()
    check(np.isfinite(trace).all() and trace[-1] < trace[0],
          "cost did not decrease")

    # the plain solver on the card, same workload, as the reference. In
    # float32 the two agree on the final cost; alpha drifts apart along
    # the objective's flat direction (rounding amplified over 1000
    # iterations), so it is reported here and held tightly in float64.
    from demethify_tpu_torch.solvers.fused import partial_ref_solve_fused
    from demethify_tpu_torch.solvers.partial_ref import partial_ref_solve
    t1 = time.perf_counter()
    start.record()
    _, a_p, info_p = partial_ref_solve(u0, a0, y, d, Rt, N_U, **kw)
    stop.record()
    stop.synchronize()
    plain_ms = start.elapsed_time(stop) / N_OUTER
    c_k, c_p = float(res.cost), float(info_p["cost"])
    err_c = abs(c_k - c_p) / abs(c_p)
    err_a = float((props - a_p).abs().max())
    log(f"[main] plain solver, same workload: {plain_ms:.4f} ms per outer "
        f"iteration ({time.perf_counter() - t1:.3f} s); final cost kernel "
        f"{c_k:.6e} plain {c_p:.6e} (rel diff {err_c:.3e}, tol "
        f"{TRAJ_TOL['float32']['cost']:.0e}); alpha max|diff| {err_a:.3e} "
        f"(float32 drift, not held)")
    check(err_c <= TRAJ_TOL["float32"]["cost"], "final cost vs plain")

    t64 = state.from_numpy(*problem32, device="cuda", dtype=torch.float64)
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


# ---------------------------------------------------------------- phase 6
def _write_fixture(root, n=50_000, seed=7):
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


def phase_cli():
    from demethify_tpu_torch.cli import main as cli_main
    from demethify_tpu_torch.ops import cuda_kernels, cuda_small

    with tempfile.TemporaryDirectory() as root:
        samples, ref = _write_fixture(root)
        for mode, extra in (("supervised", []),
                            ("partial-ref", ["--nbunknown", "1",
                                             "--iterations", "500", "20"])):
            before = (cuda_kernels.u_phase_grams.launches,
                      cuda_small.alpha_phase_full.launches)
            outdir = os.path.join(root, mode)
            t0 = time.perf_counter()
            rc = cli_main(["--methfreq", *samples, "--ref", ref,
                           "--bedmethyl", "--noprint", "--outdir", outdir,
                           "--device", "cuda", *extra])
            wall = time.perf_counter() - t0
            check(rc == 0, f"CLI {mode} exit {rc}")
            path = os.path.join(outdir, "celltypes_proportions.csv")
            with open(path) as f:
                header = f.readline().strip().split(",")
                rows = [ln.strip().split(",") for ln in f if ln.strip()]
            props = np.array([[float(x) for x in r[1:]] for r in rows])
            check(header[0] == "Cell types" and len(header) == N_S + 1,
                  "CLI header")
            check(np.abs(props.sum(axis=0) - 1).max() <= 1e-5,
                  f"CLI {mode} proportions do not sum to 1")
            moved = (cuda_kernels.u_phase_grams.launches - before[0],
                     cuda_small.alpha_phase_full.launches - before[1])
            if mode == "partial-ref":
                check(os.path.exists(os.path.join(
                    outdir, "methylation_profile_estimate.csv")),
                    "CLI profile file missing")
                check(min(moved) > 0, "CLI partial-ref launched no kernel")
                check(props.shape == (N_CT + 1, N_S), "CLI shape")
            log(f"[cli] {mode}: exit 0 in {wall:.2f} s, proportions "
                f"{props.shape} column sums within "
                f"{np.abs(props.sum(axis=0) - 1).max():.1e} of 1, launches "
                f"K1 +{moved[0]} K2 +{moved[1]}")


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
    phase_solver_trajectory(make_problem(np.float64, seed=1,
                                         n_cpg=200_000))
    launches = phase_main_path(make_problem(np.float32, seed=0), card)
    phase_cli()
    check("jax" not in sys.modules, "jax was imported")
    kernels = {"kernels": [
        {"name": "u_phase_grams", "route": "cuda",
         "source": "demethify_tpu_torch/csrc/u_phase_grams.cu",
         "replaces": "demethify_tpu/ops/pallas_kernels.py:218",
         "launches": launches["u_phase_grams"],
         "max_abs_err": k1["u_max_abs"], "ms": k1["ms"],
         "plain_ms": k1["plain_ms"]},
        {"name": "alpha_phase_full", "route": "cuda",
         "source": "demethify_tpu_torch/csrc/alpha_phase_full.cu",
         "replaces": "demethify_tpu/ops/pallas_small.py:261",
         "launches": launches["alpha_phase_full"],
         "max_abs_err": k2["alpha_max_abs"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"]}]}
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
