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
   without a known block (p = 3); then the redesigned pieces of K1 and
   K2: the momentum tables of the prologue kernel against
   ``momentum_table_plain`` bit for bit (float32, float64; 0, 1, 20 and
   500 steps; l = 0 and NaN; K1's, K4's and K7's slots), the Gram
   stage's plan against the kernels' export, K2 at each row bucket and
   at the cohort shape (p = 29, n_s = 100, several blocks: a second
   launch bit-identical, and K5's member bit-identical to K2); then the
   redesigned pieces of K4 and K3: K4's member plan and Gram-stage plan
   against the kernels' exports (B 1-32, n_u 1, 3, 8, 12, both layouts,
   weighted), K3's row bucket against ``alpha_plan`` at p = 3, 6, 12,
   29 with K3 against its twin there, K3 at n_s = 100 (several blocks)
   in float32 and float64, and a second launch of K4 (B = 16) and of K3
   (p = 29, n_s = 100) bit-identical to the first;
5. K3 ``fw_phase_full`` against its twin at p = 6 and p = 26, 500
   Frank-Wolfe steps, float32 and float64, with the count of (step,
   column) vertex choices that differ from the twin's at the same iterate;
   then the multi-member kernels of the batched restarts against their
   twins, float32 and float64, with some members inactive (their state
   must come back bit-unchanged) and one active member against the
   single-member kernel on its own inputs (bit for bit, held for K4
   and K6, reported for K5): K4
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
   with its partial buffer; the n_u > 8 form (its state on the chip):
   n_u in {9, 12, 16, 17} in K1's gram form and {9, 12, 16, 25} in its
   direct form, the sweep's rank 25 at 1M x 10, bf16 data and
   bf16_compute, n_u in {9, 12, 16} in K4 (bf16, weighted), and the state
   region in device memory (5 + 18 at n_s = 108), each timed beside its
   bound with its launches counted; p in {33, 40, 64} in K2, K3, K5 and
   K6; above 64 rows K3's and K6's column blocks (a block, or a cluster
   of blocks, a column; p = 65-240, K6 with an inactive member and
   per-member known blocks), and past eight blocks the clusters of 9-16
   blocks and the device rows past 16 of K2, K3, K5, K6, K9 and K10 (p =
   453-2000, 16,484 in float32, ``phase_column_rows``); past one block's
   shared memory, K1's and K4's global layout (weighted too) and K2's and
   K5's column blocks at p = 200-240, each timed; K2 and K5 with row
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
9. the single-phase kernels, which no solver runs: K7 ``u_phase``
   against its twin at the main path's shape (1M x 10, 5 + 1, 20 steps)
   in float32, float64 and bf16 data, lagged without a known block
   (n_u = 3), at 500 steps, at the cohort shape (1M x 100, 25 + 4,
   float32), n_u = 12 (5 + 12, n_s = 100, float64, 200k sites) and a
   ragged N, each timed beside K1 on the same data; K8 ``grams``, on the
   tensor cores (its SASS holds HMMA and DMMA), at 1M x 10, p = 6 and at
   1M x 100, p = 29, in float32, float64 and bf16 data, with the PyTorch
   calls that compute the same sums timed beside it (float32), untimed at
   a ragged N (200,003 sites; K7's untimed forms at 200k sites too),
   n_s = 1 / p = 1, n_s = 13 / p = 11 and p = 64 / n_s = 500
   (float64), each launched twice to the same bits, and on bf16 data at
   200 sites, where its rounding shows, against its twin's rounding
   summed in float64 and apart from ``ops/gram.sample_grams``; K9
   ``alpha_phase`` (p = 6, 20 steps, float32 and float64; masked; p = 40,
   n_s = 100, float64) and K10 ``fw_phase`` (p = 6, 500 steps, float32
   and float64, with its vertex flips; p = 40, float64), each also on
   K2's or K3's assembled Grams against K2's or K3's bits; the composed
   unfused outer iteration K7 -> K8 -> K9 (``composed_solve``) against
   ``partial_ref_solve`` from the same inits (200k x 10, float64,
   20 x 20) and timed at full width (1M x 10, float32, 1000 x 20,
   tol = 0) beside the fused main path of phase 7, with its launches;
10. CLI: a simulated 50,000-site bedmethyl fixture through
   ``demethify_tpu_torch.cli.main`` in all four modes on ``--device cuda``,
   with ``--restart 4`` in the three iterative modes, and with
   ``--confidence 95 8`` under both ``--cimethod`` layouts in all four;
11. the kernels past one block's shared memory on paths, the SVD/ICA
   inits and model selection, after the CLI: partial-reference at
   p = 210 and purity at p = 180, 4 restarts of each at p = 209 and the
   purity weights bootstrap at p = 209 (float64, 20k x 10) through
   ``solvers.api`` and ``bootstrap_ci``, with launch counts that show K1's
   and K4's global layout and K2's, K3's, K5's and K6's column blocks
   (clusters of two blocks a column), each held to the
   plain solver (``phase_past_envelope``); ``tall_svd``, NNDSVD,
   the dual ICA at 1M x 10, the primal ICA at 4096 x 10 and the three
   modes' SVD and ICA inits at 1M x 10, card against CPU in float64,
   timed in float64 and float32 (``phase_inits``); ``evaluate_best_ic``
   at 1M x 10, 5
   known, float32 (AIC with SVD inits to 25 unknowns, minka, CCC with 5
   restarts and BCV with 5 folds to 6; 100 x 20 a solve, the depth cut)
   with its launches and the solve time per rank, each criterion first
   held card against CPU at 20k sites in float64 on injected draws (AIC
   to 25 unknowns, every form the full-width sweep takes)
   (``phase_sweep``); and the CLI with ``--init SVD|ICA`` in the three
   iterative modes and ``--ic AIC|BIC|CCC|BCV|minka`` (``--init SVD
   --icmax 3``), card against ``--device cpu`` (``phase_cli_inits_ic``);
12. the row-sharded runs (``phase_ranks``): two ranks on the one card
   (processes of this script, ``--ranks-worker``, over gloo) run the
   row-sharded solvers at 1M x 10 (partial-reference float32 and float64
   50 x 20, purity 10 x 500, unsupervised, the partial-reference and
   purity multi solvers at B = 4, the row-sharded weights bootstrap at
   B = 8, 30 x 20), each held to the one-rank kernel solve on the card,
   every rank with the same bits, and the launches of each rank one per
   kernel and outer iteration; where the machine has several cards, one
   rank a card over NCCL too; then the CLI with ``--multihost`` as two
   processes against the one-process CLI (float64, the phase-10 fixture:
   ``--confidence 90 7 --restart 4`` with ``--savestate``, ``--ic AIC
   --icmax 3``, a warm start from ``--initstate``), and ``--shard`` over
   the cards where there are several (``phase_ranks_cli``);
13. the CLI's last flags, the host tools and the 2-D layout:
   ``--profile`` (the CLI at 1M x 10, float32, 50 x 20: K1's main pass
   and K2 in the program's own trace as often as their counters count
   them, each kernel's device time, the CSVs the same bytes as without
   the flag), ``--debugnans`` (the same bytes; the main path's ms per
   outer iteration with and without it; a NaN input exits non-zero with
   FloatingPointError) (``phase_observability``); the feature
   selection's device path at 2M x 25, float32, against numpy float64
   (``phase_feature_selection``); simulate -> select -> intersect ->
   deconvolve on the card against ``--device cpu``, and ``--plot``
   (``phase_pipeline``); ``--multihost --shard`` as 2 processes x 2
   workers on the one card over gloo at 200k x 10, float64 against the
   one-process CLI, and the same routes through the API for each
   worker's launches and ms per outer iteration (``phase_layout``,
   ``--layout-worker`` processes);
14. the row-distributed set-up (``phase_row_init``): two ranks on the
   one card (``--row-init-worker`` processes, gloo), each making only its
   rows of a 4M x 100 problem (25 + 4, float32, in seeded row chunks),
   run the inits uniform_, uniform, SVD and ICA (dual) and the
   row-sharded solve after each, the supervised WLS, one weights-
   bootstrap chunk (B = 8) and one CCC sweep rank, each against the
   one-rank run of the same routes, with each rank's init time, peak
   device memory beside its rows' bytes and launches (K1 + K2, K4 + K5).

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
# the outer iterations over which phase_main_path holds the float32 main
# path to the plain solver (its float64 pair runs all N_OUTER)
MAIN_PLAIN_OUTER = 200


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


def launch_peak_bytes(fn):
    """Device memory one call of ``fn`` takes at its peak beyond what was
    allocated before the call (its outputs and scratch buffers), bytes."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


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
    k7, k8 = cuda_kernels.u_phase, cuda_kernels.grams
    k9, k10 = cuda_small.alpha_phase, cuda_small.fw_phase
    return ((k7, "forms:state_in_device",
             "u_phase{n_u>8, state in device memory}"),
            (k9, "forms:masked", "alpha_phase{masked}"),
            (k9, "forms:two_row", "alpha_phase{two-row}"),
            (k9, "forms:column_blocks", "alpha_phase{column blocks}"),
            (k9, "forms:device_rows", "alpha_phase{device rows}"),
            (k10, "forms:two_row", "fw_phase{two-row}"),
            (k10, "forms:column_blocks", "fw_phase{column blocks}"),
            (k10, "forms:device_rows", "fw_phase{device rows}"),
            (k7, "launches", "u_phase"),
            (k7, "launches_bf16", "u_phase[bf16]"),
            (k8, "launches", "grams"),
            (k8, "launches_bf16", "grams[bf16]"),
            (k9, "launches", "alpha_phase"),
            (k10, "launches", "fw_phase"),
            (k1, "forms:wide", "u_phase_grams{wide}"),
            (k1, "forms:global_layout", "u_phase_grams{global}"),
            (k1, "forms:state_on_chip", "u_phase_grams{n_u>8, state on chip}"),
            (k1, "forms:state_in_device",
             "u_phase_grams{n_u>8, state in device memory}"),
            (k1, "forms:bf16c_direct", "u_phase_grams{bf16_compute direct}"),
            (k1, "forms:rt_folded", "u_phase_grams{rt folded}"),
            (k4, "forms:wide", "u_phase_grams_multi{wide}"),
            (k4, "forms:global_layout", "u_phase_grams_multi{global}"),
            (k4, "forms:state_on_chip",
             "u_phase_grams_multi{n_u>8, state on chip}"),
            (k4, "forms:state_in_device",
             "u_phase_grams_multi{n_u>8, state in device memory}"),
            (k2, "forms:wide", "alpha_phase_full{p>32}"),
            (k2, "forms:two_row", "alpha_phase_full{two-row}"),
            (k2, "forms:device_rows", "alpha_phase_full{device rows}"),
            (k2, "forms:column_blocks", "alpha_phase_full{column blocks}"),
            (k2, "forms:masked", "alpha_phase_full{masked}"),
            (k3, "forms:wide", "fw_phase_full{p>32}"),
            (k3, "forms:two_row", "fw_phase_full{two-row}"),
            (k3, "forms:device_rows", "fw_phase_full{device rows}"),
            (k3, "forms:column_blocks", "fw_phase_full{column blocks}"),
            (k5, "forms:wide", "alpha_phase_full_multi{p>32}"),
            (k5, "forms:two_row", "alpha_phase_full_multi{two-row}"),
            (k5, "forms:device_rows",
             "alpha_phase_full_multi{device rows}"),
            (k5, "forms:column_blocks",
             "alpha_phase_full_multi{column blocks}"),
            (k5, "forms:masked", "alpha_phase_full_multi{masked}"),
            (k6, "forms:wide", "fw_phase_full_multi{p>32}"),
            (k6, "forms:two_row", "fw_phase_full_multi{two-row}"),
            (k6, "forms:device_rows", "fw_phase_full_multi{device rows}"),
            (k6, "forms:column_blocks",
             "fw_phase_full_multi{column blocks}"),
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
# outside the tensor cores, 67 TFLOP/s float64 on them). K8 runs on the
# tensor cores, so its bound takes its route's rate: 3xTF32 forms each
# float32 product from three TF32 products (495 / 3 TFLOP/s), DMMA
# float64 at 67 TFLOP/s, bf16 MMA at 989 TFLOP/s.
HBM_BYTES_S = 3.35e12
PEAK_FLOP_S = {"float32": 67e12, "float64": 67e12, "3xTF32": 495e12 / 3,
               "DMMA": 67e12, "bf16 MMA": 989e12}
# K8's route by data type
K8_ROUTE = {"float32": "3xTF32", "float64": "DMMA", "bfloat16": "bf16 MMA"}


def bound(n_bytes, flops, dtype_name):
    """(bound_ms, bound_by) of work of n_bytes and flops, the operations
    at the rate of ``dtype_name`` (a type, or a tensor-core route of
    ``PEAK_FLOP_S``)."""
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
    known-block residual (with d y), the FISTA steps in whichever of the
    two forms needs fewer, and the Gram sums of the new u (d_s u_v formed
    once per (s, v), then a multiply-add per [Rt|u] row; b_u a
    multiply-add per (v, s) on the d y already formed; sum u^2) plus,
    weighted, the n_u products w u_v. The gram form builds C and M (each
    pair product a2[u,s] a2[v,s] formed once per launch and member, then
    one multiply by d and one add per site) and steps at 6 n_u + 2 n_u^2;
    the direct form builds nothing and steps at 3 n_u for the momentum
    point, 2 n_u n_s for the model, 2 n_s for the weighted residual,
    2 n_u n_s for the gradient and 4 n_u for the update. The scalar
    momentum chain, the same for every site, is not counted, nor are the
    conversions of bf16 data (one per value read) or bf16_compute's
    roundings."""
    p = n_ct + n_u
    pairs = n_u * (n_u + 1) // 2
    n_bytes = n * (data_itemsize * (2 * n_s + n_ct)
                   + itemsize * n_members * (4 * n_u + int(weighted)))
    gram = n * (n_s * (2 * n_u + 2 * pairs)
                + steps * (6 * n_u + 2 * n_u * n_u)) + n_s * pairs
    direct = n * steps * (7 * n_u + 4 * n_u * n_s + 2 * n_s)
    per_site = (n_s * (2 * n_ct + 3) + 2 * n_s * n_u * p + n_s * n_u
                + 2 * n_u * n_s + 2 * n_u + n_u * int(weighted))
    return n_bytes, (per_site * n + min(gram, direct)) * n_members


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
    log(f"[build] {lib.path} in {lib.build_seconds:.2f} s; seconds to each "
        f"source's object: {lib.source_seconds}")
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
        res["launch_peak_bytes"] = launch_peak_bytes(lambda: u_phase_grams(
            ydt, rtt, a1, a2, uk, sk, steps, lagged, **form_kw))
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
           f"{res['bound_ms']:.4f} ms ({res['bound_by']}); a launch's peak "
           f"device memory {res['launch_peak_bytes'] / 1e6:.1f} MB" if timed
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
             mask=None, n_s=N_S, reps=7, inner=20):
    """K2 against its twin; ``mask`` (p,) its row mask, then also held
    bit-identical to the unmasked launch when all ones. ``timed``: medians
    of ``reps`` runs of ``inner`` launches."""
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
            *args, ak, apk, sk, N_INNER, n_u, **mask_kw), reps=reps,
            inner=inner)
        res["queued_ms"] = queued_ms(lambda: alpha_phase_full(
            *args, ak, apk, sk, N_INNER, n_u, **mask_kw), reps=reps,
            inner=inner)
        res["plain_ms"] = median_ms(lambda: alpha_phase_full_plain(
            *args, ap_, app, sp, N_INNER, n_u, *mask_kw.values()),
            reps=reps, inner=inner)
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
        + (f"; kernel {res['ms']:.4f} ms ({res['queued_ms']:.4f} ms queued "
           f"behind a device sleep), plain {res['plain_ms']:.4f} ms "
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


# ------------------------------------------------------------ phase 4b
# The redesigned pieces of K1 and K2 (their source notes): the momentum
# table K1, K4 and K7 compute once per launch, the Gram stage's plan, and
# K2's row buckets and multi-block grid with its fixed cost order.

# (label, a, l_prev, l): the regular chain, and the NaN cases the table
# must keep (l_w = 0: 0/0 from step 1 on; NaN; l_prev = 0 at step 0)
TABLE_CASES = (("regular", 2.5, 0.9, 1.0), ("l = 0", 2.5, 0.9, 0.0),
               ("l = NaN", 2.5, 0.9, float("nan")),
               ("l_prev = 0", 1.0, 0.0, 3.0))
# (n_c, n_u, p, usq): the main shape, the cohort shape resident and in a
# wide chunk (and its ragged last chunk), n_u > 8, and small shapes
GRAM_PLAN_SHAPES = ((10, 1, 6, True), (100, 4, 29, True),
                    (32, 4, 29, False), (4, 4, 29, True),
                    (100, 12, 17, True), (10, 12, 17, True),
                    (10, 3, 3, True), (1, 2, 7, True), (64, 1, 26, True),
                    (10, 5, 10, True), (25, 9, 34, False))


def same_bits(x, y):
    """x and y hold the same values bit for bit, NaN for NaN (the card's
    and the CPU's NaN payloads differ)."""
    import torch

    x, y = x.cpu(), y.cpu()
    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    nan = torch.isnan(x)
    if not torch.equal(nan, torch.isnan(y)):
        return False
    iv = {torch.float32: torch.int32, torch.float64: torch.int64}[x.dtype]
    return torch.equal(x.view(iv)[~nan], y.view(iv)[~nan])


def ieee_momentum_table(a, l_prev, lip, n_steps, dtype):
    """The momentum table in numpy scalars of ``dtype`` (float32 or
    float64: IEEE arithmetic, correctly rounded division and square root),
    in the kernels' order: beta_k = min_nan((a_k - 1) / a_{k+1},
    0.9999 sqrt(l_prev_k / lip)), a_{k+1} = (1 + sqrt(1 + (4 a_k) a_k)) / 2,
    then a_{n_steps}. PyTorch's float32 square root on the CPU is not
    always correctly rounded (it gives 22.778767 for sqrt(518.87225), not
    22.778769), so the CPU twin is no bit reference in float32."""
    nt = np.dtype(dtype).type
    one, two, four, cap = nt(1), nt(2), nt(4), nt(0.9999)
    a, lp, lip = nt(a), nt(l_prev), nt(lip)
    out = []
    with np.errstate(all="ignore"):
        for _ in range(n_steps):
            a1 = (one + np.sqrt(one + four * a * a)) / two
            x, y = (a - one) / a1, cap * np.sqrt(lp / lip)
            out.append(x if (x < y or x != x) else y)
            a, lp = a1, lip
    out.append(a)
    return np.array(out, dtype=dtype)


def phase_redesign():
    """The momentum tables of the prologue kernel on the card against the
    IEEE chain in numpy (``ieee_momentum_table``), bit for bit, and beside
    them ``momentum_table_plain`` run on the card (float32, float64; 0, 1,
    20, 500 steps; l = 0 and NaN; K1's vector, K4's member rows and K7's
    single-phase vector with its output slots); the Gram stage's plan
    (``dm_gram_tile_plan``) against ``gram_tile_plan``; K2 at every row
    bucket and at the cohort shape (p = 29, n_s = 100: 13 blocks, the
    ticketed fixed-order cost) against its twin, the same bits on a second
    launch (the tickets reset), and K5 there with one member against K2
    bit for bit. Returns K2's timed cohort case."""
    import ctypes

    import torch

    from demethify_tpu_torch.ops import _build
    from demethify_tpu_torch.ops.cuda_kernels import (
        A_U, L_W, L_W_PREV, N_SCAL, N_SCAL_MULTI, PH_A, PH_A_OUT, PH_L,
        PH_L_PREV, PH_L_PREV_OUT, gram_tile_plan, momentum_table,
        momentum_table_plain)
    from demethify_tpu_torch.ops.cuda_small import alpha_plan

    bad, twin_same, n_checked = [], 0, 0
    for dt in (torch.float32, torch.float64):
        npdt = np.float32 if dt == torch.float32 else np.float64
        for steps in (0, 1, 20, 500):
            for label, a, lp, lip in TABLE_CASES:
                sc = torch.zeros(N_SCAL, dtype=dt)
                sc[A_U], sc[L_W_PREV], sc[L_W] = a, lp, lip
                rows = torch.zeros((3, N_SCAL_MULTI), dtype=dt)
                rows[:, A_U] = torch.tensor([a, a + 1.0, 1.0], dtype=dt)
                rows[:, L_W_PREV] = torch.tensor([lp, 2.0, lp], dtype=dt)
                rows[:, L_W] = torch.tensor([lip, 3.0, lip], dtype=dt)
                ph = torch.zeros(5, dtype=dt)
                ph[PH_A], ph[PH_L], ph[PH_L_PREV] = a, lip, lp
                for name, vec, slots in (
                        ("K1", sc, (A_U, L_W_PREV, L_W)),
                        ("K4", rows, (A_U, L_W_PREV, L_W)),
                        ("K7", ph, (PH_A, PH_L_PREV, PH_L))):
                    rows_in = vec.reshape(-1, vec.shape[-1])
                    want = torch.from_numpy(np.stack([
                        ieee_momentum_table(*(float(r[k]) for k in slots),
                                            steps, npdt) for r in rows_in]))
                    on_card = vec.to(DEV)
                    got = momentum_table(on_card, steps,
                                         phase=name == "K7").reshape(
                                             want.shape)
                    ok = same_bits(got, want)
                    if name == "K7":
                        out = on_card.cpu()
                        l_out = ph[PH_L] if steps > 0 else ph[PH_L_PREV]
                        ok = (ok and same_bits(out[PH_A_OUT], want[0, -1])
                              and same_bits(out[PH_L_PREV_OUT], l_out))
                    card_rows = vec.to(DEV).reshape(-1, vec.shape[-1])
                    twin = torch.stack([momentum_table_plain(
                        *(r[k] for k in slots), steps) for r in card_rows])
                    twin_same += same_bits(twin, want)
                    n_checked += 1
                    if not ok:
                        bad.append((str(dt), steps, label, name))
    log(f"[redesign] momentum tables of the prologue kernel against the "
        f"IEEE chain in numpy: {n_checked} cases, {len(bad)} not "
        f"bit-identical {bad[:5]}; momentum_table_plain on the card "
        f"bit-identical to it in {twin_same} of {n_checked}")
    check(not bad, "momentum tables differ from the IEEE chain")

    lib = _build.load().lib
    plan_bad = []
    keys = ("tiled", "rs", "rv", "ts", "tv", "tq", "n_tiles", "n_items")
    for n_c, n_u, p, usq in GRAM_PLAN_SHAPES:
        out = (ctypes.c_int * 8)()
        lib.dm_gram_tile_plan(n_c, n_u, p, int(usq), out)
        want = gram_tile_plan(n_c, n_u, p, usq)
        if list(out) != [int(want[k]) for k in keys]:
            plan_bad.append(((n_c, n_u, p, usq), list(out), want))
    log(f"[redesign] Gram stage plans: {len(GRAM_PLAN_SHAPES)} shapes, "
        f"dm_gram_tile_plan against gram_tile_plan, {len(plan_bad)} differ "
        f"{plan_bad[:3]}")
    check(not plan_bad, "Gram stage plans differ from the kernels'")

    for n_ct, n_u in ((7, 1), (10, 2), (28, 4)):     # buckets 8, 16, 32
        log(f"[redesign] K2 row bucket {alpha_plan(n_ct + n_u, N_S)[0]} at "
            f"p = {n_ct + n_u}:")
        _k2_case(n_ct, "float64", n_u=n_u, seed=40 + n_ct)
    n, n_s, n_ct, n_u = COHORT
    cohort = None
    for dt in ("float32", "float64"):
        res = _k2_case(n_ct, dt, n_u=n_u, n_s=n_s, seed=44,
                       timed=dt == "float32")
        cohort = cohort or res
    again = _k2_repeat(n_ct, n_u, n_s)
    log(f"[redesign] K2 at p = {n_ct + n_u}, n_s = {n_s} (plan "
        f"{alpha_plan(n_ct + n_u, n_s)}): a second launch from the same "
        f"inputs bit-identical: {again}")
    check(again, "K2's multi-block launch does not repeat its bits")
    k5 = _k5_case(n_ct, n_u, "float32", 4, (1,), seed=45, n_s=n_s)
    check(k5["member_equals_k2"], "K5's member differs from K2 at n_s = 100")
    return cohort


# K4's member plan: (itemsize, n_s, n_ct, n_u, weighted) at B = 1-32,
# in both layouts (the resident shapes of the restart and bootstrap paths,
# the cohort's, n_u > 8)
K4_PLAN_SHAPES = ((4, 10, 5, 1, False), (8, 10, 5, 1, False),
                  (4, 10, 5, 1, True), (8, 10, 5, 1, True),
                  (4, 10, 0, 3, False), (4, 10, 5, 8, False),
                  (4, 10, 5, 12, True), (4, 100, 25, 4, False),
                  (8, 100, 25, 4, True), (8, 100, 5, 12, False),
                  (4, 500, 25, 4, False), (8, 37, 7, 3, True),
                  (8, 64, 160, 4, False), (8, 10, 205, 4, True))
K4_PLAN_MEMBERS = (1, 2, 3, 8, 16, 17, 32)
# K3's row buckets: p = 3, 6, 12, 29 (buckets 8, 8, 16, 32)
K3_BUCKET_P = (3, 6, 12, 29)


def phase_redesign_k4k3():
    """The redesigned pieces of K4 and K3 (their source notes): K4's
    member plan (``dm_k4_member_plan`` against ``k4_member_plan`` at
    B = 1-32, n_u 1, 3, 8, 12, the three layouts, weighted or not) and its
    Gram stage's items (``dm_k4_gram_plan`` against ``k4_gram_plan``);
    K3's row bucket (``dm_row_bucket`` against ``alpha_plan``) at
    p = 3, 6, 12, 29, each against its twin; K3 at n_s = 100 (blocks of
    8 columns, the ticketed cost) against its twin in float32 and
    float64; and two launches from the same inputs giving the same bits,
    K4 (B = 16, 1M x 10) and K3 (p = 29, n_s = 100)."""
    import ctypes

    import torch

    from demethify_tpu_torch.ops import _build
    from demethify_tpu_torch.ops.cuda_kernels import (
        DMAX2, u_phase_layout)
    from demethify_tpu_torch.ops.cuda_multi import (
        k4_gram_plan, k4_member_plan, u_phase_grams_multi)
    from demethify_tpu_torch.ops.cuda_small import alpha_plan, fw_phase_full

    lib = _build.load().lib
    bad, n_plans = [], 0
    g_keys = ("tiled", "ts", "tl", "tq", "tp", "tb", "n_x", "n_self", "n_bu",
              "n_usq", "o_self", "o_bu", "o_usq", "n_items")
    for it, n_s, n_ct, n_u, w in K4_PLAN_SHAPES:
        for code, layout in enumerate(("resident", "wide", "global")):
            for n_b in K4_PLAN_MEMBERS:
                want = k4_member_plan(it, n_s, n_ct, n_u, n_b, w, layout)
                out = (ctypes.c_longlong * 3)()
                lib.dm_k4_member_plan(it, n_s, n_ct, n_u, n_b, int(w), code,
                                      out)
                got = dict(zip(("group", "smem", "blocks"),
                               list(out)))
                n_c = min(32, n_s) if layout != "resident" else n_s
                gw = k4_gram_plan(n_c, n_ct, n_u, want["group"], True)
                gout = (ctypes.c_int * 14)()
                lib.dm_k4_gram_plan(n_c, n_ct, n_u, want["group"], 1, gout)
                n_plans += 1
                if got != want or list(gout) != [int(gw[k]) for k in g_keys]:
                    bad.append(((it, n_s, n_ct, n_u, w, layout, n_b), got,
                                want))
    log(f"[redesign] K4 member plans: {n_plans} (shape, layout, B), "
        f"dm_k4_member_plan and dm_k4_gram_plan against k4_member_plan and "
        f"k4_gram_plan, {len(bad)} differ {bad[:3]}; e.g. B = 16 at the "
        f"main shape: {k4_member_plan(4, N_S, N_CT, N_U, 16, False, 'resident')}"
        f", weighted B = 32: "
        f"{k4_member_plan(4, N_S, N_CT, N_U, 32, True, 'resident')}, the "
        f"cohort's B = 4: "
        f"{k4_member_plan(4, 100, 25, 4, 4, False, u_phase_layout('K4', 4, 100, 25, 4)[0])}")
    check(not bad, "K4 member plans differ from the kernels'")

    buckets = {p: (lib.dm_row_bucket(p), alpha_plan(p, N_S)[0])
               for p in K3_BUCKET_P}
    log(f"[redesign] K3 row buckets (dm_row_bucket, alpha_plan) by p: "
        f"{buckets}")
    check(all(a == b for a, b in buckets.values()),
          "K3's row bucket differs from alpha_plan's")
    for p in K3_BUCKET_P:
        _k3_case(p - N_U, "float32", seed=60 + p)
    for dt in ("float32", "float64"):
        _k3_case(28, dt, n_s=100, seed=61)

    ydt, rtt, alpha_b, uut_b, scal_b = _multi_inputs(
        N_CPG, N_S, N_CT, N_U, 16, torch.float32, 25, (3, 7, 11))
    runs = []
    for _ in range(2):
        u, sc = uut_b.clone(), scal_b.clone()
        runs.append((u, sc, *u_phase_grams_multi(
            ydt, rtt, alpha_b[:, :-N_U], alpha_b[:, -N_U:], u, sc, N_INNER)))
    act = [b for b in range(16) if b not in (3, 7, 11)]
    k4_same = all(torch.equal(x, y) for x, y in zip(runs[0][:2], runs[1][:2]))
    k4_same = k4_same and all(torch.equal(x[act], y[act])
                              for x, y in zip(runs[0][2:], runs[1][2:]))
    del ydt, rtt, alpha_b, uut_b, scal_b, runs
    gtt, bt, gu, bu, _, ydy, alpha, ydt, _, scal = _small_inputs(
        28, 1, "float32", 200_000, 62, 100)
    scal[DMAX2] = ydt[100:].max() ** 2
    purity = torch.linspace(0.3, 0.9, 100, device=DEV, dtype=alpha.dtype)
    k3 = []
    for _ in range(2):
        a, sc = alpha.clone(), scal.clone()
        fw_phase_full(gtt, bt, gu, bu, ydy, a, purity, sc, P_INNER, 1)
        k3.append((a, sc))
    torch.cuda.synchronize()
    k3_same = all(torch.equal(x, y) for x, y in zip(*k3))
    log(f"[redesign] a second launch from the same inputs bit-identical: K4 "
        f"(B = 16, 1M x 10) {k4_same}, K3 (p = 29, n_s = 100, "
        f"{alpha_plan(29, 100)}) {k3_same}")
    check(k4_same and k3_same, "K4 or K3 does not repeat its bits")


def _k2_repeat(n_ct, n_u, n_s):
    """K2 twice from the same inputs at a multi-block shape: the same
    bits (the member's tickets are back at zero after each launch)."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import (
        A_ALPHA, DMAX2, L_H_PREV, RT_SQ)
    from demethify_tpu_torch.ops.cuda_small import alpha_phase_full

    gtt, bt, gu, bu, usq, ydy, alpha, ydt, rtt, scal = _small_inputs(
        n_ct, n_u, "float32", 200_000, 46, n_s)
    scal[A_ALPHA], scal[RT_SQ], scal[DMAX2] = 1.8, torch.sum(rtt * rtt), (
        ydt[n_s:].max() ** 2)
    scal[L_H_PREV] = (scal[RT_SQ] + usq[0]) * scal[DMAX2]
    outs = []
    for _ in range(2):
        a, ap, sc = alpha.clone(), alpha.flip(0).contiguous(), scal.clone()
        alpha_phase_full(gtt, bt, gu, bu, usq, ydy, a, ap, sc, N_INNER, n_u)
        outs.append((a, ap, sc))
    torch.cuda.synchronize()
    return all(torch.equal(x, y) for x, y in zip(*outs))


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


def _k3_case(n_ct, dtype_name, timed=False, n=200_000, seed=9, n_s=N_S,
             reps=7, inner=20, steps=P_INNER):
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
    fw_phase_full(*args, ak, purity, sk, steps, N_U)
    ap_, sp = alpha.clone(), scal.clone()
    fw_phase_full_plain(*args, ap_, purity, sp, steps, N_U)
    torch.cuda.synchronize()
    err_a = float((ak - ap_).abs().max())
    scale = float(ydy.sum())
    err_c = abs(float(sk[COST]) - float(sp[COST])) / scale
    err_w = abs(float(sk[L_W]) - float(sp[L_W])) / abs(float(sp[L_W]))
    err_m = float((ak[:n_ct].sum(0) - purity).abs().max())
    flips = _fw_flips(*args, alpha, purity, scal, N_U, steps)
    tol_a = K3_TOL[dtype_name] + 4.0 * flips / steps
    tol_c = TOL[dtype_name]["cost"]
    p = n_ct + N_U
    res = {"p": p, "dtype": dtype_name, "alpha_max_abs": err_a,
           "cost_rel_to_sum_ydy": err_c, "l_w_rel": err_w,
           "flips": flips, "tol_alpha": tol_a}
    if timed:
        res["ms"] = median_ms(lambda: fw_phase_full(
            *args, ak, purity, sk, steps, N_U), reps=reps, inner=inner)
        res["plain_ms"] = median_ms(lambda: fw_phase_full_plain(
            *args, ap_, purity, sp, steps, N_U), reps=3, inner=1,
            warmup=1)
    log(f"[K3] p={p} n_s={n_s} {steps} steps {dtype_name}: alpha "
        f"max|diff| {err_a:.3e} (tol {tol_a:.1e}); vertex choices that "
        f"differ from the twin's at the same iterate: {flips} of "
        f"{2 * steps * n_s}; cost diff / sum(ydy) {err_c:.3e}, l_w rel "
        f"{err_w:.3e} (tol {tol_c:.0e}); known mass - purity {err_m:.2e}"
        + (f"; kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms "
           f"(median of back-to-back launches, CUDA events)" if timed
           else ""))
    check(np.isfinite([err_a, err_c, err_w]).all(), "K3 non-finite")
    check(err_a <= tol_a, f"K3 alpha differs from its twin by {err_a}")
    check(dtype_name == "float32" or flips == 0,
          f"K3 float64 vertex choices differ ({flips})")
    check(max(err_c, err_w) <= tol_c + 4.0 * flips / steps,
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
        u_phase_grams, u_phase_layout)
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
           "frozen_unchanged": frozen, "member_equals_k1": same_k1,
           "layout": u_phase_layout("K4", uut_b.element_size(), n_s, n_ct,
                                    n_u)[0]}
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
        res["launch_peak_bytes"] = launch_peak_bytes(
            lambda: u_phase_grams_multi(ydt, rtt, a1, a2, u_all, s_all, steps,
                                        lagged))
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
           f" partial buffer {res['partial_bytes'] / 1e6:.1f} MB, a launch's "
           f"peak device memory {res['launch_peak_bytes'] / 1e6:.1f} MB"
           if timed else ""))
    check(np.isfinite([err_u, err_g, err_b, err_q]).all(), "K4 non-finite")
    check(err_u <= tol["u"], f"K4 u differs from its twin by {err_u}")
    check(max(err_g, err_b, err_q) <= tol["gram"],
          f"K4 Grams differ from the twin by {max(err_g, err_b, err_q)}")
    check(err_s <= tol["gram"], f"K4 scalars differ by {err_s}")
    check(frozen, "K4 changed an inactive member")
    check(same_k1, f"K4's member {b0} differs from K1 on its inputs")
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
                       weighted=False, n_s=N_S, n=200_000):
    """Shared known blocks and B members' K4 blocks (from K4's twin) of an
    n-site problem, alpha stacks and scalar rows on the card; with
    ``weighted``, resample weights per member, each member's own weighted
    known blocks, ||Rt||^2 and surviving-row max coverage (the weighted
    bootstrap's operands)."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import (
        A_ALPHA, COST, DMAX2, L_H_PREV, RT_SQ, TOL)
    from demethify_tpu_torch.ops.cuda_multi import u_phase_grams_multi_plain
    from demethify_tpu_torch.ops.gram import known_block_grams

    dtype = getattr(torch, dtype_name)
    ydt, rtt, alpha_b, uut_b, scal_b = _multi_inputs(
        n, n_s, n_ct, n_u, n_b, dtype, seed, inactive)
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
            rt, ydt[n_s:].T, ydt[:n_s].T, w))
        rowmax = ydt[n_s:].max(0).values
        dmax2 = torch.where(w > 0, rowmax, 0.0).max(1).values ** 2
        rt_sq = w @ torch.sum(rt * rt, dim=1)
    else:
        gtt, bt, ydy = (x.contiguous() for x in known_block_grams(
            rt, ydt[n_s:].T, ydt[:n_s].T))
        dmax2 = ydt[n_s:].max() ** 2
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
             mask=None, n_s=N_S, n=200_000):
    """K5 against its twin; ``mask`` (B, p) the members' row masks, then
    also an all-ones mask held bit-identical to no mask."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import ACTIVE, COST, N_SCAL
    from demethify_tpu_torch.ops.cuda_small import (
        alpha_phase_full, alpha_phase_full_multi,
        alpha_phase_full_multi_plain)

    (gtt, bt, gu, bu, usq, ydy, alpha_b, alpha_prev_b,
     scal_b) = _glue_multi_inputs(n_ct, n_u, dtype_name, n_b, inactive, seed,
                                  n_s=n_s, n=n)
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
        n_bytes, flops = glue_work(p, n_s, n_ct, N_INNER,
                                   alpha_b.element_size(), n_b)
        res["bound_ms"], res["bound_by"] = bound(n_bytes, flops, dtype_name)
    log(f"[K5] B={n_b} (inactive {ina}) p={p} n_ct={n_ct} n_s={n_s} "
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
             n_ct=N_CT, n_s=N_S, reps=7, inner=10, steps=P_INNER,
             n=200_000):
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import ACTIVE, COST, L_W, N_SCAL
    from demethify_tpu_torch.ops.cuda_small import (
        fw_phase_full, fw_phase_full_multi, fw_phase_full_multi_plain)

    (gtt, bt, gu, bu, _, ydy, alpha_b, _,
     scal_b) = _glue_multi_inputs(n_ct, N_U, dtype_name, n_b, inactive, seed,
                                  n_s=n_s, n=n)
    rng = np.random.default_rng(seed)
    purity = torch.as_tensor(rng.uniform(0.3, 0.9, size=n_s), device=DEV,
                             dtype=alpha_b.dtype)
    alpha_b = torch.cat([
        alpha_b[:, :n_ct] / alpha_b[:, :n_ct].sum(1, keepdim=True) * purity,
        alpha_b[:, n_ct:] / alpha_b[:, n_ct:].sum(1, keepdim=True)
        * (1 - purity)], dim=1).contiguous()
    args = (gtt, bt, gu, bu, ydy)
    ak, sk = alpha_b.clone(), scal_b.clone()
    fw_phase_full_multi(*args, ak, purity, sk, steps, N_U)
    ap_, sp = alpha_b.clone(), scal_b.clone()
    fw_phase_full_multi_plain(*args, ap_, purity, sp, steps, N_U)
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
    flips = _fw_flips_multi(args, alpha_b, purity, scal_b, N_U, steps, act)
    b0 = act[0]
    a1, s1 = alpha_b[b0].clone(), scal_b[b0, :N_SCAL].clone()
    fw_phase_full(gtt, bt, gu[b0], bu[b0], ydy, a1, purity, s1, steps, N_U)
    torch.cuda.synchronize()
    same_k3 = torch.equal(a1, ak[b0]) and torch.equal(s1, sk[b0, :N_SCAL])
    tol_a = K3_TOL[dtype_name] + 4.0 * flips / steps
    tol_c = TOL[dtype_name]["cost"] + 4.0 * flips / steps
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
            *args, a_all, purity, s_all, steps, N_U), reps=reps,
            inner=inner)
        res["plain_ms"] = median_ms(lambda: fw_phase_full_multi_plain(
            *args, ap_, purity, sp, steps, N_U), reps=3, inner=1,
            warmup=1)
        n_bytes, flops = glue_work(n_ct + N_U, n_s, n_ct, steps,
                                   alpha_b.element_size(), n_b, fw=True)
        res["bound_ms"], res["bound_by"] = bound(n_bytes, flops, dtype_name)
    log(f"[K6] B={n_b} (inactive {ina}) p={n_ct + N_U} n_s={n_s} {steps} "
        f"steps {dtype_name}: active alpha max|diff| {err_a:.3e} (tol "
        f"{tol_a:.1e}); vertex choices that differ from the twin's at the "
        f"same iterate: {flips} of {2 * steps * n_s * len(act)}; cost "
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
    check(same_k3, f"K6's member {b0} differs from K3 on its inputs")
    return res


def phase_k6():
    main = _k6_case("float32", timed=True)
    _k6_case("float64")
    return main


# --------------------------------- phases 5e-5g: the weighted bootstrap's K4-K6
def _k4w_case(n_u, dtype_name, n_b, steps, n_ct=N_CT, lagged=False,
              inactive=(), seed=50, timed=False, label="", data=None,
              n=N_CPG, n_s=N_S):
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
        n, n_s, n_ct, n_u, n_b, dtype, seed, inactive)
    if data is not None:
        ydt = ydt.to(getattr(torch, data))
        rtt = None if rtt is None else rtt.to(ydt.dtype)
    w = resample_weights(n_b, n, dtype, seed)
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
    res = {"n": n, "n_ct": n_ct, "n_u": n_u, "members": n_b,
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
        n_bytes, flops = u_phase_work(n, n_s, n_ct, n_u, steps,
                                      uut_b.element_size(),
                                      ydt.element_size(), n_b, weighted=True)
        res["bound_ms"], res["bound_by"] = bound(n_bytes, flops, dtype_name)
        res["launch_peak_bytes"] = launch_peak_bytes(
            lambda: u_phase_grams_multi(ydt, rtt, a1, a2, u_all, s_all, steps,
                                        lagged, weights=w))
    log(f"[K4w]{label} N={n} n_s={n_s} n_ct={n_ct} n_u={n_u} B={n_b} "
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
           f"({res['bound_by']}), a launch's peak device memory "
           f"{res['launch_peak_bytes'] / 1e6:.1f} MB" if timed else ""))
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


def _k5w_case(n_ct, n_u, dtype_name, n_b, inactive, seed=60, timed=False,
              n=200_000):
    """K5 with per-member known blocks against its twin; and per-member
    copies of shared blocks against the shared-block launch, bit for
    bit."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import ACTIVE, COST, N_SCAL
    from demethify_tpu_torch.ops.cuda_small import (
        alpha_phase_full_multi, alpha_phase_full_multi_plain)

    (gtt, bt, gu, bu, usq, ydy, alpha_b, alpha_prev_b,
     scal_b) = _glue_multi_inputs(n_ct, n_u, dtype_name, n_b, inactive, seed,
                                  weighted=True, n=n)
    args = (gtt, bt, gu, bu, usq, ydy)
    ak, apk, sk = alpha_b.clone(), alpha_prev_b.clone(), scal_b.clone()
    alpha_phase_full_multi(*args, ak, apk, sk, N_INNER, n_u)
    ap_, app, sp = alpha_b.clone(), alpha_prev_b.clone(), scal_b.clone()
    alpha_phase_full_multi_plain(*args, ap_, app, sp, N_INNER, n_u)
    # the shared-block form (the restarts' K5) against per-member copies
    (sgtt, sbt, sgu, sbu, susq, sydy, s_alpha, s_prev,
     s_scal) = _glue_multi_inputs(n_ct, n_u, dtype_name, n_b, inactive,
                                  seed + 1, n=n)
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


def _k6w_case(dtype_name, n_b=8, inactive=(5,), seed=70, timed=False,
              n_ct=N_CT, n_s=N_S, steps=P_INNER, n=200_000):
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
         scal_b) = _glue_multi_inputs(n_ct, N_U, dtype_name, n_b, inactive,
                                      sd, weighted=weighted, n_s=n_s, n=n)
        if purity is None:
            purity = torch.as_tensor(rng.uniform(0.3, 0.9, size=n_s),
                                     device=DEV, dtype=alpha_b.dtype)
        alpha_b = torch.cat([
            alpha_b[:, :n_ct] / alpha_b[:, :n_ct].sum(1, keepdim=True)
            * purity,
            alpha_b[:, n_ct:] / alpha_b[:, n_ct:].sum(1, keepdim=True)
            * (1 - purity)], dim=1).contiguous()
        return (gtt, bt, gu, bu, ydy), alpha_b, scal_b

    args, alpha_b, scal_b = inputs(True, seed)
    ak, sk = alpha_b.clone(), scal_b.clone()
    fw_phase_full_multi(*args, ak, purity, sk, steps, N_U)
    ap_, sp = alpha_b.clone(), scal_b.clone()
    fw_phase_full_multi_plain(*args, ap_, purity, sp, steps, N_U)
    (sgtt, sbt, sgu, sbu, sydy), s_alpha, s_scal = inputs(False, seed + 1)
    outs = []
    for known in ((sgtt, sbt, sydy), _expanded(n_b, sgtt, sbt, sydy)):
        a, sc = s_alpha.clone(), s_scal.clone()
        fw_phase_full_multi(known[0], known[1], sgu, sbu, known[2], a,
                            purity, sc, steps, N_U)
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
    flips = _fw_flips_multi(args, alpha_b, purity, scal_b, N_U, steps, act)
    tol_a = K3_TOL[dtype_name] + 4.0 * flips / steps
    tol_c = TOL[dtype_name]["cost"] + 4.0 * flips / steps
    res = {"p": n_ct + N_U, "members": n_b, "inactive": ina,
           "dtype": dtype_name, "alpha_max_abs": err_a,
           "cost_rel_to_sum_ydy": err_c, "l_w_rel": err_w, "flips": flips,
           "frozen_unchanged": frozen, "shared_equals_copies": shared_same}
    if timed:
        s_all = scal_b.clone()
        s_all[:, ACTIVE] = 1.0
        a_all = alpha_b.clone()
        res["ms"] = median_ms(lambda: fw_phase_full_multi(
            *args, a_all, purity, s_all, steps, N_U), inner=10)
        res["plain_ms"] = median_ms(lambda: fw_phase_full_multi_plain(
            *args, ap_, purity, sp, steps, N_U), reps=3, inner=1,
            warmup=1)
        n_bytes, flops = glue_work(n_ct + N_U, n_s, n_ct, steps,
                                   alpha_b.element_size(), n_b, fw=True,
                                   own_known=True)
        res["bound_ms"], res["bound_by"] = bound(n_bytes, flops, dtype_name)
    log(f"[K6w] B={n_b} (inactive {ina}) p={n_ct + N_U} n_s={n_s} {steps} "
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

    # the plain solver on the card, same workload, as the reference over
    # its first MAIN_PLAIN_OUTER iterations (the kernel solve run again to
    # that depth; the plain solver takes about 30 ms an iteration). In
    # float32 the two agree on the final cost; alpha drifts apart along
    # the objective's flat direction (rounding amplified over many
    # iterations), so it is reported here and held tightly in float64.
    kw_p = dict(kw, n_iter1=MAIN_PLAIN_OUTER)
    (_, a_p, info_p), plain_ms = _per_iter_ms(
        lambda: partial_ref_solve(u0, a0, y, d, Rt, N_U, **kw_p),
        MAIN_PLAIN_OUTER)
    short = partial_reference_deconv(y, d, Rt, N_U, init_provided=(u0, a0),
                                      **kw_p)
    c_k, c_p = float(short.cost), float(info_p["cost"])
    err_c = abs(c_k - c_p) / abs(c_p)
    err_a = float((short.proportions - a_p).abs().max())
    log(f"[main] plain solver, same workload to {MAIN_PLAIN_OUTER} outer "
        f"iterations: {plain_ms:.4f} ms per outer iteration; final cost "
        f"kernel {c_k:.6e} plain {c_p:.6e} (rel diff {err_c:.3e}, tol "
        f"{TRAJ_TOL['float32']['cost']:.0e}); alpha max|diff| {err_a:.3e} "
        f"(float32 drift, not held)")
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
    return launches, ms_iter


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
def _write_rows(path, header, columns, fmt):
    """One fixture file: the header line, then np.savetxt's rows."""
    with open(path, "w") as f:
        f.write(header)
        np.savetxt(f, np.column_stack(columns), fmt=fmt, delimiter="\t")
    return path


def _write_fixture(root, seed=7, n=N_CLI):
    """A simulated bedmethyl fixture of n sites: ref.bed (N_CT types) and
    N_S samples of the N_CT + 1 types. Above N_CLI sites the files are
    written by a pool of spawned processes, one file each."""
    rng = np.random.default_rng(seed)
    R = rng.uniform(size=(n, N_CT + 1))
    alpha = rng.dirichlet(np.ones(N_CT + 1), size=N_S).T
    cov = rng.poisson(30, size=(n, N_S)) + 1
    meth = np.clip(R @ alpha + 0.01 * rng.normal(size=(n, N_S)), 0, 1)
    pos = np.arange(n)
    ref = os.path.join(root, "ref.bed")
    jobs = [(ref, "chrom\tstart\tend\t" + "\t".join(
        f"celltype{c + 1}" for c in range(N_CT)) + "\n",
        [pos, pos + 1, R[:, :N_CT]], ["chr1\t%d", "%d"] + ["%.6f"] * N_CT)]
    samples = [os.path.join(root, f"sample{s + 1}.bed") for s in range(N_S)]
    for s, path in enumerate(samples):
        jobs.append((path, "chrom\tstart\tend\tvalid_coverage\t"
                     "count_modified\tpercent_modified\n",
                     [pos, pos + 1, cov[:, s], np.rint(meth[:, s] * cov[:, s]),
                      100 * meth[:, s]],
                     ["chr1\t%d", "%d", "%d", "%d", "%.4f"]))
    if n <= N_CLI:
        for job in jobs:
            _write_rows(*job)
    else:
        import multiprocessing

        with multiprocessing.get_context("spawn").Pool(
                min(len(jobs), os.cpu_count() or 1)) as pool:
            pool.starmap(_write_rows, jobs)
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


# ------------------------------------------------------------ phase 11
# The kernels past one block's shared memory on paths through the API,
# the SVD/ICA inits and model selection. The past-envelope paths and the
# card-vs-CPU holds run at ENVELOPE_SITES / SWEEP_HOLD sites; the sweeps
# at full width run SWEEP_OUTER outer iterations a solve (cut from the
# CLI's 10000, with tol = 0 so that every solve runs them all).
ENVELOPE_SITES = 20_000
SWEEP_HOLD = 20_000
SWEEP_OUTER = 100
# the outer iterations of phase_cli_inits_ic's CLI runs and of
# phase_sweep's sweeps, each held card vs CPU: the CPU's share of those
# checks grows with them (at 100 the CPU side of the five --ic runs took
# 140 of the CLI phase's 191 s)
CLI_IC_OUTER = 30
SWEEP_HOLD_OUTER = 15
# card against the port's CPU path, float64: the inits (Gram eigh on
# cuSOLVER against LAPACK, then the same arithmetic), relative to each
# array's largest magnitude
INIT_TOL64 = 1e-6
# the sweeps held card vs CPU (float64, the same injected draws): the
# criterion list relative, the chosen alpha absolute
SWEEP_TOL64 = 1e-8


def phase_past_envelope(card):
    """Shapes past one block's shared memory through ``solvers.api`` and
    ``bootstrap_ci``, float64, 20k x 10, each run with the counters at 0
    just before and read just after, which must show the kernels in their
    device-memory and column-block forms and nothing else:
      - partial-reference, 200 + 10 (p = 210, the direct form, n_u > 8),
        10 x 10: K1's global layout, K2's column blocks (clusters of two);
      - purity, 179 + 1 (p = 180), 5 x 100: K1, K3's column blocks
        (clusters of two);
      - 4 restarts of partial-reference and of purity, 205 + 4 (p = 209,
        the gram form), 10 x 10 and 5 x 100: K4's global layout, K5's and
        K6's column blocks;
      - the weights bootstrap in the purity mode, B = 4, 205 + 4, 5 x 100:
        K4 weighted in its global layout, K6's column blocks.
    Before each solve, the kernel solver it runs against the plain solver
    on the same data from the same seeded inits (``_envelope_vs_plain``:
    cost trace and alpha at TRAJ_TOL["float64"], each member for the
    restarts); the bootstrap held to ``bootstrap_ci`` on the CPU with the
    same resample draws and inits (CI bounds 1e-8). Returns each run's
    launches by name."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import gram_form, u_phase_layout
    from demethify_tpu_torch.solvers.api import (
        partial_reference_deconv, purity_deconv)
    from demethify_tpu_torch.uncertainty.bootstrap import bootstrap_ci

    f64 = torch.float64
    n = ENVELOPE_SITES
    pur = torch.linspace(0.3, 0.9, N_S, device=DEV, dtype=f64)
    out = {}
    runs = (
        ("global", 200, 10, None, 1, 10, 10, "alpha_phase_full"),
        ("column blocks purity", 179, 1, pur, 1, 5, 100, "fw_phase_full"),
        ("global restarts", 205, 4, None, 4, 10, 10,
         "alpha_phase_full_multi"),
        ("global purity restarts", 205, 4, pur, 4, 5, 100,
         "fw_phase_full_multi"))
    for k, (tag, n_ct, n_u, pu, r, n1, n2, glue) in enumerate(runs):
        y, d, Rt = _wide_problem(n, N_S, n_ct, n_u, f64, seed=190 + k)
        _envelope_vs_plain(tag, r, y, d, Rt, n_u, pu, n1, n2, 190 + k)
        kw = dict(n_iter1=n1, n_iter2=n2, tol=0.0, record_trace=True,
                  seed=20 + k, n_restarts=r)

        def call():
            if pu is None:
                return partial_reference_deconv(y, d, Rt, n_u, **kw)
            return purity_deconv(y, d, Rt, n_u, pu, **kw)

        _, _, out[tag] = _drive(
            tag, f"{n} x {N_S}, {n_ct}+{n_u} (p = {n_ct + n_u}), float64, "
            f"{r} restart(s), {n1}x{n2}, card {card}", call, n1, n_sites=n)
        k1 = "u_phase_grams_multi" if r > 1 else "u_phase_grams"
        want = {k1: n1, glue: n1, f"{glue}{{p>32}}": n1,
                f"{glue}{{column blocks}}": n1}
        layout = u_phase_layout("K1", 8, N_S, n_ct, n_u,
                                not gram_form(n_u, N_S))[0]
        if layout != "resident":
            want[f"{k1}{{{layout}}}"] = n1
        if n_u > 8:
            want[f"{k1}{{n_u>8, state on chip}}"] = n1
        check(expect_counts(out[tag], **want),
              f"{tag} launches {out[tag]}, want {want}")

    n_ct, n_u, n_b, n1, n2 = 205, 4, 4, 5, 100
    y, d, Rt = _wide_problem(n, N_S, n_ct, n_u, f64, seed=195)
    rng = np.random.default_rng(195)
    indices = rng.integers(0, n, size=(n_b, n))
    u_b, a_b = _member_inits(n, n_b, n_ct, n_u, seed=195,
                             purity=pur.cpu().numpy())
    kw = dict(level=90, n_bootstrap=n_b, n_iter1=n1, n_iter2=n2, tol=0.0,
              method="weights", indices=indices,
              inits=list(zip(u_b, a_b)))
    reset_counts()
    got = bootstrap_ci(y, d, Rt, n_u, purity=pur, **kw)
    out["global bootstrap"] = read_counts()
    want = bootstrap_ci(y.cpu(), d.cpu(), Rt.cpu(), n_u, purity=pur.cpu(),
                        **kw)
    err = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
    log(f"[past envelope] weights bootstrap, purity, B={n_b} {n1}x{n2} "
        f"float64 {n} x {N_S}, {n_ct}+{n_u}: card vs CPU with the same "
        f"draws and inits, CI bounds max|diff| {err:.3e} (tol 1e-8); "
        f"launches {out['global bootstrap']}")
    check(err <= 1e-8, "past-envelope bootstrap: card vs CPU")
    check(expect_counts(out["global bootstrap"], **{
        "u_phase_grams_multi": n1, "u_phase_grams_multi{global}": n1,
        "fw_phase_full_multi": n1, "fw_phase_full_multi{p>32}": n1,
        "fw_phase_full_multi{column blocks}": n1}),
        f"past-envelope bootstrap launches {out['global bootstrap']}")
    return out


def _rel(a, b):
    """max |a - b| over max |b|, on the host in float64."""
    a = a.double().cpu()
    b = b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def phase_inits(card):
    """The SVD/ICA inits on the card against the port's CPU path on the
    same data in float64 (``INIT_TOL64`` of each array's largest
    magnitude, the signs included: ``tall_svd``'s sign rule), each timed
    with CUDA events, and timed again in float32 (the card-vs-CPU
    difference printed, not held: float32 ICA is decided by rounding at
    its whitening's null direction, README "Parity with the reference"):
    ``tall_svd``, NNDSVD (rank 6) and the dual ICA (rank 3) at 1M x 10,
    the primal ICA (rank 3) at 4096 x 10, and the three modes' SVD and
    ICA inits at 1M x 10 with 5 known types (1 unknown; unsupervised 3).
    The rotation search alone (a host read a step, and a stop) on the
    dual's and the primal's whitened rows, and the inits' known-block
    NNLS alone. Returns the timings (ms)."""
    import torch

    from demethify_tpu_torch.ops import nnica, nndsvd, tall_svd
    from demethify_tpu_torch.ops.nnls import wls_intercept_batch
    from demethify_tpu_torch.solvers import init

    f64 = torch.float64
    y, d, Rt = _wide_problem(N_CPG, N_S, N_CT, N_U, f64, seed=200)
    pur = torch.linspace(0.3, 0.9, N_S, device=DEV, dtype=f64)
    small = y[:4096].contiguous()
    cases = (
        ("tall_svd 1M x 10", lambda y, d, R, p, s: tall_svd.tall_svd(y)),
        ("NNDSVD 1M x 10 rank 6",
         lambda y, d, R, p, s: nndsvd.nndsvd_initialize(y, 6)),
        ("dual ICA 1M x 10 rank 3",
         lambda y, d, R, p, s: nnica.run_nn_ica_dual(y, 3)),
        ("primal ICA 4096 x 10 rank 3",
         lambda y, d, R, p, s: nnica.run_nn_ica(s, 3)),
        *((f"init_partial {o} 1M x 10, 5+1",
           lambda y, d, R, p, s, o=o: init.init_partial(None, o, y, d, R, 1))
          for o in ("SVD", "ICA")),
        *((f"init_purity {o} 1M x 10, 5+1",
           lambda y, d, R, p, s, o=o: init.init_purity(
               None, o, y, d, R, 1, purity=p)) for o in ("SVD", "ICA")),
        *((f"init_unsupervised {o} 1M x 10, 3",
           lambda y, d, R, p, s, o=o: init.init_unsupervised(
               None, o, y, d, 3)) for o in ("SVD", "ICA")))
    f64 = [y, d, Rt, pur, small]
    f32 = [x.float() for x in f64]
    times = {}
    for name, fn in cases:
        fn(*f64)                                             # warm
        got, ms = timed_ms(lambda: fn(*f64))
        err = max(_rel(a, b) for a, b in zip(
            got, fn(*(x.cpu() for x in f64))))
        fn(*f32)
        got32, ms32 = timed_ms(lambda: fn(*f32))
        err32 = max(_rel(a, b) for a, b in zip(
            got32, fn(*(x.cpu() for x in f32))))
        times[name] = (ms, ms32)
        log(f"[inits] {name}: card {ms:.3f} ms float64, {ms32:.3f} ms "
            f"float32 (CUDA events, card {card}); card vs CPU float64 "
            f"{err:.3e} of the largest entry (tol {INIT_TOL64:.0e}), "
            f"float32 {err32:.3e} (not held)")
        check(all(bool(torch.isfinite(a).all()) for a in got + got32),
              f"{name}: non-finite")
        check(err <= INIT_TOL64, f"{name}: card and CPU differ")
    _, ms = timed_ms(lambda: wls_intercept_batch(y, d, Rt))
    log(f"[inits] of which the known block's weighted NNLS (5 types, 1M x "
        f"10, float64): {ms:.3f} ms")
    B = tall_svd.tall_svd(y)[0]
    for tag, Z in (("dual 10 x 10", nnica.whiten(B.T @ y)),
                   ("primal 4096 x 10", nnica.whiten(small))):
        _, ms = timed_ms(lambda: nnica._rotation_search(Z, 0.1, 1000))
        log(f"[inits] rotation search, {tag}: {ms:.3f} ms (CUDA events)")
        times[f"rotation search {tag}"] = ms
    return times


@contextlib.contextmanager
def _rank_times(times):
    """Adds the CUDA-event ms of every solve the sweep makes to
    ``times[rank]`` (the sweep's entry points wrapped for the block)."""
    from demethify_tpu_torch.selection import sweep

    names = ("partial_reference_deconv", "unsupervised_deconv",
             "solve_members")
    saved = {n: getattr(sweep, n) for n in names}

    def wrap(name, fn):
        def timed(*args, **kw):
            rank = args[2] if name == "unsupervised_deconv" else args[3]
            out, ms = timed_ms(lambda: fn(*args, **kw))
            times[rank] = times.get(rank, 0.0) + ms
            return out
        return timed

    for n, fn in saved.items():
        setattr(sweep, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(sweep, n, fn)


def _sweep_draws(n, n_ct, n_s, seed):
    """Injected random inits (numpy, member (rank, j) from its own seed)
    and three train masks, for holding a sweep on the card to the CPU."""
    def inits(rank, j):
        rng = np.random.default_rng((seed, rank, j))
        return (rng.uniform(size=(n, rank)),
                rng.dirichlet(np.ones(n_ct + rank), size=n_s).T)
    rng = np.random.default_rng((seed, 0, 0, 0))
    masks = [rng.uniform(size=(n, n_s)) < 0.3 for _ in range(3)]
    return inits, masks


def phase_sweep(problem32, card):
    """Model selection through ``selection.sweep.evaluate_best_ic``.

    At full width, ``bench.py``'s data (1M x 10, 5 known types, float32,
    SWEEP_OUTER x 20, tol = 0), each with the counters at 0 just before
    and read just after: AIC with SVD inits up to n_u_max = 25 (every
    rank a single solve: K1 and K2; ranks 11-25 take the uniform_
    fallback), minka (the device spectrum, then one solve), CCC with 5
    restarts and BCV with 5 folds up to n_u_max = 6 (uniform_ inits: CCC's
    ranks 1-5 run their restarts together through K4 and K5, rank 6, the
    direct form, through K1 and K2). The depth cuts: SWEEP_OUTER outer
    iterations (the CLI's default is 10000); n_u_max 6 for CCC and BCV
    (the CLI's default is 25). Prints the solve time per rank.

    Each criterion held to the same sweep on the CPU at SWEEP_HOLD sites
    in float64 (SWEEP_HOLD_OUTER x 10, tol = 0) with the same injected
    inits and train
    masks (``_sweep_draws``; SVD inits computed on each side): the same
    chosen rank, the criterion list within ``SWEEP_TOL64`` relative, the
    chosen alpha within ``SWEEP_TOL64``."""
    import torch

    from demethify_tpu_torch.selection.sweep import evaluate_best_ic

    out = {}
    f64 = torch.float64
    y, d, Rt = _wide_problem(SWEEP_HOLD, N_S, N_CT, N_U, f64, seed=210)
    inits, masks = _sweep_draws(SWEEP_HOLD, N_CT, N_S, 211)
    for ic, init, n_max in (("AIC", "SVD", 25), ("minka", "SVD", 0),
                            ("CCC", "uniform_", 6), ("BCV", "uniform_", 6)):
        kw = dict(iter1=SWEEP_HOLD_OUTER, iter2=10, tol=0.0, n_restarts=3,
                  n_u_max=n_max, inits=inits, masks=masks)
        reset_counts()
        got = evaluate_best_ic(y, d, Rt, init, ic, **kw)
        launches = {k: v for k, v in read_counts().items() if v}
        want = evaluate_best_ic(y.cpu(), d.cpu(), Rt.cpu(), init, ic, **kw)
        err_l = float(np.max(np.abs(np.subtract(got[3], want[3]))
                             / np.maximum(np.abs(want[3]), 1e-300)))
        err_a = float((got[1].cpu() - want[1]).abs().max())
        log(f"[sweep] {ic} --init {init}, {SWEEP_HOLD} x {N_S}, float64, "
            f"card vs CPU: rank {got[2]} / {want[2]}, criterion max rel "
            f"diff {err_l:.3e}, alpha max|diff| {err_a:.3e} (tol "
            f"{SWEEP_TOL64:.0e}); card launches {launches}")
        check(got[2] == want[2] and err_l <= SWEEP_TOL64
              and err_a <= SWEEP_TOL64, f"{ic} sweep: card and CPU differ")

    y, d, Rt = (torch.as_tensor(x, device=DEV) for x in problem32[2:])
    runs = (("AIC", "SVD", 25), ("minka", "SVD", 0), ("CCC", "uniform_", 6),
            ("BCV", "uniform_", 6))
    for ic, init, n_max in runs:
        times = {}
        reset_counts()
        with _rank_times(times):
            res, ms = timed_ms(lambda: evaluate_best_ic(
                y, d, Rt, init, ic, iter1=SWEEP_OUTER, iter2=N_INNER,
                tol=0.0, n_restarts=5, n_u_max=n_max, seed=3))
        counts = read_counts()
        launches = {k: v for k, v in counts.items() if v}
        u, alpha, n_u, lst = res
        check(u.shape == (N_CPG, n_u) and alpha.shape == (N_CT + n_u, N_S)
              and bool(torch.isfinite(alpha).all())
              and np.isfinite(lst).any(), f"{ic} sweep output")
        check(float((alpha.sum(0) - 1).abs().max()) < 1e-4,
              f"{ic} sweep: alpha off the simplex")
        n_solves = {"AIC": n_max, "minka": 1, "CCC": 5 * n_max,
                    "BCV": 5 * n_max}[ic]
        if ic == "CCC":
            want = dict(u_phase_grams_multi=5 * SWEEP_OUTER,
                        alpha_phase_full_multi=5 * SWEEP_OUTER,
                        u_phase_grams=5 * SWEEP_OUTER,
                        alpha_phase_full=5 * SWEEP_OUTER)
        else:
            want = dict(u_phase_grams=n_solves * SWEEP_OUTER,
                        alpha_phase_full=n_solves * SWEEP_OUTER)
        # ranks above 8 run the n_u > 8 form, its state on the chip:
        # AIC's 9-25, and minka's one solve if it chose such a rank
        if ic == "AIC":
            want["u_phase_grams{n_u>8, state on chip}"] = (
                (n_max - 8) * SWEEP_OUTER)
        elif ic == "minka" and n_u > 8:
            want["u_phase_grams{n_u>8, state on chip}"] = SWEEP_OUTER
        check(expect_counts(counts, **want),
              f"{ic} sweep launches {launches}, want {want} and no other")
        per_rank = ", ".join(f"{r}: {t:.1f}" for r, t in sorted(
            times.items()))
        log(f"[sweep] {ic} --init {init} at 1M x {N_S}, {N_CT} known, "
            f"float32, n_u_max {n_max}, {SWEEP_OUTER}x{N_INNER}, tol = 0: "
            f"{ms / 1e3:.3f} s (CUDA events, card {card}); chose n_u = "
            f"{n_u}; solve ms per rank {{{per_rank}}}; launches {launches}")
        out[ic] = {"ms": ms, "per_rank": times, "launches": launches}
    # K1 at the sweep's widest ranks past 8 (the n_u > 8 form): its
    # time and bound at 1M x 10, 5 + n_u, float32, and its launches in the
    # AIC sweep (SWEEP_OUTER a rank: tol = 0)
    for n_u in (9, 25):
        k1 = _k1_case(N_CPG, n_u, "float32", timed=True, reps=3, inner=3,
                      label=f"[sweep rank {n_u}]")
        out[f"k1_rank{n_u}"] = dict(
            {k: k1[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "form", "layout")},
            launches_in_aic_sweep=SWEEP_OUTER)
        log(f"[sweep] K1 at rank {n_u} (1M x {N_S}, {N_CT}+{n_u}, float32, "
            f"{k1['form']} form): {k1['ms']:.4f} ms a launch, bound "
            f"{k1['bound_ms']:.4f} ms ({k1['bound_by']}), "
            f"{k1['ms'] / k1['bound_ms']:.1f}x; {SWEEP_OUTER} launches in "
            f"the AIC sweep's solve of that rank")
    return out


def _cli_svd_bootstrap(cli_main, root, samples, ref, percent):
    """``--confidence 95 4 --init SVD`` in the purity mode on the card,
    both layouts: the weights layout shares one SVD init among the
    replicates and runs K4 with weights and K6; the resample layout inits
    each replicate and runs K1 and K3. The replicates' resample draws are
    torch's on the card, so the intervals are held to their supports."""
    for cimethod, want in (("weights", ("u_phase_grams_multi",
                                        "fw_phase_full_multi")),
                           ("resample", ("u_phase_grams", "fw_phase_full"))):
        outdir = os.path.join(root, f"svd-ci-{cimethod}")
        before = read_counts()
        t0 = time.perf_counter()
        rc = cli_main(["--methfreq", *samples, "--bedmethyl", "--noprint",
                       "--outdir", outdir, "--device", DEV, "--ref", ref,
                       "--nbunknown", "1", "--purity", *percent, "--init",
                       "SVD", "--confidence", "95", "4", "--cimethod",
                       cimethod, "--iterations", "20", "100"])
        wall = time.perf_counter() - t0
        moved = {k: v - before[k] for k, v in read_counts().items()
                 if v - before[k]}
        lo, hi = _read_ci(os.path.join(
            outdir, "confidence_interval_celltypes_proportions.csv"))
        log(f"[cli] purity --init SVD --confidence 95 4 --cimethod "
            f"{cimethod}: exit {rc} in {wall:.2f} s, intervals {lo.shape}, "
            f"launches {moved}")
        check(rc == 0 and lo.shape == (N_CT + 1, N_S) and (lo <= hi).all()
              and all(moved.get(k, 0) > 0 for k in want),
              f"CLI --init SVD --cimethod {cimethod}")


def phase_cli_inits_ic():
    """The CLI with ``--init SVD`` and ``--init ICA`` in the three
    iterative modes, and ``--ic AIC|BIC|CCC|BCV|minka`` with ``--init SVD
    --icmax 3``, on the 50,000-site fixture with ``--device cuda``, each
    held to the same command with ``--device cpu`` (``--dtype float64``,
    CLI_IC_OUTER x 20; purity 20 x 100): proportions and profiles within
    1e-6, and
    the log's line of the chosen rank. BCV's train masks are drawn on the
    CPU, so both devices share them; the SVD and ICA inits draw nothing.
    The card's runs must launch K1 (and K3 with ``--purity``, K2
    otherwise). First the purity mode's bootstrap with an SVD init on
    the card, in both layouts (``_cli_svd_bootstrap``); last the SVD
    runs on bf16 storage (``_cli_bf16_svd``)."""
    from demethify_tpu_torch.cli import main as cli_main

    percent = [f"{p:g}" for p in np.linspace(10, 70, N_S)]
    outer = ["--iterations", str(CLI_IC_OUTER), "20"]
    modes = (("partial-ref", True, ["--nbunknown", "1"], "alpha_phase_full"),
             ("purity", True, ["--nbunknown", "1", "--purity", *percent,
                               "--iterations", "20", "100"],
              "fw_phase_full"),
             ("unsupervised", False, ["--nbunknown", str(U_N_U)],
              "alpha_phase_full"))
    runs = [(f"{mode} --init {init}", with_ref,
             [*outer, "--init", init, *extra], glue)
            for init in ("SVD", "ICA")
            for mode, with_ref, extra, glue in modes]
    runs += [(f"--ic {ic}", True, [*outer, "--init", "SVD", "--icmax", "3",
                                   "--ic", ic, "3"], "alpha_phase_full")
             for ic in ("AIC", "BIC", "CCC", "BCV", "minka")]
    with tempfile.TemporaryDirectory() as root:
        samples, ref = _write_fixture(root)
        _cli_svd_bootstrap(cli_main, root, samples, ref, percent)
        for tag, with_ref, extra, glue in runs:
            files = {}
            for dev in (DEV, "cpu"):
                outdir = os.path.join(root, f"{tag}-{dev}".replace(" ", "_"))
                before = read_counts()
                t0 = time.perf_counter()
                rc = cli_main(["--methfreq", *samples, "--bedmethyl",
                               "--noprint", "--outdir", outdir, "--device",
                               dev, "--dtype", "float64",
                               *(["--ref", ref] if with_ref else []),
                               *extra])
                wall = time.perf_counter() - t0
                check(rc == 0, f"CLI {tag} on {dev}: exit {rc}")
                moved = {k: v - before[k] for k, v in read_counts().items()
                         if v - before[k]}
                if dev == DEV:
                    check(moved.get("u_phase_grams", 0) > 0
                          and moved.get(glue, 0) > 0,
                          f"CLI {tag}: launches {moved}")
                else:
                    check(not moved, f"CLI {tag} on the CPU launched")
                _, rows = _read_csv(os.path.join(
                    outdir, "celltypes_proportions.csv"))
                _, prof = _read_csv(os.path.join(
                    outdir, "methylation_profile_estimate.csv"))
                with open(os.path.join(outdir, "log.log")) as f:
                    log_lines = f.read().splitlines()
                files[dev] = ([r[0] for r in rows],
                              np.array([[float(x) for x in r[1:]]
                                        for r in rows]),
                              np.array(prof, dtype=np.float64),
                              log_lines[1] if "--ic" in extra else "",
                              wall, moved)
            (lab_c, p_c, u_c, ic_c, wall_c, moved), (lab_p, p_p, u_p, ic_p,
                                                     wall_p, _) = (
                files[DEV], files["cpu"])
            err_p = float(np.abs(p_c - p_p).max())
            err_u = float(np.abs(u_c - u_p).max())
            log(f"[cli] {tag}: card {wall_c:.2f} s, CPU {wall_p:.2f} s; "
                f"rows {lab_c}; card vs CPU proportions {err_p:.2e}, "
                f"profiles {err_u:.2e} (tol 1e-6) {ic_c!r}; card launches "
                f"{moved}")
            check(lab_c == lab_p and ic_c == ic_p and p_c.shape == p_p.shape
                  and err_p <= 1e-6 and err_u <= 1e-6,
                  f"CLI {tag}: card and CPU differ")
            check(np.abs(p_c.sum(0) - 1).max() <= 1e-6
                  or tag.startswith("purity"), f"CLI {tag}: column sums")
        _cli_bf16_svd(cli_main, root, samples, ref)


def _cli_bf16_svd(cli_main, root, samples, ref):
    """``--init SVD`` and ``--ic AIC --init SVD --icmax 3`` on bf16
    storage on the card (the SVD init factors the upcast data in float32;
    K1 reads the bf16 data), beside the same commands in float32 on the
    card: the difference is printed, not held (bf16 rounds the data)."""
    for tag, extra in (("--init SVD", ["--nbunknown", "1"]),
                       ("--ic AIC --init SVD",
                        ["--ic", "AIC", "--icmax", "3"])):
        props = {}
        for storage in ("bfloat16", "float32"):
            outdir = os.path.join(root, f"bf16-{tag}-{storage}".replace(
                " ", "_"))
            before = read_counts()
            rc = cli_main(["--methfreq", *samples, "--bedmethyl",
                           "--noprint", "--outdir", outdir, "--device", DEV,
                           "--dtype", storage, "--ref", ref, "--init", "SVD",
                           "--iterations", "100", "20", *extra])
            moved = {k: v - before[k] for k, v in read_counts().items()
                     if v - before[k]}
            _, rows = _read_csv(os.path.join(outdir,
                                             "celltypes_proportions.csv"))
            props[storage] = np.array([[float(x) for x in r[1:]]
                                       for r in rows])
            k1 = "u_phase_grams" + ("[bf16]" if storage == "bfloat16"
                                    else "")
            check(rc == 0 and moved.get(k1, 0) > 0
                  and np.abs(props[storage].sum(0) - 1).max() <= 1e-5,
                  f"CLI {tag} --dtype {storage}: launches {moved}")
        same = props["bfloat16"].shape == props["float32"].shape
        diff = (float(np.abs(props["bfloat16"] - props["float32"]).max())
                if same else float("nan"))
        log(f"[cli] {tag} --dtype bfloat16 on the card: rows "
            f"{props['bfloat16'].shape[0]}, beside float32 max|diff| "
            f"{diff:.3e} (rows {props['float32'].shape[0]}; not held)")


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
    ``cuda_small.glue_smem`` in its register, two-row and wide forms, the
    row buckets and the two-row slab stride against ``dm_row_bucket`` and
    ``dm_two_row_stride``), over a grid of shapes in the three layouts
    (n_u up to 26: the n_u > 8 form's state region, ``state_rows`` and
    ``state_in_device`` against ``dm_state_rows``, ``dm_state_in_device``);
    the global layout's plan (``cuda_kernels.global_plan``: its chunk,
    ring and rows for one K1 member and for K4's groups, against
    ``dm_global_plan``); K2's, K3's, K5's and K6's column blocks and
    device rows (``alpha_column_plan``, ``fw_column_plan``,
    ``alpha_column_groups``, ``fw_column_groups`` and the device rows'
    buffer, ``column_work``, at p = 65-1000 and at the device rows'
    edges to 25,601) and K9's and K10's forms (``phase_plan`` at
    p = 1-1000 and at those edges) against their exports."""
    from demethify_tpu_torch.ops import _build
    from demethify_tpu_torch.ops.cuda_kernels import (
        SMEM_LIMIT, global_plan, lib_global_plan, state_in_device,
        state_rows, u_phase_smem)
    from demethify_tpu_torch.ops.cuda_small import REG_P
    from demethify_tpu_torch.ops.cuda_small import TWO_ROW_P as TWO_ROW_P_MAX
    from demethify_tpu_torch.ops.cuda_small import (
        alpha_column_groups, alpha_column_plan, alpha_plan, column_work,
        fw_column_groups, fw_column_plan, glue_smem, lib_alpha_column_plan,
        lib_fw_column_plan, lib_phase_plan, phase_plan, two_row_stride)

    lib = _build.load().lib
    bad, n_checked = [], 0
    for itemsize in (4, 8):
        for n_s in (1, 2, 6, 10, 64, 88, 100, 107, 108, 189, 190, 217, 218,
                    256, 500, 512):
            for n_ct, n_u in ((0, 1), (0, 3), (5, 1), (5, 2), (25, 4),
                              (25, 9), (25, 16), (60, 4), (5, 12), (5, 17),
                              (5, 18), (5, 25), (0, 26)):
                for layout in ("resident", "wide", "global"):
                    sfx = {"resident": "", "wide": "_wide",
                           "global": "_global"}[layout]
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
                for direct in (False, True):
                    n_checked += 2
                    if (lib.dm_state_rows(n_s, n_u, int(direct))
                            != state_rows(n_s, n_u, direct)):
                        bad.append(("state rows", n_s, n_u, direct))
                    if (bool(lib.dm_state_in_device(itemsize, n_s, n_u,
                                                    int(direct)))
                            != state_in_device(itemsize, n_s, n_u, direct)):
                        bad.append(("state in device", itemsize, n_s, n_u,
                                    direct))
                    for um, members in ((n_u, 1), (2 * n_u, 1),
                                        (n_u, 3), (2 * n_u, 8)):
                        n_checked += 1
                        plan = (itemsize, n_s, n_ct, n_u, direct, um,
                                members)
                        if lib_global_plan(lib, *plan) != global_plan(*plan):
                            bad.append(("global plan", *plan))
        for p in (1, 6, 32, 33, 40, 48, 64, 65, 100, 167, 168, 170, 200,
                  237, 238, 300):
            for n_s in (1, 10, 16, 17, 100):
                n_warps, smem = glue_smem(itemsize, p, n_s)
                want = lib.dm_glue_smem(itemsize, p, n_s)
                n_checked += 1
                if want != smem:
                    bad.append(("glue", itemsize, p, n_s, want, smem))
        # K2's, K3's, K5's and K6's column blocks and device rows: the
        # plans, the device rows' buffer and the cost's groups
        for p in [*range(65, 1001), 2000, 4114, 4115, 8228, 8229, 16484,
                  25600, 25601]:
            for kernel in ("alpha", "fw"):
                for n_s in (1, 10, 100):
                    n_checked += 1
                    work = getattr(lib, f"dm_{kernel}_column_work")(
                        itemsize, p, n_s)
                    if work != column_work(kernel, itemsize, p, n_s):
                        bad.append(("column work", kernel, itemsize, p,
                                    n_s, work))
            n_checked += 2
            if (lib_fw_column_plan(lib, itemsize, p)
                    != fw_column_plan(itemsize, p)):
                bad.append(("column plan", itemsize, p))
            if (lib_alpha_column_plan(lib, itemsize, p)
                    != alpha_column_plan(itemsize, p)):
                bad.append(("alpha column plan", itemsize, p))
            for n_s in (1, 10, 27, 28, 29, 31, 32, 33, 100, 500):
                n_checked += 2
                if (lib.dm_fw_column_groups(itemsize, p, n_s)
                        != fw_column_groups(itemsize, p, n_s)):
                    bad.append(("column groups", itemsize, p, n_s))
                if (lib.dm_alpha_column_groups(itemsize, p, n_s)
                        != alpha_column_groups(itemsize, p, n_s)):
                    bad.append(("alpha column groups", itemsize, p, n_s))
    # K9's and K10's forms at every p to 1000 and at the device rows'
    # edges (their plans)
    for kernel in ("alpha", "fw"):
        for itemsize in (4, 8):
            for p in [*range(1, 1001), 2000, 4115, 8229, 16484, 25601]:
                n_checked += 1
                if (lib_phase_plan(lib, kernel, itemsize, p)
                        != phase_plan(kernel, itemsize, p)):
                    bad.append(("phase plan", kernel, itemsize, p))
    # the glue kernels' row buckets and the two-row form's slab stride
    for p in range(1, 130):
        n_checked += 2
        want = alpha_plan(p, 10)[0] if p <= TWO_ROW_P_MAX else 0
        if lib.dm_row_bucket(p) != want:
            bad.append(("row bucket", p, lib.dm_row_bucket(p), want))
        if REG_P < p <= TWO_ROW_P_MAX and (lib.dm_two_row_stride(p)
                                            != two_row_stride(p)):
            bad.append(("two-row stride", p, lib.dm_two_row_stride(p)))
    log(f"[layouts] {n_checked} shared-memory plans: Python against the "
        f"kernels' *_smem exports, {len(bad)} differ {bad[:5]}; the card's "
        f"limit {SMEM_LIMIT} bytes")
    check(not bad, "shared-memory plans differ from the kernels'")


@contextlib.contextmanager
def forced_layout(layout):
    """K1 and K4 launch in ``layout`` ("resident", "wide" or "global")
    inside the block, whatever ``cuda_kernels.u_phase_layout`` would plan
    (the shape must fit that layout's shared memory)."""
    from demethify_tpu_torch.ops import cuda_kernels

    plan = cuda_kernels.u_phase_layout

    def forced(name, itemsize, n_s, n_ct, n_u, direct=False, bf16c=False,
               weighted=False, smem=None):
        if smem is None:
            return layout, cuda_kernels.u_phase_smem(
                layout, itemsize, n_s, n_ct, n_u, direct, bf16c, weighted)
        return layout, smem(layout)

    cuda_kernels.u_phase_layout = forced
    try:
        yield
    finally:
        cuda_kernels.u_phase_layout = plan


def _layout_bits(n, n_s, n_ct, n_u, dtype_name, n_b=0, data=None, seed=50,
                 steps=N_INNER, layouts=("resident", "wide"), bf16c=False,
                 weighted=False, inactive=()):
    """K1 (n_b = 0) or K4 (n_b members, those in ``inactive`` frozen) in
    each of two ``layouts`` forced, at a shape both take: the same bits?
    (u, u_prev and the scalars of every member; the Grams of the active
    ones, an inactive member's being unspecified.) ``bf16c`` runs K1's
    bf16_compute form (bf16 data), ``weighted`` K4 with resample
    weights."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import u_phase_grams
    from demethify_tpu_torch.ops.cuda_multi import u_phase_grams_multi

    dtype = getattr(torch, dtype_name)
    if n_b:
        ydt, rtt, alpha, uut, scal = _multi_inputs(n, n_s, n_ct, n_u, n_b,
                                                   dtype, seed, inactive)
        a1, a2 = alpha[:, :n_ct], alpha[:, n_ct:]
        fn = u_phase_grams_multi
    else:
        ydt, rtt, alpha, uut, scal = _k1_inputs(n, n_s, n_ct, n_u, dtype,
                                                seed)
        a1, a2 = alpha[:n_ct], alpha[n_ct:]
        fn = u_phase_grams
    if data is not None:
        ydt, rtt = ydt.to(getattr(torch, data)), rtt.to(getattr(torch, data))
    kw = {"bf16_compute": True} if bf16c else {}
    if weighted:
        kw["weights"] = resample_weights(n_b, n, dtype, seed)
    outs = []
    for layout in layouts:
        u, sc = uut.clone(), scal.clone()
        with forced_layout(layout):
            outs.append((u, sc, *fn(ydt, rtt, a1, a2, u, sc, steps, **kw)))
    act = [b for b in range(n_b) if b not in inactive]
    same = all(torch.equal(x, y) if k < 2 or not inactive
               else torch.equal(x[act], y[act])
               for k, (x, y) in enumerate(zip(*outs)))
    form = (", bf16_compute" if bf16c else "") + (
        ", weighted" if weighted else "") + (
        f", members {list(inactive)} inactive" if inactive else "")
    log(f"[layouts] {'K4 B=' + str(n_b) if n_b else 'K1'} N={n} n_s={n_s} "
        f"n_ct={n_ct} n_u={n_u} {dtype_name} state, "
        f"{str(ydt.dtype)[6:]} data{form}: {layouts[1]} layout forced "
        f"bit-identical to the {layouts[0]} layout: {same}")
    check(same, f"the {layouts[1]} layout differs from the {layouts[0]} "
                f"layout")
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
    # n_u = 12 in float32: since the n_u > 8 form keeps its state region
    # on the chip, no float64 gram shape at n_u = 12 fits the resident
    # layout (the region's 126 rows leave room for n_s <= 38 samples; the
    # gram form needs n_s >= 48)
    _layout_bits(N_WIDE, 64, 25, 12, "float32", seed=54)
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


def _state_form_counts(name, launches):
    """The launches a case of the n_u > 8 form made, by counter: all of
    its kernel's launches in one of the two placements of the state."""
    chip = launches[f"{name}{{n_u>8, state on chip}}"]
    dev = launches[f"{name}{{n_u>8, state in device memory}}"]
    total = sum(v for k, v in launches.items()
                if k in (name, f"{name}[bf16]", f"{name}[bf16_compute]"))
    return chip, dev, total


def phase_state_cols():
    """The n_u > 8 form (the state on the chip, in a per-thread column of
    a shared-memory state region; ``cuda_kernels.state_rows``) against the
    twins, each case timed beside its bound and its launches counted (all
    of them in the n_u > 8 form, its state on the chip unless the region
    passes the card's shared memory): K1 in the gram form at n_s = 100
    (5 + n_u, n_u in {9, 12, 16, 17}), the direct form at n_s = 10
    (n_u in {9, 12, 16, 25}) and, with gradient rows past one chunk of
    samples, at n_s = 80 with 25 + 16, float64, 200k sites; n_u = 12 in
    float32 (both forms), on bf16 data and with bf16_compute (gram form);
    the sweep's widest rank, n_u = 25 at 1M x 10, 5 + 25, float32; K4
    (B = 4, one member inactive) at n_u in {9, 12, 16}, float64, n_u = 12
    in float32, on bf16 data and weighted; the state region in device
    memory (5 + 18 at n_s = 108, float64: past one block's shared memory
    in every layout) in K1 and K4. Returns K1's and K4's timed n_u = 12
    cases and the list of every case."""
    from demethify_tpu_torch.ops.cuda_kernels import (
        state_in_device, state_rows)

    cases = []

    def run(kind, fn, **kw):
        reset_counts()
        r = fn(**kw)
        name = "u_phase_grams" if kind == "K1" else "u_phase_grams_multi"
        chip, dev, total = _state_form_counts(name, read_counts())
        r.update(kind=kind, launches_on_chip=chip, launches_in_device=dev,
                 launches=total,
                 state_rows=state_rows(r["n_s"], r["n_u"],
                                       r.get("form") == "direct"),
                 state_in_device=state_in_device(
                     8 if r["dtype"] == "float64" else 4, r["n_s"], r["n_u"],
                     r.get("form") == "direct"))
        want_dev = total if r["state_in_device"] else 0
        log(f"[n_u>8] {kind} n_s={r['n_s']} {r['n_ct']}+{r['n_u']} "
            f"{r['dtype']} {r.get('form', 'gram')} form: {total} launches, "
            f"{chip} with the state on the chip, {dev} in device memory "
            f"({r['state_rows']} state rows); {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}, "
            f"{r['ms'] / r['bound_ms']:.1f}x), twin {r['plain_ms']:.4f} ms")
        check(total > 0 and dev == want_dev and chip == total - want_dev,
              f"{kind} n_u={r['n_u']}: launches {chip} on chip, {dev} in "
              f"device memory of {total}")
        cases.append(r)
        return r

    k1 = functools.partial(_k1_case, timed=True, inner=1, reps=3)
    k4 = functools.partial(_k4_case, timed=True, quick=True)
    timed = timed4 = None
    for n_u in (9, 12, 16, 17):
        r = run("K1", k1, n=N_WIDE, n_u=n_u, dtype_name="float64", n_s=100,
                n_ct=5, seed=80 + n_u, label="[n_u>8 gram]")
        timed = r if n_u == 12 else timed
    for n_u in (9, 12, 16, 25):
        run("K1", k1, n=N_WIDE, n_u=n_u, dtype_name="float64", n_s=10,
            n_ct=5, seed=81 + n_u, label="[n_u>8 direct]")
    run("K1", k1, n=N_WIDE, n_u=16, dtype_name="float64", n_s=80, n_ct=25,
        seed=97, label="[n_u>8 direct, gradient rows]")
    run("K1", k1, n=N_WIDE, n_u=12, dtype_name="float32", n_s=100, n_ct=5,
        seed=98, label="[n_u>8 gram]")
    run("K1", k1, n=N_WIDE, n_u=12, dtype_name="float32", n_s=10, n_ct=5,
        seed=99, label="[n_u>8 direct]")
    run("K1", k1, n=N_WIDE, n_u=12, dtype_name="float32", n_s=100, n_ct=5,
        seed=101, data="bfloat16", label="[n_u>8 gram, bf16]")
    run("K1", k1, n=N_WIDE, n_u=12, dtype_name="float32", n_s=100, n_ct=5,
        seed=102, data="bfloat16", bf16_compute=True,
        label="[n_u>8 gram, bf16_compute]")
    run("K1", k1, n=N_CPG, n_u=25, dtype_name="float32", n_s=N_S, n_ct=N_CT,
        seed=103, label="[n_u>8 direct, sweep rank 25]")
    run("K1", k1, n=50_000, n_u=18, dtype_name="float64", n_s=108, n_ct=5,
        seed=104, label="[n_u>8 gram, state in device memory]")
    for n_u in (9, 12, 16):
        r4 = run("K4", k4, n_u=n_u, dtype_name="float64", n_b=4,
                 steps=N_INNER, n_ct=5, inactive=(2,), seed=82 + n_u,
                 label="[n_u>8]", n=N_WIDE, n_s=100)
        timed4 = r4 if n_u == 12 else timed4
    run("K4", k4, n_u=12, dtype_name="float32", n_b=4, steps=N_INNER,
        n_ct=5, inactive=(2,), seed=100, label="[n_u>8]", n=N_WIDE, n_s=100)
    run("K4", k4, n_u=12, dtype_name="float32", n_b=4, steps=N_INNER,
        n_ct=5, inactive=(2,), seed=105, label="[n_u>8, bf16]", n=N_WIDE,
        n_s=100, data="bfloat16")
    run("K4", k4, n_u=18, dtype_name="float64", n_b=3, steps=N_INNER,
        n_ct=5, inactive=(1,), seed=106,
        label="[n_u>8, state in device memory]", n=50_000, n_s=108)
    _k4w_case(12, "float64", 4, N_INNER, n_ct=5, inactive=(2,), seed=107,
              label="[n_u>8 weighted]", n=N_WIDE, n_s=100)
    return timed, timed4, cases


# the glue kernels' two-row form (32 < p <= 64): the rows and columns it
# is held at
TWO_ROW_P = (33, 40, 48, 64)
TWO_ROW_NS = (10, 100)
GLUE_KERNELS = ("alpha_phase_full", "fw_phase_full", "alpha_phase_full_multi",
                "fw_phase_full_multi", "alpha_phase", "fw_phase")
# the glue kernels that also count their launches above 32 rows ("{p>32}")
WIDE_COUNTED = GLUE_KERNELS[:4]


def _glue_forms(case, want_two_row, columns=True):
    """Runs ``case()`` with the counters at 0 and checks each glue kernel
    it launched against its form counters: every launch in the two-row
    form (``want_two_row``), or none (p > 64: the column blocks where
    ``columns``, else the device rows). Returns the case's result."""
    reset_counts()
    res = case()
    got = read_counts()
    for k in GLUE_KERNELS:
        if got[k]:
            want = got[k] if want_two_row else 0
            check(got[f"{k}{{two-row}}"] == want
                  and (k not in WIDE_COUNTED
                       or got[f"{k}{{p>32}}"] == got[k]),
                  f"{k}: {got[k]} launches, {got[f'{k}{{two-row}}']} in the "
                  f"two-row form, want {want}")
        if got[k] and not want_two_row:
            cols = got[k] if columns else 0
            check(got[f"{k}{{column blocks}}"] == cols
                  and got[f"{k}{{device rows}}"] == got[k] - cols,
                  f"{k}: {got[k]} launches, "
                  f"{got[f'{k}{{column blocks}}']} in the column blocks, "
                  f"want {cols}")
    if isinstance(res, dict):
        res["check_launches"] = got
    return res


def _nan_column_case(p, n_s=N_S, col=3):
    """K2, K5 (B = 2) and K9 (on K2's assembled Grams) at p rows,
    float64, 200k sites, with G_s's entry (p - 1, 0) of column ``col`` a
    NaN, against their twins: that column comes out NaN in every row of
    alpha, as the twins and the JAX kernels give it, and the other
    columns agree at the alpha tolerance. The forms: register (p <= 32),
    two-row (33-64), column blocks (to 624) and device rows past them."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import (
        A_ALPHA, DMAX2, L_H_PREV, RT_SQ)
    from demethify_tpu_torch.ops.cuda_small import (
        alpha_phase, alpha_phase_full, alpha_phase_full_multi,
        alpha_phase_full_multi_plain, alpha_phase_full_plain,
        alpha_phase_plain, assemble_G_b)

    n_u = 1 if p <= 32 else 4
    n_ct = p - n_u
    blocks, _, _, alpha, alpha_prev, scal = _phase_glue_inputs(
        p, n_ct, "float64", 800 + p, n_s)
    gtt, bt, gu, bu, usq, ydy = blocks
    gu = gu.clone()
    gu[col, n_u - 1, 0] = float("nan")       # G_s[p - 1, 0]
    (mgtt, mbt, mgu, mbu, musq, mydy, alpha_b, alpha_prev_b,
     scal_b) = _glue_multi_inputs(n_ct, n_u, "float64", 2, (), 810 + p,
                                  n_s=n_s)
    mgu = mgu.clone()
    mgu[1, col, n_u - 1, 0] = float("nan")
    reset_counts()
    outs = []
    for fn, args, a, ap, sc in (
            ("k2", (gtt, bt, gu, bu, usq, ydy), alpha, alpha_prev, scal),
            ("k5", (mgtt, mbt, mgu, mbu, musq, mydy), alpha_b,
             alpha_prev_b, scal_b)):
        kern, plain = ((alpha_phase_full, alpha_phase_full_plain)
                       if fn == "k2" else
                       (alpha_phase_full_multi, alpha_phase_full_multi_plain))
        ak, apk, sk = a.clone(), ap.clone(), sc.clone()
        kern(*args, ak, apk, sk, N_INNER, n_u)
        aq, apq, sq = a.clone(), ap.clone(), sc.clone()
        plain(*args, aq, apq, sq, N_INNER, n_u)
        outs.append((fn, ak, aq))
    G, b = (x.contiguous() for x in assemble_G_b(gtt, bt, gu, bu))
    sc = (scal[A_ALPHA], scal[L_H_PREV], (scal[RT_SQ] + usq[0]) * scal[DMAX2])
    outs.append(("k9", alpha_phase(G, b, alpha, alpha_prev, *sc, N_INNER)[0],
                 alpha_phase_plain(G, b, alpha, alpha_prev, *sc,
                                   N_INNER)[0]))
    torch.cuda.synchronize()
    launches = read_counts()
    ok = True
    for fn, ak, aq in outs:
        nan_k, nan_q = torch.isnan(ak), torch.isnan(aq)
        bad_col = (nan_k[1, :, col].all() if fn == "k5"
                   else nan_k[..., col].all())
        same_nan = torch.equal(nan_k, nan_q)
        err = float((ak[~nan_q] - aq[~nan_q]).abs().max())
        log(f"[NaN column] {fn} p={p} n_s={n_s} float64: column {col} NaN "
            f"in every row: {bool(bad_col)}; NaN rows equal the twin's: "
            f"{same_nan}; the other columns max|diff| {err:.3e} (tol "
            f"{TOL['float64']['alpha']:.0e})")
        ok = ok and bool(bad_col) and same_nan and (
            err <= TOL["float64"]["alpha"])
    log(f"[NaN column] p={p} launches {dict((k, v) for k, v in launches.items() if v)}")
    check(ok, f"K2/K5/K9 NaN column at p = {p}")


def phase_wide_glue():
    """The two-row form (32 < p <= 64) of K2, K3, K5, K6, K9 and K10
    against their twins at p = 33, 40, 48, 64, n_s = 10 and 100, float32
    and float64 (K5 and K6 with an inactive member; K9 and K10 also held
    bit for bit to K2 and K3 on the same Grams), each launch counted in
    the two-row form; K2 and K5 with row masks at p = 40 and 64 (an
    all-ones mask bit-identical to none, masked rows exactly 0); K9 and
    K10 above 64 rows in K2's and K3's column blocks
    (``_phase_wide_cases``), with no two-row launch; K2's and K5's column
    blocks at p = 65 (both dtypes), 100
    (float32; float64 timed), 166 and 167 (float64) and 237 and 238
    (float32), the plan's last single block and first cluster of two, K5
    with an inactive member, with row masks at p = 100 and 200 and with
    per-member known blocks; K3's and K6's column blocks at p = 65 and 100
    (both dtypes), 167 and 168 (float64), one block a column, K6 with an
    inactive member and at p = 100 with per-member known blocks; a column
    whose v holds a NaN in each form of K2 and K5 (``_nan_column_case``,
    to the device rows at p = 625).
    Returns the timed p = 40, n_s = 10, float64 cases (the kernels line's
    rows) and the timed p = 100 cases of K2's, K3's, K9's and K10's column
    blocks."""
    timed = {}
    for p in TWO_ROW_P:
        for n_s in TWO_ROW_NS:
            for dt in ("float64", "float32"):
                t = p == 40 and n_s == 10 and dt == "float64"
                seed = 110 + p + n_s
                cases = {
                    "k2": lambda: _k2_case(p - 4, dt, n_u=4, seed=seed,
                                           timed=t, n_s=n_s),
                    "k3": lambda: _k3_case(p - 1, dt, seed=seed + 1,
                                           timed=t, n_s=n_s),
                    "k5": lambda: _k5_case(p - 4, 4, dt, 4, (2,),
                                           seed=seed + 2, timed=t, n_s=n_s),
                    "k6": lambda: _k6_case(dt, n_b=4, inactive=(1,),
                                           n_ct=p - 1, seed=seed + 3,
                                           timed=t, n_s=n_s),
                    "k9": lambda: _k9_case(p, dt, n_s=n_s, seed=seed + 4,
                                           timed=t),
                    "k10": lambda: _k10_case(p, dt, n_s=n_s, seed=seed + 5,
                                             timed=t)}
                for name, case in cases.items():
                    res = _glue_forms(case, True)
                    if t:
                        timed[name] = res
        for dt in ("float64", "float32"):
            if p in (40, 64):
                _glue_forms(lambda: _k2_case(
                    p - 4, dt, n_u=4, seed=118 + p, n_s=100,
                    mask=[1] * (p - 2) + [0, 1]), True)
                _glue_forms(lambda: _k2_case(
                    p - 4, dt, n_u=4, seed=119 + p, mask=[1] * p), True)
                mask = np.ones((4, p))
                mask[0, 3] = mask[3, p - 1] = 0.0
                _glue_forms(lambda: _k5_case(
                    p - 4, 4, dt, 4, (2,), seed=120 + p, mask=mask.tolist()),
                    True)
                _glue_forms(lambda: _k9_case(
                    p, dt, n_s=100, seed=121 + p,
                    mask=[0] + [1] * (p - 1)), True)
    # K9 and K10 above 64 rows: K2's and K3's column blocks (one block a
    # column to the plan's last, clusters of two just past it and at
    # p = 200 and 240), K9 with row masks (past 8 blocks:
    # phase_column_rows)
    timed.update(_phase_wide_cases())
    # K2's and K5's column blocks: one block a column at p = 65 and 100
    # and to the plan's last (166 in float64, 237 in float32), clusters of
    # two just past it; K5 with an inactive member, K2 also at n_s = 100
    for p, dt in ((65, "float64"), (65, "float32"), (100, "float32"),
                  (166, "float64"), (167, "float64"), (237, "float32"),
                  (238, "float32")):
        seed = 122 + p
        _glue_forms(lambda: _k2_case(p - 4, dt, n_u=4, seed=seed), False)
        _glue_forms(lambda: _k5_case(p - 4, 4, dt, 4, (2,), seed=seed + 2),
                    False)
    _glue_forms(lambda: _k2_case(163, "float64", n_u=4, seed=131, n_s=100),
                False)
    timed["k2 wide"] = _glue_forms(lambda: _k2_case(
        96, "float64", n_u=4, seed=124, timed=True), False)
    # with row masks (an all-ones mask bit-identical to none) and with
    # per-member known blocks
    for p, dt in ((100, "float64"), (100, "float32"), (200, "float64")):
        _glue_forms(lambda: _k2_case(
            p - 4, dt, n_u=4, seed=132 + p, n_s=100,
            mask=[1] * (p - 2) + [0, 1]), False)
        _glue_forms(lambda: _k2_case(p - 4, dt, n_u=4, seed=133 + p,
                                     mask=[1] * p), False)
        mask = np.ones((4, p))
        mask[0, 3] = mask[3, p - 1] = 0.0
        _glue_forms(lambda: _k5_case(p - 4, 4, dt, 4, (2,), seed=134 + p,
                                     mask=mask.tolist()), False)
    for p in (100, 200):
        _glue_forms(lambda: _k5w_case(p - 4, 4, "float64", 3, (1,),
                                      seed=135 + p), False)
    # a column whose v holds a NaN, in every form of K2, K5 and K9
    for p in (6, 40, 100, 200, 460, 625):
        _nan_column_case(p)
    # K3's and K6's column blocks, one block a column up to p = 168 in
    # float64: K6 with an inactive member, and with per-member known blocks
    for p, dt in ((65, "float64"), (65, "float32"), (100, "float32"),
                  (167, "float64"), (168, "float64")):
        seed = 122 + p
        _glue_forms(lambda: _k3_case(p - 1, dt, seed=seed + 1), False)
        _glue_forms(lambda: _k6_case(dt, n_b=4, inactive=(1,), n_ct=p - 1,
                                     seed=seed + 3), False)
    timed["k3 wide"] = _glue_forms(lambda: _k3_case(
        99, "float64", seed=125, timed=True), False)
    _glue_forms(lambda: _k6_case("float64", n_b=4, inactive=(1,), n_ct=99,
                                 seed=225), False)
    _glue_forms(lambda: _k6w_case("float64", n_b=3, inactive=(1,), n_ct=99,
                                  seed=226), False)
    # a block of 32 float64 warps of the register form passes the card's
    # registers: the launchers cap the warps, which then loop over columns
    for dt in ("float64", "float32"):
        _k2_case(25, dt, n_u=4, seed=114, n_s=100)
        _glue_forms(lambda: _k2_case(33, dt, n_u=4, seed=115, n_s=100),
                    True)
        _k3_case(28, dt, seed=116, n_s=100)
    return timed


def _last_single_block(plan, itemsize):
    """The largest p whose column plan takes one block."""
    return max(p for p in range(65, 700) if plan(itemsize, p)["blocks"] == 1)


def _phase_wide_cases():
    """K9 and K10 above 64 rows against their twins and K2's and K3's
    bits, each launch counted in the column blocks: both at p = 65 and 100
    (both dtypes), at their plans' last single block and first cluster of
    two (K9 166 and 167 in float64, 237 and 238 in float32; K10 168 and
    169, 239 and 240), at p = 200 (float64) and 240 (float32); K9 with row
    masks at p = 100 (n_s = 100) and 200. Returns the timed float64
    cases: the column blocks at p = 100."""
    from demethify_tpu_torch.ops.cuda_small import (
        alpha_column_plan, fw_column_plan)

    shapes = {(p, dt) for p in (65, 100) for dt in ("float64", "float32")}
    shapes |= {(200, "float64"), (240, "float32")}
    out = {}
    for kern, plan in (("k9", alpha_column_plan), ("k10", fw_column_plan)):
        edges = {(p, dt) for dt, size in (("float64", 8), ("float32", 4))
                 for p in (_last_single_block(plan, size),
                           _last_single_block(plan, size) + 1)}
        for p, dt in sorted(shapes | edges):
            timed = (p, dt) == (100, "float64")
            fn = _k9_case if kern == "k9" else _k10_case
            res = _glue_forms(lambda: fn(p, dt, seed=700 + p, timed=timed),
                              False)
            if timed:
                out[f"{kern} wide"] = res
    for p, n_s in ((100, 100), (200, N_S)):
        _glue_forms(lambda: _k9_case(p, "float64", n_s=n_s, seed=710 + p,
                                     mask=[1] * (p - 2) + [0, 1]), False)
    return out


def phase_global_kernels():
    """The kernels' device-memory forms past one block's shared memory
    against their twins, float64 unless stated: K1's global layout (gram
    form 160 + 4 at n_s = 64; the direct form with n_u = 12, 200 + 12 at
    n_s = 10, its state on the chip; float32 400 + 4 at n_s = 64, also on
    bf16 data); K4's
    (B = 10, 160 + 4 at n_s = 64; weighted B = 4, 205 + 4 at n_s = 10);
    K2 and K5 in their column blocks at p = 200 (K2 also at n_s = 100)
    and at 240 in float32, K2 in 9 blocks at p = 460 and n_s = 100; K3
    and K6 in their column blocks at p = 200 (clusters of two; K6 also
    with per-member known blocks) and at 240 in float32. Each at 200k
    sites (p = 460 at 50k); the timed cases with a launch's peak device
    memory. Then the global layout
    forced at shapes the shared layouts take, bit-identical to them: K1 at
    the main path's shape (1M x 10, 5 + 1, float32), in the direct form
    with n_u = 12 (the state and the residual rows on the chip), with
    n_u = 6 (registers) and with n_u = 25 at n_s = 200 (50k sites; the
    residual rebuilt each step), in the gram form with n_u = 17 (n_s = 100,
    float32), on bf16 data with bf16_compute in the gram form (n_s = 64,
    25 + 4, the raw u rows beside bf16(u)) and the direct form (5 + 6); K4
    with B = 10 (member 3 inactive), weighted with B = 4 (member 1
    inactive), and with n_u = 12 (n_s = 64, B = 4, the members' u rows
    above the state region). Returns the timed cases (the JSON rows of
    these forms)."""
    _layout_bits(N_CPG, N_S, N_CT, N_U, "float32", seed=412,
                 layouts=("resident", "global"))
    _layout_bits(N_WIDE, N_S, 5, 12, "float64", seed=413,
                 layouts=("resident", "global"))
    _layout_bits(N_WIDE, N_S, 5, 6, "float64", seed=417,
                 layouts=("resident", "global"))
    # the state on the chip, its residual rows not (rebuilt each step)
    _layout_bits(50_000, 200, 5, 25, "float64", seed=421,
                 layouts=("wide", "global"))
    _layout_bits(N_WIDE, 100, 5, 17, "float32", seed=418,
                 layouts=("wide", "global"))
    _layout_bits(N_WIDE, 64, 25, 4, "float32", data="bfloat16", seed=414,
                 layouts=("wide", "global"), bf16c=True)
    _layout_bits(N_WIDE, N_S, 5, 6, "float32", data="bfloat16", seed=419,
                 layouts=("resident", "global"), bf16c=True)
    _layout_bits(N_WIDE, N_S, N_CT, N_U, "float64", n_b=10, seed=415,
                 layouts=("resident", "global"), inactive=(3,))
    _layout_bits(N_WIDE, N_S, N_CT, N_U, "float32", n_b=4, seed=416,
                 layouts=("resident", "global"), weighted=True,
                 inactive=(1,))
    _layout_bits(N_WIDE, 64, 5, 12, "float64", n_b=4, seed=420,
                 layouts=("wide", "global"), inactive=(2,))
    out = {}
    out["k1"] = _k1_case(N_WIDE, 4, "float64", n_s=64, n_ct=160, seed=400,
                         timed=True, inner=1, reps=3, label="[global]")
    _k1_case(N_WIDE, 12, "float64", n_s=N_S, n_ct=200, seed=401,
             label="[global direct]")
    _k1_case(N_WIDE, 4, "float32", n_s=64, n_ct=400, seed=402,
             label="[global]")
    _k1_case(N_WIDE, 4, "float32", n_s=64, n_ct=400, seed=403,
             data="bfloat16", label="[global]")
    out["k4"] = _k4_case(4, "float64", 10, N_INNER, n_ct=160, inactive=(1,),
                         seed=404, timed=True, label="[global]", n=N_WIDE,
                         n_s=64, quick=True)
    out["k4w"] = _k4w_case(4, "float64", 4, N_INNER, n_ct=205, inactive=(2,),
                           seed=405, timed=True, label="[global]", n=N_WIDE)
    # K2's and K5's column blocks in clusters of two at p = 200 (float64;
    # K2 also at n_s = 100) and 240 (float32); past eight blocks:
    # phase_column_rows
    out["k2"] = _glue_forms(lambda: _k2_case(196, "float64", n_u=4,
                                             seed=406, timed=True), False)
    _glue_forms(lambda: _k2_case(196, "float64", n_u=4, seed=407, n_s=100),
                False)
    _glue_forms(lambda: _k2_case(236, "float32", n_u=4, seed=408), False)
    out["k5"] = _glue_forms(lambda: _k5_case(196, 4, "float64", 8, (3,),
                                             seed=410, timed=True), False)
    _glue_forms(lambda: _k5_case(236, 4, "float32", 4, (1,), seed=427),
                False)
    _glue_forms(lambda: _k2_case(456, "float64", n_u=4, seed=429, n=50_000,
                                 n_s=100), False)
    # K3's and K6's column blocks past one block's shared memory: clusters
    # of two blocks at p = 200 (float64) and 240 (float32), K6 also with
    # per-member known blocks (past eight blocks: phase_column_rows)
    out["k3"] = _glue_forms(lambda: _k3_case(199, "float64", seed=409,
                                             timed=True), False)
    out["k6"] = _glue_forms(lambda: _k6_case("float64", n_ct=199, seed=411,
                                             timed=True), False)
    _glue_forms(lambda: _k6w_case("float64", n_b=3, inactive=(1,),
                                  n_ct=199, seed=422), False)
    _glue_forms(lambda: _k3_case(239, "float32", seed=423), False)
    _glue_forms(lambda: _k6_case("float32", n_b=4, inactive=(1,), n_ct=239,
                                 seed=424), False)
    return out


# The glue kernels past the portable 8 blocks a column: (p, dtype) of K2,
# K5 and K9 (alpha) and of K3, K6 and K10 (fw): the old edge of 8 blocks,
# p = 460 and 490 (9 blocks), the last cluster of 16, the first device
# rows past it and p = 2000 (``cuda_small.alpha_column_plan``,
# ``fw_column_plan``); their sites, and K9's and K10's threads that own
# two rows each (p = 16 x 1024 + 100, float32)
ROWS_ALPHA = ((453, "float64"), (460, "float64"), (624, "float64"),
              (625, "float64"), (2000, "float64"), (651, "float32"),
              (904, "float32"), (905, "float32"))
ROWS_FW = ((473, "float64"), (490, "float64"), (670, "float64"),
           (671, "float64"), (2000, "float64"), (673, "float32"),
           (946, "float32"), (947, "float32"))
ROWS_SITES = 20_000
ROWS_TWO_A_THREAD = 16 * 1024 + 100


def _k5_bits_case(n_ct, n_u, dtype_name, n_b, inactive, seed,
                  weighted=False, n=200_000):
    """K5 (B members; ``weighted``: per-member known blocks) held member by
    member to K2 on that member's blocks, alpha, alpha_prev and the scalars
    bit for bit, its inactive members unchanged. For float32 past 8 blocks
    a column: there the Gram-identity cost cancels about three digits more
    than ``_k5_case``'s scalar check (each slot relative to itself) allows
    between two summation orders (3.5e-4 against 5e-5 at p = 651, 200k
    sites, on an NVIDIA H100 80GB HBM3), while ``_k2_case`` at the same
    shape holds K2 to its twin at TOL (the cost relative to sum(ydy)).
    Returns the members held."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import N_SCAL
    from demethify_tpu_torch.ops.cuda_small import (
        alpha_phase_full, alpha_phase_full_multi)

    (gtt, bt, gu, bu, usq, ydy, alpha_b, alpha_prev_b,
     scal_b) = _glue_multi_inputs(n_ct, n_u, dtype_name, n_b, inactive, seed,
                                  weighted=weighted, n=n)
    ak, apk, sk = alpha_b.clone(), alpha_prev_b.clone(), scal_b.clone()
    alpha_phase_full_multi(gtt, bt, gu, bu, usq, ydy, ak, apk, sk, N_INNER,
                           n_u)
    same = []
    for b in range(n_b):
        if b in inactive:
            same.append(torch.equal(ak[b], alpha_b[b])
                        and torch.equal(apk[b], alpha_prev_b[b])
                        and torch.equal(sk[b], scal_b[b]))
            continue
        known = (gtt[b], bt[b], ydy[b]) if weighted else (gtt, bt, ydy)
        a1, ap1, s1 = (alpha_b[b].clone(), alpha_prev_b[b].clone(),
                       scal_b[b, :N_SCAL].clone())
        alpha_phase_full(known[0], known[1], gu[b], bu[b], usq[b:b + 1],
                         known[2], a1, ap1, s1, N_INNER, n_u)
        same.append(torch.equal(a1, ak[b]) and torch.equal(ap1, apk[b])
                    and torch.equal(s1, sk[b, :N_SCAL]))
    torch.cuda.synchronize()
    log(f"[K5{'w' if weighted else ''}] B={n_b} (inactive {list(inactive)}) "
        f"p={n_ct + n_u} {dtype_name}: each active member K2's bits on its "
        f"blocks, each inactive member unchanged: {same}")
    check(all(same), "K5's members differ from K2 on their blocks")
    return {"p": n_ct + n_u, "dtype": dtype_name, "members": n_b,
            "same_as_k2": same}


def phase_column_rows():
    """The glue kernels past 8 blocks a column against their twins, float64
    at n_s = 10 unless named, 20k sites: first what the card places (the
    largest cluster, ``cudaOccupancyMaxPotentialClusterSize``, and the
    clusters it holds at once) at the plans' most shared memory (the last
    cluster of 16) and in the device rows, which must be 16 or more; then
    at each shape of ROWS_ALPHA K2, K5 (B = 8, member 3 inactive), K5 with
    per-member known blocks (B = 3) and K9 (K5 in float32 held member by
    member to K2's bits, ``_k5_bits_case``), and at each of ROWS_FW K3, K6
    (B = 8, 20 steps), K6 with per-member known blocks and K10 (20 steps;
    the per-member blocks not at p = 2000), each launch counted in the
    column blocks or, past 16 blocks, the device rows; K2, K5 and K9 with
    row masks at p = 460 and 625 (an all-ones mask bit-identical to none);
    K9 and K10 at p = ROWS_TWO_A_THREAD, n_s = 1, float32, 5 steps (their
    threads own two rows each; 500 sites: the inputs' Gram sums form p^2
    products a site). The sites only make the inputs: a launch's work is
    the p x p Grams'. Timed: K2 and K9 at p = 460 and 625, K3
    and K10 at 490 and 671 (the kernels line's rows). Returns the timed
    cases, the launches of each form in these checks and the card's
    cluster capacity."""
    from demethify_tpu_torch.ops import _build
    from demethify_tpu_torch.ops.cuda_small import (
        MAX_COLUMN_BLOCKS, alpha_column_plan, fw_column_plan,
        lib_column_capacity)

    lib = _build.load().lib
    out = {"capacity": {}, "launches": {}}
    for kernel, plan, shapes in (
            ("alpha", alpha_column_plan, ((8, 624), (4, 904), (8, 625),
                                          (8, 4115), (4, 16484))),
            ("fw", fw_column_plan, ((8, 670), (4, 946), (8, 671),
                                    (8, 25601), (4, 16484)))):
        for itemsize, p in shapes:
            cap = lib_column_capacity(lib, kernel, itemsize, p)
            pl = plan(itemsize, p)
            out["capacity"][f"{kernel}_{itemsize}_p{p}"] = dict(cap, **pl)
            log(f"[rows] {kernel} p={p} itemsize {itemsize}: plan {pl}; "
                f"the card places clusters of up to {cap['cluster']} "
                f"blocks, {cap['clusters']} of {pl['blocks']} at once")
            check(cap["cluster"] >= MAX_COLUMN_BLOCKS and cap["clusters"] >= 1,
                  f"{kernel} p = {p}: the card places no cluster of "
                  f"{MAX_COLUMN_BLOCKS} ({cap})")

    def count(res):
        for k, v in res["check_launches"].items():
            if v and ("{column blocks}" in k or "{device rows}" in k):
                out["launches"][k] = out["launches"].get(k, 0) + v
        return res

    def rows_form(plan, itemsize, p):
        return plan(itemsize, p)["device"] == 0

    for p, dt in ROWS_ALPHA:
        size = 8 if dt == "float64" else 4
        cols = rows_form(alpha_column_plan, size, p)
        t = (p, dt) in ((460, "float64"), (625, "float64"))
        seed = 1000 + p
        res = count(_glue_forms(lambda: _k2_case(
            p - 4, dt, n_u=4, seed=seed, n=ROWS_SITES, timed=t, reps=5,
            inner=10), False, columns=cols))
        if t:
            out[f"k2 p{p}"] = res
        if dt == "float64":
            count(_glue_forms(lambda: _k5_case(p - 4, 4, dt, 8, (3,),
                                               seed=seed + 1, n=ROWS_SITES),
                              False, columns=cols))
        else:
            count(_glue_forms(lambda: _k5_bits_case(
                p - 4, 4, dt, 8, (3,), seed + 1, n=ROWS_SITES), False,
                columns=cols))
        if p != 2000 and dt == "float64":
            count(_glue_forms(lambda: _k5w_case(p - 4, 4, dt, 3, (1,),
                                                seed=seed + 2, n=ROWS_SITES),
                              False, columns=cols))
        elif p != 2000:
            count(_glue_forms(lambda: _k5_bits_case(
                p - 4, 4, dt, 3, (1,), seed + 2, weighted=True,
                n=ROWS_SITES), False, columns=cols))
        res = count(_glue_forms(lambda: _k9_case(
            p, dt, seed=seed + 3, n=ROWS_SITES, timed=t), False,
            columns=cols))
        if t:
            out[f"k9 p{p}"] = res
    for p in (460, 625):
        cols = rows_form(alpha_column_plan, 8, p)
        mask = [1] * (p - 2) + [0, 1]
        count(_glue_forms(lambda: _k2_case(p - 4, "float64", n_u=4,
                                           seed=1100 + p, n=ROWS_SITES,
                                           mask=mask), False, columns=cols))
        count(_glue_forms(lambda: _k2_case(p - 4, "float64", n_u=4,
                                           seed=1101 + p, n=ROWS_SITES,
                                           mask=[1] * p), False,
                          columns=cols))
        masks = np.ones((8, p))
        masks[0, 3] = masks[7, p - 1] = 0.0
        count(_glue_forms(lambda: _k5_case(p - 4, 4, "float64", 8, (3,),
                                           seed=1102 + p,
                                           mask=masks.tolist(),
                                           n=ROWS_SITES), False,
                          columns=cols))
        count(_glue_forms(lambda: _k9_case(p, "float64", seed=1103 + p,
                                           n=ROWS_SITES, mask=mask), False,
                          columns=cols))
    for p, dt in ROWS_FW:
        size = 8 if dt == "float64" else 4
        cols = rows_form(fw_column_plan, size, p)
        t = (p, dt) in ((490, "float64"), (671, "float64"))
        seed = 1200 + p
        res = count(_glue_forms(lambda: _k3_case(
            p - 1, dt, seed=seed, n=ROWS_SITES, steps=20, timed=t, reps=5,
            inner=10), False, columns=cols))
        if t:
            out[f"k3 p{p}"] = res
        count(_glue_forms(lambda: _k6_case(dt, n_b=8, inactive=(3,),
                                           n_ct=p - 1, seed=seed + 1,
                                           steps=20, n=ROWS_SITES), False,
                          columns=cols))
        if p != 2000:
            count(_glue_forms(lambda: _k6w_case(dt, n_b=3, inactive=(1,),
                                                n_ct=p - 1, seed=seed + 2,
                                                steps=20, n=ROWS_SITES),
                              False, columns=cols))
        res = count(_glue_forms(lambda: _k10_case(
            p, dt, seed=seed + 3, n=ROWS_SITES, steps=20, timed=t), False,
            columns=cols))
        if t:
            out[f"k10 p{p}"] = res
    for fn in (_k9_case, _k10_case):
        count(_glue_forms(lambda: fn(ROWS_TWO_A_THREAD, "float32",
                                     seed=1300, n=500, n_s=1, steps=5),
                          False, columns=False))
    log(f"[rows] launches in these checks: {out['launches']}")
    return out


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


# the p = 40 path: a 39-type atlas and one unknown, 1M sites x 10
# samples, float32 (numpy data from P40_SEED)
P40 = (1_000_000, 10, 39, 1)
P40_SEED = 183


def p40_problem(seed=P40_SEED):
    """y, d, Rt of the p = 40 path on the card, made with numpy from a
    seed (float32): Rt and the true u uniform, proportions Dirichlet(1),
    coverage Poisson(50) + 1, y the mixture plus N(0, 0.01^2), clipped."""
    import torch

    n, n_s, n_ct, n_u = P40
    rng = np.random.default_rng(seed)
    R = rng.random((n, n_ct + n_u), dtype=np.float32)
    alpha = rng.dirichlet(np.ones(n_ct + n_u), size=n_s).T.astype(
        np.float32)
    d = (rng.poisson(50, size=(n, n_s)) + 1).astype(np.float32)
    y = np.clip(R @ alpha + 0.01 * rng.standard_normal(
        (n, n_s), dtype=np.float32), 0, 1)
    return tuple(torch.as_tensor(np.ascontiguousarray(x), device=DEV)
                 for x in (y, d, R[:, :n_ct]))


def p40_runs(y, d, Rt, pur):
    """The p = 40 path's two runs through ``solvers.api``: (tag, outer
    iterations, inner steps, glue kernel, call): partial-reference 100 x 20
    and purity 10 x 500, tol = 0, one restart."""
    from demethify_tpu_torch.solvers.api import (
        partial_reference_deconv, purity_deconv)

    n_u = P40[3]
    kw = dict(tol=0.0, record_trace=True)
    return (
        ("p=40", 100, N_INNER, "alpha_phase_full",
         lambda n1: partial_reference_deconv(
             y, d, Rt, n_u, n_iter1=n1, n_iter2=N_INNER, seed=13, **kw)),
        ("p=40 purity", 10, P_INNER, "fw_phase_full",
         lambda n1: purity_deconv(y, d, Rt, n_u, pur, n_iter1=n1,
                                  n_iter2=P_INNER, seed=14, **kw)))


def _profiled_us(call, kernels):
    """{kernel: device us per launch} of one ``call()`` traced by
    ``utils.device_profile``, for each name in ``kernels`` (summed over
    the trace's kernels whose name holds it)."""
    from demethify_tpu_torch.utils import device_profile

    with tempfile.TemporaryDirectory() as tmp:
        with device_profile(tmp, "trace.json"):
            call()
        traced = _trace_kernels(os.path.join(tmp, "trace.json"))
    out = {}
    for name in kernels:
        hits = [v for k, v in traced.items() if name in k]
        n = sum(c for c, _ in hits)
        out[name] = sum(us for _, us in hits) / n if n else None
    return out


def phase_envelope_paths(card):
    """The wide forms on paths through ``solvers.api``, each run with the
    counters set to 0 just before and read just after: partial-reference
    at 1M x 100, 25 + 4 in float64 (K1 in the wide layout, 100 x 20), its
    restarts (B = 4, 200k sites, 50 x 20: K4 wide); 25 + 12 at
    200k x 100, float64 (p = 37 and n_u > 8: K1 and K4 wide with the
    state on the chip, K2, K3, K5 and K6 in the two-row form): partial-
    reference 50 x 20, purity 10 x 100, and both with 4 restarts; and the
    p = 40 path (39 + 1 at 1M x 10, float32: K2 and K3 in the two-row
    form): partial-reference 100 x 20 and purity 10 x 500, with K1's and
    the glue kernel's device us per launch from ``utils.device_profile``
    over 10 more outer iterations. Before each, the kernel solver that
    path runs against the plain solver on the same data and inits over a
    short schedule (``_envelope_vs_plain``: 20 x 20, purity 5 x 100,
    restarts per member). Returns each run's launches by name, and the
    p = 40 runs' ms per outer iteration and device us."""
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
                                         f"{k}{{n_u>8, state on chip}}": n1,
                                         f"{k}{{wide}}": n1,
                                         f"{glue}{{p>32}}": n1,
                                         f"{glue}{{two-row}}": n1}),
              f"{tag} launches {out[tag]}")
    del y, d, Rt

    from demethify_tpu_torch.ops.cuda_kernels import u_phase_layout

    n, n_s, n_ct, n_u = P40
    y, d, Rt = p40_problem()
    pur = torch.linspace(0.3, 0.9, n_s, device=DEV, dtype=y.dtype)
    layout = u_phase_layout("K1", 4, n_s, n_ct, n_u)[0]
    out["p40"] = {}
    for tag, n1, n2, glue, call in p40_runs(y, d, Rt, pur):
        pu = None if glue == "alpha_phase_full" else pur
        _envelope_vs_plain(tag, 1, y, d, Rt, n_u, pu,
                           20 if pu is None else 5, N_INNER if pu is None
                           else 100, 15 if pu is None else 16)
        _, ms_it, out[tag] = _drive(
            tag, f"{n} x {n_s}, {n_ct}+{n_u} (p = {n_ct + n_u}), float32, "
            f"{n1}x{n2}, card {card}", lambda: call(n1), n1, n_sites=n)
        want = {"u_phase_grams": n1, glue: n1, f"{glue}{{p>32}}": n1,
                f"{glue}{{two-row}}": n1}
        if layout != "resident":
            want[f"u_phase_grams{{{layout}}}"] = n1
        check(expect_counts(out[tag], **want),
              f"{tag} launches {out[tag]}, want {want}")
        glue_kernel = glue.replace("_full", "") + "_two_row_kernel"
        us = _profiled_us(lambda: call(10), (K1_KERNEL, glue_kernel))
        out["p40"][tag] = {"ms_per_outer": ms_it, "k1_us": us[K1_KERNEL],
                           "glue_us": us[glue_kernel], "layout": layout}
        log(f"[{tag}] K1 {us[K1_KERNEL]:.2f} us and {glue} "
            f"{us[glue_kernel]:.2f} us of device time a launch "
            f"(utils.device_profile, 10 outer iterations), "
            f"{ms_it:.4f} ms per outer iteration, card {card}")
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


# ------------------------------------------- phase 9: the single-phase kernels
# K7 u_phase, K8 grams, K9 alpha_phase and K10 fw_phase: the JAX package's
# single-phase Pallas kernels, which no solver of either package runs;
# they compose into the plain solver's outer iteration (``composed_solve``).
# K8's sums over 1M sites are held to TOL[...]["gram"] of each output's
# largest entry (bf16 data: float32 sums, the float32 bound; the twin rounds
# at the kernel's points).


def composed_solve(u0, alpha0, y, d, Rt, n_u, n_iter1, n_iter2, tol=0.0):
    """The outer iteration of ``solvers/partial_ref.partial_ref_solve``
    composed from the single-phase kernels, unfused: K7 ``u_phase`` (the U
    FISTA loop from the current alpha), K8 ``grams`` on [Rt | u], the
    Lipschitz constants and the Gram-identity cost as that solver computes
    them (``partial_ref.py:95-99``), then K9 ``alpha_phase``; the same
    start, scalars and termination test. u0 (N, n_u), alpha0 (p, n_s), y,
    d (N, n_s) and Rt (N, n_ct), float32 or float64, on one device: on the
    card the kernels run, on the CPU their twins. A check that the
    kernels compose into the plain solver's trajectory, not a solver of
    the package. Returns (u (N, n_u), alpha, cost trace (n_iter,))."""
    import torch

    from demethify_tpu_torch.ops.cost import weighted_cost, weighted_cost_gram
    from demethify_tpu_torch.ops.cuda_kernels import grams, u_phase
    from demethify_tpu_torch.ops.cuda_small import alpha_phase
    from demethify_tpu_torch.ops.gram import (
        accum_dtype, coverage_max2, row_sum_sq)

    dtype = accum_dtype(y)
    yt, dt, rtt = (x.T.contiguous() for x in (y, d, Rt))
    alpha = alpha0.to(dtype)
    R0 = torch.cat([Rt.to(dtype), u0.to(dtype)], dim=1)
    dmax2 = coverage_max2(d, None, dtype)
    u_sq = row_sum_sq(None, dtype)
    rt_sq = u_sq(Rt)
    l_h = torch.sum(R0 * R0) * dmax2
    l_w = torch.sum(alpha[-n_u:] ** 2) * dmax2
    cf = weighted_cost(y, R0, alpha, d)
    one = torch.ones((), dtype=dtype, device=y.device)
    ut = u0.to(dtype).T.contiguous()
    u_prev_t, alpha_prev = ut, alpha
    a1, a2, l_w_prev, l_h_prev = one, one, l_w, l_h
    cf_prev = torch.full((), float("inf"), dtype=dtype, device=y.device)
    trace = []
    while len(trace) < n_iter1 and bool(torch.abs(cf - cf_prev) >= tol):
        ut, u_prev_t, a1, l_w_prev = u_phase(
            yt, dt, rtt, alpha[:-n_u], alpha[-n_u:], ut, u_prev_t, a1, l_w,
            l_w_prev, n_iter2)
        G, b, ydy = grams(yt, dt, torch.cat([rtt, ut]))
        l_h = (rt_sq + u_sq(ut.T)) * dmax2
        alpha, alpha_prev, a2, l_h_prev = alpha_phase(
            G, b, alpha, alpha_prev, a2, l_h_prev, l_h, n_iter2)
        l_w = torch.sum(alpha[-n_u:] ** 2) * dmax2
        cf_prev, cf = cf, weighted_cost_gram(G, b, ydy, alpha)
        trace.append(cf)
    return ut.T, alpha, torch.stack(trace)


def k7_work(n, n_s, n_ct, n_u, steps, itemsize, data_itemsize):
    """(bytes, flops) of K7 on n sites: Y, D, Rt read once, u and u_prev
    read and written; per site the known-block residual d (y - a1' rt)
    (d y without a known block), C and M (the pair products formed once
    per launch) and the FISTA steps, counted as ``u_phase_work`` counts
    K1's (which adds the Gram stage)."""
    pairs = n_u * (n_u + 1) // 2
    n_bytes = n * (data_itemsize * (2 * n_s + n_ct) + itemsize * 4 * n_u)
    per_site = (n_s * (2 * n_ct + (2 if n_ct else 1) + 2 * n_u + 2 * pairs)
                + steps * (6 * n_u + 2 * n_u * n_u))
    return n_bytes, per_site * n + n_s * pairs


def k8_work(n, n_s, p, data_itemsize, itemsize, rounded=False):
    """(bytes, flops) of K8: Y, D and R read once, G, b and ydy written.
    The fewest operations the function needs: G[s] is symmetric in float32
    and float64, so per site the p (p + 1) / 2 pair products r_q r_r
    (shared by the samples), and per site and sample the upper triangle's
    terms (2 each, p (p + 1)), d y (1), b (2 p) and ydy (2). Under bf16
    data (``rounded``) G's left factor is bf16(r d_s), so G is not
    symmetric: per site and sample r d_s (p), every G term (2 p^2), d y,
    b and ydy. ``bound`` takes these at the tensor-core route's rate
    (``K8_ROUTE``) and, for the history, at 67 TFLOP/s."""
    n_bytes = (n * data_itemsize * (2 * n_s + p)
               + itemsize * (n_s * p * p + p * n_s + n_s))
    if rounded:
        return n_bytes, n * n_s * (2 * p * p + 3 * p + 3)
    return n_bytes, n * (p * (p + 1) // 2 + n_s * (p * p + 3 * p + 3))


def phase_glue_work(p, n_s, steps, itemsize, fw=False):
    """(bytes, flops) of K9 (alpha FISTA) or K10 (Frank-Wolfe, ``fw``): G
    and b read, alpha (and alpha_prev, K9) read and written, purity read
    (K10); per step and column the p x p product and the projection or the
    block argmin (about 6 p operations)."""
    n_bytes = itemsize * (n_s * p * p + p * n_s + (2 if fw else 4) * p * n_s
                          + (n_s if fw else 0))
    return n_bytes, n_s * steps * (2 * p * p + 6 * p)


def _k7_case(n, n_u, dtype_name, steps=N_INNER, seed=300, timed=False,
             n_s=N_S, n_ct=N_CT, lagged=False, label="", data=None,
             with_k1=False):
    """K7 against its twin: u, u_prev, the advanced scalars, and its inputs
    left as they were. ``data`` "bfloat16" stores Y, D, Rt in bf16 (a
    float32 state, held to the float32 bounds). ``timed`` adds the device
    ms (back to back, and queued behind a device sleep where short), the
    twin's, the bound and, ``with_k1``, K1's ms on the same data (K7's
    work plus the Gram stage)."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import (
        A_U, L_W, L_W_PREV, u_phase, u_phase_grams, u_phase_plain)

    dtype = getattr(torch, dtype_name)
    ydt, rtt, alpha, uut, scal = _k1_inputs(n, n_s, n_ct, n_u, dtype, seed)
    if data is not None:
        ydt, rtt = (x.to(getattr(torch, data)) for x in (ydt, rtt))
    yt, dt = ydt[:n_s], ydt[n_s:]
    ut, up = uut[:n_u], uut[n_u:]
    a1, a2 = alpha[:-n_u], alpha[-n_u:]
    if n_ct == 0:
        rtt = a1 = None
    sc = (scal[A_U], scal[L_W], scal[L_W_PREV])
    before = [x.clone() for x in (yt, dt, ut, up)]
    uk, upk, ak, lk = u_phase(yt, dt, rtt, a1, a2, ut, up, *sc, steps,
                              lagged=lagged)
    u_p, upp, a_p, l_p = u_phase_plain(yt, dt, rtt, a1, a2, ut, up, *sc,
                                       steps, lagged=lagged)
    torch.cuda.synchronize()
    unchanged = all(torch.equal(x, y) for x, y in zip(before,
                                                      (yt, dt, ut, up)))
    err_u = float(torch.maximum((uk - u_p).abs().max(),
                                (upk - upp).abs().max()))
    err_s = max(abs(float(ak) / float(a_p) - 1),
                abs(float(lk) / float(l_p) - 1))
    tol = TOL[dtype_name]
    data_name = str(yt.dtype).replace("torch.", "")
    res = {"n": n, "n_s": n_s, "n_ct": n_ct, "n_u": n_u, "steps": steps,
           "lagged": lagged, "dtype": dtype_name,
           "data": data_name, "u_max_abs": err_u, "scal_rel": err_s}
    if timed:
        def run():
            return u_phase(yt, dt, rtt, a1, a2, ut, up, *sc, steps,
                           lagged=lagged)
        inner = 10 if n_s * (n_ct + n_u) <= 200 else 2
        res["ms"] = median_ms(run, inner=inner)
        if inner == 10:
            res["queued_ms"] = queued_ms(run, inner=20)
        res["plain_ms"] = median_ms(lambda: u_phase_plain(
            yt, dt, rtt, a1, a2, ut, up, *sc, steps, lagged=lagged), reps=3,
            inner=1, warmup=1)
        res["bound_ms"], res["bound_by"] = bound(
            *k7_work(n, n_s, n_ct, n_u, steps, ut.element_size(),
                     yt.element_size()), dtype_name)
        if with_k1:
            uu, s1 = uut.clone(), scal.clone()
            res["k1_ms"] = median_ms(lambda: u_phase_grams(
                ydt, rtt, a1, a2, uu, s1, steps, lagged), inner=inner)
    log(f"[K7]{label} N={n} n_s={n_s} n_ct={n_ct} n_u={n_u}"
        f"{' lagged' if lagged else ''} {steps} steps {dtype_name} state, "
        f"{data_name} data: u, u_prev max|diff| {err_u:.3e} (tol "
        f"{tol['u']:.0e}); a, l_w_prev rel {err_s:.3e}; inputs unchanged: "
        f"{unchanged}"
        + ((f"; kernel {res['ms']:.4f} ms"
            + (f" (queued {res['queued_ms']:.4f})" if "queued_ms" in res
               else "")
            + f", plain {res['plain_ms']:.4f} ms, bound "
            f"{res['bound_ms']:.4f} ms ({res['bound_by']})"
            + (f"; K1 on the same data {res['k1_ms']:.4f} ms (K7 / K1 "
               f"{res['ms'] / res['k1_ms']:.3f})" if with_k1 else ""))
           if timed else ""))
    check(np.isfinite([err_u, err_s]).all(), "K7 non-finite")
    check(err_u <= tol["u"], f"K7 u differs from its twin by {err_u}")
    check(err_s <= (1e-12 if dtype_name == "float64" else 1e-6),
          f"K7 scalars differ by {err_s}")
    check(unchanged, "K7 changed its inputs")
    return res


def _grams_inputs(n, n_s, p, dtype, seed):
    """Yt, Dt (n_s, n) and Rt (p, n) of a K1-style problem on the card."""
    import torch

    g = torch.Generator(device=DEV).manual_seed(seed)
    rt = torch.rand((p, n), generator=g, device=DEV, dtype=dtype)
    d = torch.poisson(torch.full((n_s, n), 50.0, device=DEV),
                      generator=g).to(dtype) + 1
    e = torch.empty((p, n_s), device=DEV, dtype=dtype).exponential_(
        generator=g)
    y = ((e / e.sum(0)).T @ rt).clamp(0, 1)
    return y.contiguous(), d.contiguous(), rt


def _k8_case(n, n_s, p, dtype_name, data=None, seed=320, timed=False,
             library=False, label=""):
    """K8 against its twin, each output relative to its largest entry, and
    a second launch on the same inputs to the same bits; ``timed`` takes
    its ms queued behind a device sleep (a launch at the main path's shape
    is short beside its wrapper's host work), the back-to-back median
    beside it, the twin's ms and the bound at the tensor-core route's rate
    (``K8_ROUTE``) with the CUDA-core bound (67 TFLOP/s) beside it.
    ``library`` times the PyTorch calls that compute the same (G, b, ydy),
    which the port never calls: ``torch.einsum("sn,qn,rn->sqr", D, R,
    R)``, ``R @ (D * Y).T`` and ``torch.sum(D * Y * Y, 1)``."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import grams, grams_plain

    dtype = getattr(torch, dtype_name)
    yt, dt, rt = _grams_inputs(n, n_s, p, dtype, seed)
    if data is not None:
        yt, dt, rt = (x.to(getattr(torch, data)) for x in (yt, dt, rt))
    got = grams(yt, dt, rt)
    again = grams(yt, dt, rt)
    want = grams_plain(yt, dt, rt)
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    rel = [float((k - w).abs().max() / w.abs().max())
           for k, w in zip(got, want)]
    err = max(float((k - w).abs().max()) for k, w in zip(got, want))
    tol = TOL[dtype_name]["gram"]
    data_name = str(yt.dtype).replace("torch.", "")
    res = {"n": n, "n_s": n_s, "p": p, "dtype": dtype_name,
           "data": data_name, "rel": rel, "max_abs_err": err,
           "repeat_same": same}
    if timed:
        res["ms"] = queued_ms(lambda: grams(yt, dt, rt), inner=10)
        res["back_to_back_ms"] = median_ms(lambda: grams(yt, dt, rt),
                                           inner=5)
        res["plain_ms"] = median_ms(lambda: grams_plain(yt, dt, rt), reps=3,
                                    inner=1, warmup=1)
        work = k8_work(n, n_s, p, yt.element_size(), got[0].element_size(),
                       yt.dtype == torch.bfloat16)
        route = K8_ROUTE[data_name]
        res["bound_ms"], res["bound_by"] = bound(*work, route)
        res["bound_rate"] = route
        res["cuda_core_bound_ms"], res["cuda_core_bound_by"] = bound(
            *work, dtype_name)
    if library:
        def lib_calls():
            return (torch.einsum("sn,qn,rn->sqr", dt, rt, rt),
                    rt @ (dt * yt).T, torch.sum(dt * yt * yt, 1))
        res["library_rel"] = [float((k - w).abs().max() / w.abs().max())
                              for k, w in zip(got, lib_calls())]
        res["library_ms"] = median_ms(lib_calls, reps=3, inner=1, warmup=1)
    log(f"[K8]{label} N={n} n_s={n_s} p={p} {data_name} data: G, b, ydy "
        f"max|diff| / max|entry| {rel[0]:.3e}, {rel[1]:.3e}, {rel[2]:.3e} "
        f"(tol {tol:.0e}); a second launch gives the same bits: {same}"
        + (f"; kernel {res['ms']:.4f} ms queued behind a device sleep "
           f"({res['back_to_back_ms']:.4f} back to back), plain "
           f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
           f"({res['bound_by']}, {route}; at 67 TFLOP/s "
           f"{res['cuda_core_bound_ms']:.4f} ms, "
           f"{res['cuda_core_bound_by']})" if timed else "")
        + (f"; library calls (einsum, matmul, sum) {res['library_ms']:.4f} "
           f"ms, their results within {max(res['library_rel']):.3e}"
           if library else ""))
    check(np.isfinite(rel).all(), "K8 non-finite")
    check(max(rel) <= tol, f"K8 differs from its twin by {max(rel)}")
    check(same, "K8 gave other bits on a second launch")
    return res


def _k8_sass():
    """The tensor-core instructions in K8's main passes, from
    ``cuobjdump -sass`` of the built library: HMMA in the float32 and bf16
    kernels, DMMA in the float64 one. Returns the counts per kernel."""
    from demethify_tpu_torch.ops import _build

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", _build.load().path],
                          capture_output=True, text=True, timeout=300).stdout
    counts, func = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            m2 = re.search(r"grams_kernelILi(\d)E", m.group(1))
            func = ("float32", "float64", "bf16")[int(m2.group(1))] \
                if m2 else None
            if func:
                counts[func] = {"HMMA": 0, "DMMA": 0}
            continue
        if func:
            for op in ("HMMA", "DMMA"):
                counts[func][op] += op in ln
    log(f"[K8 SASS] tensor-core instructions in the main passes: {counts}")
    check(set(counts) == {"float32", "float64", "bf16"}
          and counts["float32"]["HMMA"] > 0 and counts["bf16"]["HMMA"] > 0
          and counts["float64"]["DMMA"] > 0,
          "K8's main passes do not run on the tensor cores")
    return counts


def _k8_rounding_case(n=200, n_s=N_S, p=N_CT + N_U, seed=321):
    """K8 on bf16 data at a size where its rounding shows: held to its
    twin's rounding points with the sums taken in float64 (each rounded
    product of bf16 values, and its product with the other factor, is
    exact in float32, so that reference leaves only the kernel's float32
    summation error, within 1e-6 of each output's largest entry), and
    apart from ``ops/gram.sample_grams``, which rounds neither r d_s nor
    the G terms: G and b at least 100 times that bound away, as
    ``tests/test_torch_phases.py`` holds the twin on the CPU. A kernel
    that skipped the rounding would sit near ``sample_grams``."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import (
        bf16_round, grams, grams_plain)
    from demethify_tpu_torch.ops.gram import sample_grams

    yt, dt, rt = (x.to(torch.bfloat16) for x in _grams_inputs(
        n, n_s, p, torch.float32, seed))
    got = grams(yt, dt, rt)
    y, d, r = (x.float() for x in (yt, dt, rt))
    dy = bf16_round(d * y)
    rd = bf16_round(r[None] * d[:, None])
    exact = (torch.einsum("sqn,rn->sqr", rd.double(), r.double()),
             r.double() @ dy.double().T, (dy.double() * y.double()).sum(1))
    refs = {"twin in float64": exact, "twin": grams_plain(yt, dt, rt),
            "sample_grams": sample_grams(rt.T, dt.T, yt.T)}
    torch.cuda.synchronize()
    rel = {k: [float((g.double() - w.double()).abs().max()
                     / w.double().abs().max()) for g, w in zip(got, ref)]
           for k, ref in refs.items()}
    tol = 1e-6
    log(f"[K8 rounding] N={n} n_s={n_s} p={p} bf16 data: G, b, ydy max|diff|"
        f" / max|entry| against "
        + "; ".join(f"{k} {v[0]:.3e}, {v[1]:.3e}, {v[2]:.3e}"
                    for k, v in rel.items())
        + f" (tol {tol:.0e} against the float64 twin; G and b at least "
        f"{100 * tol:.0e} from sample_grams)")
    check(max(rel["twin in float64"]) <= tol,
          "K8 on bf16 data differs from its twin's rounding")
    check(min(rel["sample_grams"][:2]) >= 100 * tol,
          "K8 on bf16 data sits near the unrounded sums of sample_grams")
    return rel


def _phase_glue_inputs(p, n_ct, dtype_name, seed, n_s=N_S, n=200_000):
    """K2's inputs (``_small_inputs`` on n sites) with their assembled G,
    b, an alpha_prev and the scalar vector K2 reads (A_ALPHA, L_H_PREV,
    RT_SQ, DMAX2 set)."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import (
        A_ALPHA, DMAX2, L_H_PREV, RT_SQ)
    from demethify_tpu_torch.ops.cuda_small import assemble_G_b

    gtt, bt, gu, bu, usq, ydy, alpha, ydt, rtt, scal = _small_inputs(
        n_ct, p - n_ct, dtype_name, n, seed, n_s)
    dmax2 = ydt[n_s:].max() ** 2
    rt_sq = torch.sum(rtt * rtt)
    scal[A_ALPHA], scal[RT_SQ], scal[DMAX2] = 1.8, rt_sq, dmax2
    scal[L_H_PREV] = 1.05 * (rt_sq + usq[0]) * dmax2
    G, b = (x.contiguous() for x in assemble_G_b(gtt, bt, gu, bu))
    g = torch.Generator(device=DEV).manual_seed(seed + 1)
    e = torch.empty_like(alpha).exponential_(generator=g)
    alpha_prev = (e / e.sum(0)).contiguous()
    return (gtt, bt, gu, bu, usq, ydy), G, b, alpha, alpha_prev, scal


def _k9_case(p, dtype_name, n_ct=None, n_s=N_S, mask=None, seed=340,
             timed=False, n=200_000, steps=N_INNER):
    """K9 against its twin; with K2's inputs (n sites), K9 on K2's
    assembled G and b and K2's scalars gives K2's alpha, alpha_prev and
    scalars bit for bit (one loop body, ``glue_steps.cuh`` and
    ``column_steps.cuh``). A masked case also checks its masked rows are
    exactly 0."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import (
        A_ALPHA, DMAX2, L_H_PREV, RT_SQ)
    from demethify_tpu_torch.ops.cuda_small import (
        alpha_phase, alpha_phase_full, alpha_phase_plain)

    n_ct = p - N_U if n_ct is None else n_ct
    blocks, G, b, alpha, alpha_prev, scal = _phase_glue_inputs(
        p, n_ct, dtype_name, seed, n_s, n)
    l_h = (scal[RT_SQ] + blocks[4][0]) * scal[DMAX2]
    sc = (scal[A_ALPHA], scal[L_H_PREV], l_h)
    mask_t = None if mask is None else torch.as_tensor(
        mask, device=DEV, dtype=alpha.dtype)
    ak, apk, a_k, l_k = alpha_phase(G, b, alpha, alpha_prev, *sc, steps,
                                    row_mask=mask_t)
    a_pl, ap_pl, a_p, l_p = alpha_phase_plain(G, b, alpha, alpha_prev, *sc,
                                              steps, mask_t)
    a2, ap2, s2 = alpha.clone(), alpha_prev.clone(), scal.clone()
    alpha_phase_full(*blocks, a2, ap2, s2, steps, p - n_ct,
                     **({} if mask_t is None else {"row_mask": mask_t}))
    torch.cuda.synchronize()
    same_k2 = (torch.equal(ak, a2) and torch.equal(apk, ap2)
               and bool(a_k == s2[A_ALPHA]) and bool(l_k == s2[L_H_PREV]))
    err_a = float(torch.maximum((ak - a_pl).abs().max(),
                                (apk - ap_pl).abs().max()))
    err_s = max(abs(float(a_k) / float(a_p) - 1),
                abs(float(l_k) / float(l_p) - 1))
    masked_zero = mask_t is None or bool((ak[~(mask_t > 0)] == 0).all())
    tol = TOL[dtype_name]
    res = {"p": p, "n_s": n_s, "dtype": dtype_name, "masked": mask is not None,
           "alpha_max_abs": err_a, "same_as_k2": same_k2}
    if timed:
        def run():
            return alpha_phase(G, b, alpha, alpha_prev, *sc, steps,
                               row_mask=mask_t)
        res["ms"] = queued_ms(run, inner=20)
        res["plain_ms"] = median_ms(lambda: alpha_phase_plain(
            G, b, alpha, alpha_prev, *sc, steps, mask_t), inner=5)
        res["bound_ms"], res["bound_by"] = bound(
            *phase_glue_work(p, n_s, steps, alpha.element_size()),
            dtype_name)
    log(f"[K9] p={p} n_s={n_s} {dtype_name}"
        f"{' masked' if mask is not None else ''}: alpha, alpha_prev "
        f"max|diff| {err_a:.3e} (tol {tol['alpha']:.0e}), a, l_h_prev rel "
        f"{err_s:.3e}; on K2's assembled G, b: K2's bits {same_k2}"
        + (f"; kernel {res['ms']:.4f} ms (queued behind a device sleep), "
           f"plain {res['plain_ms']:.4f} ms, bound {res['bound_ms']:.2e} ms "
           f"({res['bound_by']})" if timed else ""))
    check(np.isfinite([err_a, err_s]).all(), "K9 non-finite")
    check(err_a <= tol["alpha"], f"K9 alpha differs from its twin by {err_a}")
    check(err_s <= (1e-12 if dtype_name == "float64" else 1e-6),
          "K9 scalars differ")
    check(same_k2, "K9 on K2's assembled Grams differs from K2")
    check(masked_zero, "K9's masked rows are not 0")
    return res


def _fw_phase_flips(G, b, a1, a2, purity, n_steps):
    """``_fw_flips`` for K10: its iterate after k steps is one launch of k
    steps, its vertex (alpha_{k+1} - (1 - gamma_k) alpha_k) / gamma_k,
    against the argmin of the twin's gradient expression at that
    iterate."""
    import torch

    from demethify_tpu_torch.ops.cuda_small import fw_phase

    p1 = a1.shape[0]
    traj = [torch.cat([a1, a2])]
    for k in range(1, n_steps + 1):
        traj.append(torch.cat(fw_phase(G, b, a1, a2, purity, k)))
    traj = torch.stack(traj)
    k = torch.arange(n_steps, device=a1.device, dtype=a1.dtype)
    gamma = (2.0 / (k + 2.0))[:, None, None]
    vert = (traj[1:] - (1.0 - gamma) * traj[:-1]) / gamma
    grad = torch.stack([torch.einsum("spq,qs->ps", G, a) - b
                        for a in traj[:-1]])
    flips = 0
    for lo, hi in ((0, p1), (p1, traj.shape[1])):
        flips += int((torch.argmin(grad[:, lo:hi], dim=1)
                      != torch.argmax(vert[:, lo:hi], dim=1)).sum())
    return flips


def _k10_case(p, dtype_name, n_s=N_S, seed=360, timed=False, steps=P_INNER,
              n=200_000):
    """K10 against its twin, with its vertex flips counted as K3's; with
    K3's inputs (n sites), K10 on K3's assembled G and b gives K3's alpha
    bit for bit."""
    import torch

    from demethify_tpu_torch.ops.cuda_small import (
        fw_phase, fw_phase_full, fw_phase_plain)

    n_ct = p - N_U
    blocks, G, b, alpha, _, scal = _phase_glue_inputs(p, n_ct, dtype_name,
                                                      seed, n_s, n)
    rng = np.random.default_rng(seed)
    purity = torch.as_tensor(rng.uniform(0.3, 0.9, size=n_s), device=DEV,
                             dtype=alpha.dtype)
    a1 = (alpha[:n_ct] / alpha[:n_ct].sum(0) * purity).contiguous()
    a2 = (alpha[n_ct:] / alpha[n_ct:].sum(0) * (1 - purity)).contiguous()
    k1, k2 = fw_phase(G, b, a1, a2, purity, steps)
    p1, p2 = fw_phase_plain(G, b, a1, a2, purity, steps)
    a3 = torch.cat([a1, a2])
    gtt, bt, gu, bu, _, ydy = blocks
    fw_phase_full(gtt, bt, gu, bu, ydy, a3, purity, scal.clone(), steps,
                  N_U)
    torch.cuda.synchronize()
    same_k3 = torch.equal(torch.cat([k1, k2]), a3)
    err_a = float(torch.maximum((k1 - p1).abs().max(),
                                (k2 - p2).abs().max()))
    flips = _fw_phase_flips(G, b, a1, a2, purity, steps)
    tol_a = K3_TOL[dtype_name] + 4.0 * flips / steps
    res = {"p": p, "n_s": n_s, "dtype": dtype_name, "alpha_max_abs": err_a,
           "flips": flips, "same_as_k3": same_k3}
    if timed:
        res["ms"] = queued_ms(lambda: fw_phase(G, b, a1, a2, purity, steps),
                              inner=10)
        res["plain_ms"] = median_ms(lambda: fw_phase_plain(
            G, b, a1, a2, purity, steps), reps=3, inner=1, warmup=1)
        res["bound_ms"], res["bound_by"] = bound(
            *phase_glue_work(p, n_s, steps, a1.element_size(), fw=True),
            dtype_name)
    log(f"[K10] p={p} n_s={n_s} {steps} steps {dtype_name}: alpha "
        f"max|diff| {err_a:.3e} (tol {tol_a:.1e}); vertex choices that "
        f"differ from the twin's at the same iterate: {flips} of "
        f"{2 * steps * n_s}; on K3's assembled G, b: K3's bits {same_k3}"
        + (f"; kernel {res['ms']:.4f} ms (queued behind a device sleep), "
           f"plain {res['plain_ms']:.4f} ms, bound {res['bound_ms']:.2e} ms "
           f"({res['bound_by']})" if timed else ""))
    check(np.isfinite(err_a), "K10 non-finite")
    check(err_a <= tol_a, f"K10 alpha differs from its twin by {err_a}")
    check(dtype_name == "float32" or flips == 0,
          f"K10 float64 vertex choices differ ({flips})")
    check(same_k3, "K10 on K3's assembled Grams differs from K3")
    return res


def _single_phase_plans():
    """K7's and K8's shared-memory plans in Python against the sources'
    ``dm_u_phase_smem`` and ``dm_grams_smem`` exports (K8: the plan of
    every data kind at 1M sites, n_s 1-500, p 1-64)."""
    from demethify_tpu_torch.ops import _build
    from demethify_tpu_torch.ops.cuda_kernels import (
        grams_plan, grams_smem, k7_smem)

    lib = _build.load().lib
    bad, n_checked = [], 0
    for itemsize in (4, 8):
        for n_ct in (0, 1, 5, 25, 100, 225):
            n_checked += 1
            if lib.dm_u_phase_smem(itemsize, n_ct) != k7_smem(itemsize,
                                                               n_ct):
                bad.append(("K7", itemsize, n_ct))
    for kind in (0, 1, 2):
        for p in (1, 6, 11, 29, 40, 64):
            for n_s in (1, 10, 13, 100, 500):
                pl = grams_plan(N_CPG, n_s, p, kind)
                args = (kind, p, pl.group_samples, pl.tile, pl.stages,
                        pl.items, pl.slices)
                n_checked += 1
                if not (lib.dm_grams_smem(*args) == grams_smem(*args)
                        == pl.smem):
                    bad.append(("K8", kind, p, n_s))
    log(f"[K7/K8 plans] {n_checked} shared-memory plans against the "
        f"sources' exports, {len(bad)} differ {bad[:5]}")
    check(not bad, "K7/K8 shared-memory plans differ from the kernels'")


def phase_single_phase_kernels(card, main_ms):
    """Phase 9: K7-K10 against their twins on the card (K9 and K10 also
    against K2's and K3's bits on the same Grams; K8 on bf16 data also
    where its rounding shows), and the composed unfused outer iteration
    K7 -> K8 -> K9 held to the plain solver (200k x 10, 5 + 1, float64,
    20 x 20, the same seeded inits)
    and timed at full width (1M x 10, 5 + 1, float32, 1000 x 20, tol = 0)
    beside the fused main path's ``main_ms`` from the same run. Returns
    the timed cases and the composed loop's launches and ms."""
    import torch

    from demethify_tpu_torch import state
    from demethify_tpu_torch.ops import cuda_small
    from demethify_tpu_torch.ops.cuda_kernels import u_phase
    from demethify_tpu_torch.solvers.partial_ref import partial_ref_solve

    _single_phase_plans()
    out = {}
    k7 = out["k7"] = _k7_case(N_CPG, N_U, "float32", timed=True,
                              with_k1=True)
    # float64, bf16 data and the purity schedule held to the twin, untimed
    # (their times are on record, PERF.md) at N_WIDE sites: no user path
    # runs K7, and the twin at 1M sites took the phase's time
    _k7_case(N_WIDE, N_U, "float64")
    _k7_case(N_WIDE, N_U, "float32", data="bfloat16", label="[bf16]")
    _k7_case(N_WIDE, U_N_U, "float32", n_ct=0, lagged=True, seed=301,
             label="[lagged, no known block]")
    _k7_case(N_WIDE, U_N_U, "float64", n_ct=0, lagged=True, seed=301,
             label="[lagged, no known block]")
    _k7_case(N_WIDE, N_U, "float32", steps=P_INNER, seed=302,
             label="[500 steps]")
    out["k7_cohort"] = _k7_case(COHORT[0], COHORT[3], "float32",
                                n_s=COHORT[1], n_ct=COHORT[2], seed=303,
                                timed=True, with_k1=True, label="[cohort]")
    # K7's n_u > 8 form (K1's state-region code on a device buffer),
    # counted apart
    before = u_phase.forms.get("state_in_device", 0)
    _k7_case(N_WIDE, 12, "float64", n_s=100, n_ct=5, seed=304,
             label="[n_u=12]")
    _k7_case(N_WIDE, 25, "float32", seed=306, label="[n_u=25]")
    check(u_phase.forms.get("state_in_device", 0) == before + 2,
          "K7's n_u > 8 launches were not counted as its state-region form")
    _k7_case(N_WIDE + 3, N_U, "float32", seed=305, label="[ragged N]")

    out["k8_sass"] = _k8_sass()
    k8 = out["k8"] = _k8_case(N_CPG, N_S, N_CT + N_U, "float32", timed=True,
                              library=True)
    out["k8_f64"] = _k8_case(N_CPG, N_S, N_CT + N_U, "float64", timed=True,
                             library=True)
    out["k8_bf16"] = _k8_case(N_CPG, N_S, N_CT + N_U, "float32",
                              data="bfloat16", timed=True)
    p_c = COHORT[2] + COHORT[3]
    out["k8_cohort"] = _k8_case(COHORT[0], COHORT[1], p_c, "float32",
                                timed=True, library=True, label="[cohort]")
    out["k8_cohort_f64"] = _k8_case(COHORT[0], COHORT[1], p_c, "float64",
                                    timed=True, library=True,
                                    label="[cohort]")
    out["k8_cohort_bf16"] = _k8_case(COHORT[0], COHORT[1], p_c, "float32",
                                     data="bfloat16", timed=True,
                                     label="[cohort]")
    # untimed twins: ragged N; one sample and one type; an n_s and a p
    # off the MMA tiles; the widest plan (p = 64, n_s = 500, float64)
    for dt_name, data in (("float32", None), ("float64", None),
                          ("float32", "bfloat16")):
        _k8_case(N_WIDE + 3, N_S, N_CT + N_U, dt_name, data=data, seed=322,
                 label="[ragged N]")
        _k8_case(N_TRAJ, 1, 1, dt_name, data=data, seed=323,
                 label="[n_s = 1, p = 1]")
        _k8_case(N_TRAJ, 13, 11, dt_name, data=data, seed=324,
                 label="[n_s = 13, p = 11]")
    _k8_case(70_000, 500, 64, "float64", seed=325, label="[widest]")
    out["k8_rounding"] = _k8_rounding_case()

    k9 = out["k9"] = _k9_case(N_CT + N_U, "float32", timed=True)
    out["k9_f64"] = _k9_case(N_CT + N_U, "float64", timed=True)
    _k9_case(N_CT + 3, "float64", n_ct=N_CT, mask=[1] * (N_CT + 2) + [0],
             seed=341)

    cuda_small.fw_phase.launches = 0
    k10 = out["k10"] = _k10_case(N_CT + N_U, "float32", timed=True)
    out["k10_f64"] = _k10_case(N_CT + N_U, "float64", timed=True)
    out["k10_launches"] = cuda_small.fw_phase.launches

    # the composed iteration held to the plain solver, float64
    t = state.from_numpy(*make_problem(np.float64, seed=1, n_cpg=N_TRAJ),
                         device=DEV, dtype=torch.float64)
    n1 = 20
    u_c, a_c, tr_c = composed_solve(*t, N_U, n1, N_INNER)
    u_p, a_p, info = partial_ref_solve(*t, N_U, n_iter1=n1, n_iter2=N_INNER,
                                       tol=0.0, record_trace=True)
    tc, tp = tr_c.cpu().numpy(), info["trace"].cpu().numpy()
    err_c = float(np.max(np.abs(tc - tp) / np.abs(tp)))
    err_a = float((a_c - a_p).abs().max())
    err_u = float((u_c - u_p).abs().max())
    tol = TRAJ_TOL["float64"]
    log(f"[composed] K7 -> K8 -> K9, {n1}x{N_INNER}, N={N_TRAJ} float64, "
        f"against partial_ref_solve from the same inits: cost trace max rel "
        f"diff {err_c:.3e} (tol {tol['cost']:.0e}), alpha max|diff| "
        f"{err_a:.3e} (tol {tol['alpha']:.0e}), u max|diff| {err_u:.3e}; "
        f"cost {tc[0]:.6e} -> {tc[-1]:.6e}")
    check(len(tc) == info["n_iter"] == n1, "composed: n_iter differs")
    check(err_c <= tol["cost"] and err_a <= tol["alpha"]
          and err_u <= tol["alpha"], "composed iteration differs from the "
          "plain solver")
    del t, u_c, a_c, u_p, a_p

    # the composed iteration timed at full width, float32
    u0, a0, y, d, Rt = state.from_numpy(*make_problem(), device=DEV,
                                        dtype=torch.float32)
    composed_solve(u0, a0, y, d, Rt, N_U, 5, N_INNER)                # warm
    torch.cuda.synchronize()
    reset_counts()
    (u_c, a_c, tr_c), ms = timed_ms(lambda: composed_solve(
        u0, a0, y, d, Rt, N_U, N_OUTER, N_INNER))
    launches = read_counts()
    ms_iter = ms / N_OUTER
    trace = tr_c.cpu().numpy()
    log(f"[composed] K7 -> K8 -> K9 unfused, 1M x 10, 5+1, float32, "
        f"{N_OUTER}x{N_INNER}, tol=0, card {card}: {ms_iter:.4f} ms per "
        f"outer iteration (CUDA events) against the fused main path's "
        f"{main_ms:.4f} (K1 + K2) in this run, {ms_iter / main_ms:.3f}x; "
        f"launches {launches}")
    check(expect_counts(launches, u_phase=N_OUTER, grams=N_OUTER,
                        alpha_phase=N_OUTER),
          f"composed launch counts {launches} != {N_OUTER} iterations")
    check(np.isfinite(trace).all() and trace[-1] < trace[0],
          "composed: cost did not decrease")
    check(bool(torch.isfinite(a_c).all()) and float(u_c.min()) >= 0
          and float(u_c.max()) <= 1, "composed: output off its range")
    out["composed"] = {"ms_iter": ms_iter, "launches": launches}
    del u0, a0, y, d, Rt, u_c, a_c
    torch.cuda.empty_cache()
    return out


# K1 and K2 shapes of the parent/change bit comparisons: (n, n_s, n_ct,
# n_u, steps, state dtype, data dtype, bf16_compute, lagged, seed) for K1,
# (n_ct, n_u, n_s) for K2; the K1 shapes from "n_u9" on are the n_u > 8
# form's (STATE_SHAPES)
K1_OUTPUT_SHAPES = {
    "main": (N_CPG, N_S, N_CT, N_U, N_INNER, "float32", None, False, False,
             0),
    "main64": (N_CPG, N_S, N_CT, N_U, N_INNER, "float64", None, False,
               False, 0),
    "purity": (N_CPG, N_S, N_CT, N_U, P_INNER, "float32", None, False,
               False, 0),
    "cohort": (1_000_000, 100, 25, 4, N_INNER, "float32", None, False,
               False, 0),
    "bf16": (N_CPG, N_S, N_CT, N_U, N_INNER, "float32", "bfloat16", False,
             False, 0),
    "n_u9": (N_CPG, N_S, N_CT, 9, N_INNER, "float32", None, False, False,
             110),
    "n_u25": (N_CPG, N_S, N_CT, 25, N_INNER, "float32", None, False, False,
              111),
    "direct_lagged": (N_WIDE, N_S, 0, 12, N_INNER, "float32", None, False,
                      True, 112),
    "direct64": (N_WIDE, N_S, N_CT, 12, N_INNER, "float64", None, False,
                 False, 113),
    "direct_chunks": (N_WIDE, 80, 25, 16, N_INNER, "float64", None, False,
                      False, 114),
    "direct_bf16c": (N_WIDE, 20, 25, 16, N_INNER, "float32", "bfloat16",
                     True, False, 115),
    "gram12": (N_WIDE, 100, 5, 12, N_INNER, "float64", None, False, False,
               116),
    "gram17": (N_WIDE, 100, 5, 17, N_INNER, "float64", None, False, False,
               117),
    "gram_lagged": (N_WIDE, 100, 0, 12, N_INNER, "float32", None, False,
                    True, 118),
    "gram_bf16": (N_WIDE, 100, 5, 12, N_INNER, "float32", "bfloat16", False,
                  False, 119),
    "gram_bf16c": (N_WIDE, 100, 25, 12, N_INNER, "float32", "bfloat16",
                   True, False, 120),
    "gram18_device": (50_000, 108, 5, 18, N_INNER, "float64", None, False,
                      False, 121),
    # the global layout's shapes (GLOBAL_SHAPES)
    "global160": (N_WIDE, 64, 160, 4, N_INNER, "float64", None, False,
                  False, 400),
    "global_direct12": (N_WIDE, N_S, 200, 12, N_INNER, "float64", None,
                        False, False, 401),
    "global_direct6": (N_WIDE, N_S, 210, 6, N_INNER, "float64", None, False,
                       False, 406),
    "global400_f32": (N_WIDE, 64, 400, 4, N_INNER, "float32", None, False,
                      False, 402),
    "global400_bf16": (N_WIDE, 64, 400, 4, N_INNER, "float32", "bfloat16",
                       False, False, 403),
    "global400_bf16c": (N_WIDE, 64, 400, 4, N_INNER, "float32", "bfloat16",
                        True, False, 407),
    "global_direct_bf16c": (N_WIDE, N_S, 440, 6, N_INNER, "float32",
                            "bfloat16", True, False, 408),
}
GLUE_OUTPUT_SHAPES = {"main": (N_CT, N_U, N_S), "cohort": (25, 4, 100),
                      "wide": None}


def _glue_wide_outputs():
    """K2, K3, K5, K6, K9 and K10 at every two-row shape (p = 33, 40, 48,
    64; n_s = 10, 100; float32 and float64), one launch each from seeded
    inputs: K2, K5 and K9 also with row masks, K5 (B = 4) and K6 (B = 4)
    with an inactive member. Each kernel's cost, l_w and active flags
    apart from its alpha, alpha_prev and other scalars (``*_cost`` keys):
    they sum the columns' terms in the grid's fixed order, so they keep
    their bits only where the parent's block held min(n_s, 32) warps."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import (
        A_ALPHA, ACTIVE, COST, DMAX2, L_H_PREV, L_W, N_SCAL, RT_SQ)
    from demethify_tpu_torch.ops.cuda_small import (
        alpha_phase, alpha_phase_full, alpha_phase_full_multi, fw_phase,
        fw_phase_full, fw_phase_full_multi)

    cost_slots = [COST, L_W]
    rest = [k for k in range(N_SCAL) if k not in cost_slots]
    saved = {}

    def put(key, alpha, scal=None, alpha_prev=None, multi=False):
        saved[key + "_alpha"] = alpha
        if alpha_prev is not None:
            saved[key + "_alpha_prev"] = alpha_prev
        if scal is not None:
            cs = cost_slots + ([ACTIVE] if multi else [])
            saved[key + "_scal"] = scal[..., rest]
            saved[key + "_cost"] = scal[..., cs]

    for p in TWO_ROW_P:
        for n_s in TWO_ROW_NS:
            for dt in ("float32", "float64"):
                tag = f"p{p}_ns{n_s}_{dt}"
                seed = 500 + p + n_s
                blocks, G, b, alpha, alpha_prev, scal = _phase_glue_inputs(
                    p, p - 4, dt, seed, n_s)
                mask = torch.ones(p, device=DEV, dtype=alpha.dtype)
                mask[2] = mask[p - 1] = 0.0
                for mk, m in (("", None), ("_masked", mask)):
                    a, ap, sc = alpha.clone(), alpha_prev.clone(), scal.clone()
                    alpha_phase_full(*blocks, a, ap, sc, N_INNER, 4,
                                     **({} if m is None
                                        else {"row_mask": m}))
                    put(f"k2{mk}_{tag}", a, sc, ap)
                    l_h = (scal[RT_SQ] + blocks[4][0]) * scal[DMAX2]
                    out = alpha_phase(G, b, alpha, alpha_prev,
                                      scal[A_ALPHA], scal[L_H_PREV], l_h,
                                      N_INNER, **({} if m is None
                                                  else {"row_mask": m}))
                    put(f"k9{mk}_{tag}", out[0], alpha_prev=out[1])
                    saved[f"k9{mk}_{tag}_scal"] = torch.stack(out[2:])
                blocks, G, b, alpha, _, scal = _phase_glue_inputs(
                    p, p - 1, dt, seed + 1, n_s)
                purity = torch.linspace(0.3, 0.9, n_s, device=DEV,
                                        dtype=alpha.dtype)
                a1 = (alpha[:p - 1] / alpha[:p - 1].sum(0)
                      * purity).contiguous()
                a2 = (alpha[p - 1:] / alpha[p - 1:].sum(0)
                      * (1 - purity)).contiguous()
                a, sc = torch.cat([a1, a2]), scal.clone()
                gtt, bt, gu, bu, _, ydy = blocks
                fw_phase_full(gtt, bt, gu, bu, ydy, a, purity, sc, P_INNER, 1)
                put(f"k3_{tag}", a, sc)
                put(f"k10_{tag}", torch.cat(fw_phase(G, b, a1, a2, purity,
                                                     P_INNER)))
                (gtt, bt, gu, bu, usq, ydy, alpha_b, alpha_prev_b,
                 scal_b) = _glue_multi_inputs(p - 4, 4, dt, 4, (2,),
                                              seed + 2, n_s=n_s)
                mask_b = torch.ones((4, p), device=DEV, dtype=alpha_b.dtype)
                mask_b[0, 1] = mask_b[3, p - 2] = 0.0
                for mk, m in (("", ()), ("_masked", (mask_b,))):
                    a, ap, sc = (alpha_b.clone(), alpha_prev_b.clone(),
                                 scal_b.clone())
                    alpha_phase_full_multi(gtt, bt, gu, bu, usq, ydy, a, ap,
                                           sc, N_INNER, 4, *m)
                    put(f"k5{mk}_{tag}", a, sc, ap, multi=True)
                (gtt, bt, gu, bu, _, ydy, alpha_b, _,
                 scal_b) = _glue_multi_inputs(p - 1, 1, dt, 4, (1,),
                                              seed + 3, n_s=n_s)
                alpha_b = torch.cat([
                    alpha_b[:, :p - 1] / alpha_b[:, :p - 1].sum(
                        1, keepdim=True) * purity,
                    alpha_b[:, p - 1:] / alpha_b[:, p - 1:].sum(
                        1, keepdim=True) * (1 - purity)], dim=1).contiguous()
                sc = scal_b.clone()
                fw_phase_full_multi(gtt, bt, gu, bu, ydy, alpha_b, purity,
                                    sc, P_INNER, 1)
                put(f"k6_{tag}", alpha_b, sc, multi=True)
    return saved


def _glue_outputs(shape):
    """K2's and K3's outputs (alpha, alpha_prev, scalars) at ``shape`` of
    ``GLUE_OUTPUT_SHAPES``, one launch each, on the CPU: "main" the main
    path's (``_small_inputs``, p = 6, float32 and float64), "cohort" K2
    alone at p = 29, n_s = 100 (float32 and float64), "wide" all six glue
    kernels at the two-row form's shapes (``_glue_wide_outputs``)."""
    import torch

    if shape == "wide":
        return {k: v.cpu() for k, v in _glue_wide_outputs().items()}

    from demethify_tpu_torch.ops.cuda_kernels import (
        A_ALPHA, DMAX2, L_H_PREV, RT_SQ)
    from demethify_tpu_torch.ops.cuda_small import (
        alpha_phase_full, fw_phase_full)

    n_ct, n_u, n_s = GLUE_OUTPUT_SHAPES[shape]
    saved = {}
    for dt in ("float32", "float64"):
        gtt, bt, gu, bu, usq, ydy, alpha, ydt, rtt, scal = _small_inputs(
            n_ct, n_u, dt, 200_000, 3, n_s)
        dmax2 = ydt[n_s:].max() ** 2
        rt_sq = torch.sum(rtt * rtt)
        scal[A_ALPHA], scal[RT_SQ], scal[DMAX2] = 1.8, rt_sq, dmax2
        scal[L_H_PREV] = 1.05 * (rt_sq + usq[0]) * dmax2
        a, ap, sc = alpha.clone(), alpha.flip(0).contiguous(), scal.clone()
        alpha_phase_full(gtt, bt, gu, bu, usq, ydy, a, ap, sc, N_INNER, n_u)
        saved.update({f"k2_alpha_{dt}": a, f"k2_alpha_prev_{dt}": ap,
                      f"k2_scal_{dt}": sc})
        if shape == "main":
            purity = torch.linspace(0.3, 0.9, n_s, device=DEV,
                                    dtype=alpha.dtype)
            af, sf = alpha.clone(), scal.clone()
            fw_phase_full(gtt, bt, gu, bu, ydy, af, purity, sf, P_INNER, n_u)
            saved.update({f"k3_alpha_{dt}": af, f"k3_scal_{dt}": sf})
    return {k: v.cpu() for k, v in saved.items()}


def _k1_outputs(shape):
    """K1's outputs (u, u_prev, scalars, gu, b_u, usq) at ``shape`` of
    ``K1_OUTPUT_SHAPES``, one launch on ``_k1_inputs``' data, on the CPU."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import u_phase_grams

    (n, n_s, n_ct, n_u, steps, dt, data, bf16c, lagged,
     seed) = K1_OUTPUT_SHAPES[shape]
    ydt, rtt, alpha, uut, scal = _k1_inputs(n, n_s, n_ct, n_u,
                                            getattr(torch, dt), seed)
    a1, a2 = alpha[:n_ct], alpha[n_ct:]
    if data is not None:
        ydt, rtt = ydt.to(getattr(torch, data)), rtt.to(getattr(torch, data))
    if n_ct == 0:
        rtt = a1 = None
    kw = {"bf16_compute": True} if bf16c else {}
    gu, bu, usq = u_phase_grams(ydt, rtt, a1, a2, uut, scal, steps, lagged,
                                **kw)
    return {k: v.cpu() for k, v in dict(
        uut=uut, scal=scal, gu=gu, bu=bu, usq=usq).items()}


# K4's outputs at the shapes its redesigns keep the bits of:
# (n, n_s, n_ct, n_u, B, steps, state, data, lagged, weighted, inactive,
# seed); "wide" and "n_u12" take the wide layout; the shapes from
# "state12" on are the n_u > 8 form's (STATE_SHAPES)
K4_OUTPUT_SHAPES = {
    "main": (N_CPG, N_S, N_CT, N_U, 16, N_INNER, "float32", None, False,
             False, (3, 7, 11), 20),
    "main64": (N_CPG, N_S, N_CT, N_U, 16, N_INNER, "float64", None, False,
               False, (3, 7, 11), 20),
    "unsupervised": (N_CPG, N_S, 0, U_N_U, 8, N_INNER, "float32", None,
                     True, False, (5,), 21),
    "purity": (N_CPG, N_S, N_CT, N_U, 8, P_INNER, "float32", None, False,
               False, (2,), 22),
    "weighted": (N_CPG, N_S, N_CT, N_U, 32, N_INNER, "float32", None, False,
                 True, (), 50),
    "bf16": (N_CPG, N_S, N_CT, N_U, 16, N_INNER, "float32", "bfloat16",
             False, False, (3,), 23),
    "wide": (200_000, 100, 25, 4, 4, N_INNER, "float32", None, False, False,
             (1,), 24),
    "n_u12": (200_000, 100, 5, 12, 4, N_INNER, "float64", None, False,
              False, (2,), 94),
    "state12": (N_WIDE, 100, 5, 12, 4, N_INNER, "float64", None, False,
                False, (2,), 122),
    "state16": (N_WIDE, 100, 5, 16, 4, N_INNER, "float64", None, False,
                False, (2,), 123),
    "state12_f32": (N_WIDE, 100, 5, 12, 4, N_INNER, "float32", None, False,
                    False, (2,), 124),
    "state12_weighted": (N_WIDE, 100, 5, 12, 4, N_INNER, "float64", None,
                         False, True, (2,), 125),
    "state18_device": (50_000, 108, 5, 18, 4, N_INNER, "float64", None,
                       False, False, (2,), 126),
    # the global layout's shapes (GLOBAL_SHAPES)
    "global160": (N_WIDE, 64, 160, 4, 10, N_INNER, "float64", None, False,
                  False, (1,), 404),
    "global_weighted": (N_WIDE, N_S, 205, 4, 4, N_INNER, "float64", None,
                        False, True, (2,), 405),
    "global_state12": (N_WIDE, 64, 160, 12, 4, N_INNER, "float64", None,
                       False, False, (1,), 409),
    "global_bf16": (N_WIDE, 64, 400, 4, 4, N_INNER, "float32", "bfloat16",
                    False, False, (3,), 410),
}


def _k4_outputs(shape):
    """K4's outputs at ``shape`` of ``K4_OUTPUT_SHAPES``, on the CPU: every
    member's [u; u_prev] rows and scalar row (the inactive members' must
    come back unchanged) and the active members' gu, b_u and usq (an
    inactive member's are unspecified), one launch on ``_multi_inputs``'
    data."""
    import torch

    from demethify_tpu_torch.ops.cuda_multi import u_phase_grams_multi

    (n, n_s, n_ct, n_u, n_b, steps, dt, data, lagged, weighted, inactive,
     seed) = K4_OUTPUT_SHAPES[shape]
    dtype = getattr(torch, dt)
    ydt, rtt, alpha_b, uut_b, scal_b = _multi_inputs(
        n, n_s, n_ct, n_u, n_b, dtype, seed, inactive)
    if data is not None:
        ydt = ydt.to(getattr(torch, data))
        rtt = None if rtt is None else rtt.to(ydt.dtype)
    w = resample_weights(n_b, n, dtype, seed) if weighted else None
    a1 = alpha_b[:, :-n_u] if n_ct else None
    gu, bu, usq = u_phase_grams_multi(ydt, rtt, a1, alpha_b[:, -n_u:], uut_b,
                                      scal_b, steps, lagged, weights=w)
    act = [b for b in range(n_b) if b not in inactive]
    return {k: v.cpu() for k, v in dict(
        uut=uut_b, scal=scal_b, gu=gu[act], bu=bu[act],
        usq=usq[act]).items()}


# K7's outputs at its n_u > 8 form's shapes: (n, n_s, n_ct, n_u, state,
# data, lagged, seed), 20 steps
K7_OUTPUT_SHAPES = {
    "n_u12": (N_WIDE, 100, 5, 12, "float64", None, False, 400),
    "n_u17": (N_WIDE, 100, 5, 17, "float64", None, False, 401),
    "n_u25": (N_WIDE, N_S, N_CT, 25, "float32", None, False, 402),
    "n_u12_lagged": (N_WIDE, N_S, 0, 12, "float32", None, True, 403),
    "n_u12_bf16": (N_WIDE, 100, 5, 12, "float32", "bfloat16", False, 404),
}


def _k7_outputs(shape):
    """K7's outputs (u, u_prev, the advanced scalars) at ``shape`` of
    ``K7_OUTPUT_SHAPES``, one launch on ``_k1_inputs``' data, on the
    CPU."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import (
        A_U, L_W, L_W_PREV, u_phase)

    n, n_s, n_ct, n_u, dt, data, lagged, seed = K7_OUTPUT_SHAPES[shape]
    ydt, rtt, alpha, uut, scal = _k1_inputs(n, n_s, n_ct, n_u,
                                            getattr(torch, dt), seed)
    if data is not None:
        ydt, rtt = ydt.to(getattr(torch, data)), rtt.to(getattr(torch, data))
    a1, a2 = alpha[:n_ct], alpha[n_ct:]
    if n_ct == 0:
        rtt = a1 = None
    out = u_phase(ydt[:n_s], ydt[n_s:], rtt, a1, a2, uut[:n_u], uut[n_u:],
                  scal[A_U], scal[L_W], scal[L_W_PREV], N_INNER,
                  lagged=lagged)
    return {k: v.cpu() for k, v in zip(("u", "up", "a", "l_prev"), out)}


# the n_u > 8 forms' shapes, whose bits the state's move onto the chip
# keeps: K1's, K4's (with B = 4, member 2 inactive) and K7's
STATE_SHAPES = (
    ("K1", "n_u9"), ("K1", "n_u25"), ("K1", "direct_lagged"),
    ("K1", "direct64"), ("K1", "direct_chunks"), ("K1", "direct_bf16c"),
    ("K1", "gram12"), ("K1", "gram17"), ("K1", "gram_lagged"),
    ("K1", "gram_bf16"), ("K1", "gram_bf16c"), ("K1", "gram18_device"),
    ("K4", "state12"), ("K4", "state16"), ("K4", "state12_f32"),
    ("K4", "state12_weighted"), ("K4", "state18_device"), ("K7", "n_u12"),
    ("K7", "n_u17"), ("K7", "n_u25"), ("K7", "n_u12_lagged"),
    ("K7", "n_u12_bf16"))


# the shapes each kernel takes in the global layout of its own accord
# (K1_OUTPUT_SHAPES, K4_OUTPUT_SHAPES): the gram and the direct form, the
# three storages and bf16_compute, K4 weighted, at n_u > 8 (the state
# region on the chip and in device memory) and with an inactive member
GLOBAL_SHAPES = (
    ("K1", "global160"), ("K1", "global_direct12"), ("K1", "global_direct6"),
    ("K1", "global400_f32"), ("K1", "global400_bf16"),
    ("K1", "global400_bf16c"), ("K1", "global_direct_bf16c"),
    ("K1", "gram18_device"), ("K4", "global160"), ("K4", "global_weighted"),
    ("K4", "global_state12"), ("K4", "global_bf16"),
    ("K4", "state18_device"))


# the shared layouts' shapes of the main paths (K1_OUTPUT_SHAPES,
# K4_OUTPUT_SHAPES)
MAIN_SHAPES = (
    ("K1", "main"), ("K1", "main64"), ("K1", "purity"), ("K1", "cohort"),
    ("K1", "bf16"), ("K4", "main"), ("K4", "main64"), ("K4", "weighted"),
    ("K4", "bf16"), ("K4", "wide"), ("K4", "unsupervised"))


def _k3_outputs(shape):
    """K3's outputs (alpha, scalars; 500 steps, float32 and float64) at
    ``shape`` "main" (p = 6, n_s = 10) or "cohort" (p = 29, n_s = 100,
    several blocks) of ``GLUE_OUTPUT_SHAPES``, or at "k6" K6's at B = 8
    (p = 6, one member inactive, float32), on the CPU."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import DMAX2
    from demethify_tpu_torch.ops.cuda_small import (
        fw_phase_full, fw_phase_full_multi)

    if shape == "k6":
        (gtt, bt, gu, bu, _, ydy, alpha_b, _,
         scal_b) = _glue_multi_inputs(N_CT, N_U, "float32", 8, (5,), 40)
        purity = torch.linspace(0.3, 0.9, N_S, device=DEV,
                                dtype=alpha_b.dtype)
        fw_phase_full_multi(gtt, bt, gu, bu, ydy, alpha_b, purity, scal_b,
                            P_INNER, N_U)
        return {"alpha": alpha_b.cpu(), "scal": scal_b.cpu()}
    n_ct, n_u, n_s = GLUE_OUTPUT_SHAPES[shape]
    saved = {}
    for dt in ("float32", "float64"):
        gtt, bt, gu, bu, _, ydy, alpha, ydt, _, scal = _small_inputs(
            n_ct, n_u, dt, 200_000, 3, n_s)
        scal[DMAX2] = ydt[n_s:].max() ** 2
        purity = torch.linspace(0.3, 0.9, n_s, device=DEV, dtype=alpha.dtype)
        fw_phase_full(gtt, bt, gu, bu, ydy, alpha, purity, scal, P_INNER,
                      n_u)
        saved.update({f"alpha_{dt}": alpha.cpu(), f"scal_{dt}": scal.cpu()})
    return saved


# K3's and K6's shapes above 64 rows ("p{p}_{dtype}": p, dtype, steps):
# one block a column (65-168 in float64), clusters of two (200 in
# float64, 240 in float32), past eight blocks (where the one-block loop
# kept its slabs in device memory: 473-670 in float64, 673-946 in
# float32) clusters of 9-16, and past 16 the device rows (671, 700, 947)
COLUMN_SHAPES = {f"p{p}_{dt}": (p, dt, steps) for p, dt, steps in (
    (65, "float64", P_INNER), (65, "float32", P_INNER),
    (100, "float64", P_INNER), (100, "float32", P_INNER),
    (167, "float64", P_INNER), (168, "float64", P_INNER),
    (200, "float64", P_INNER), (240, "float32", P_INNER),
    (473, "float64", 20), (490, "float64", 20), (670, "float64", 20),
    (671, "float64", 20), (700, "float64", 20), (673, "float32", 20),
    (947, "float32", 20))}


def _column_outputs(shape):
    """K3's and K6's outputs at ``shape`` of ``COLUMN_SHAPES``, one launch
    each from seeded inputs, on the CPU: K3 at n_s = 10 and 100, K6 at
    B = 4 with member 1 inactive, and K6 at B = 3 with per-member
    weighted known blocks (member 1 inactive). Alpha, then the cost, l_w
    and the active flag (``*_cost``) apart from the other scalars."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import ACTIVE, COST, L_W
    from demethify_tpu_torch.ops.cuda_small import (
        fw_phase_full, fw_phase_full_multi)

    p, dt, steps = COLUMN_SHAPES[shape]
    saved = {}

    def at_purity(alpha, purity):
        return torch.cat([
            alpha[..., :p - 1, :] / alpha[..., :p - 1, :].sum(
                -2, keepdim=True) * purity,
            alpha[..., p - 1:, :] / alpha[..., p - 1:, :].sum(
                -2, keepdim=True) * (1 - purity)], dim=-2).contiguous()

    def put(key, alpha, scal):
        cs = [COST, L_W] + ([ACTIVE] if scal.dim() == 2 else [])
        rest = [k for k in range(scal.shape[-1]) if k not in cs]
        saved.update({f"{key}_alpha": alpha.cpu(),
                      f"{key}_cost": scal[..., cs].cpu(),
                      f"{key}_scal": scal[..., rest].cpu()})

    for n_s in (N_S, 100):
        blocks, _, _, alpha, _, scal = _phase_glue_inputs(
            p, p - 1, dt, 700 + p + n_s, n_s)
        gtt, bt, gu, bu, _, ydy = blocks
        purity = torch.linspace(0.3, 0.9, n_s, device=DEV, dtype=alpha.dtype)
        a = at_purity(alpha, purity)
        fw_phase_full(gtt, bt, gu, bu, ydy, a, purity, scal, steps, 1)
        put(f"k3_ns{n_s}", a, scal)
    for tag, n_b, weighted in (("k6", 4, False), ("k6w", 3, True)):
        (gtt, bt, gu, bu, _, ydy, alpha_b, _,
         scal_b) = _glue_multi_inputs(p - 1, 1, dt, n_b, (1,),
                                      720 + p + n_b, weighted=weighted)
        purity = torch.linspace(0.3, 0.9, N_S, device=DEV,
                                dtype=alpha_b.dtype)
        a = at_purity(alpha_b, purity)
        fw_phase_full_multi(gtt, bt, gu, bu, ydy, a, purity, scal_b, steps,
                            1)
        put(tag, a, scal_b)
    return saved


# K2's and K5's shapes above 64 rows ("p{p}_{dtype}": p, dtype): one
# block a column (65-166 in float64, to 237 in float32), clusters of two
# (167-233 in float64, 238-332 in float32), eight (452 in float64), past
# eight (where the one-block loop kept its slabs in device memory: 453-624
# in float64, 651-904 in float32) clusters of 9-16, and past 16 the device
# rows (625, 700, 905)
ALPHA_COLUMN_SHAPES = {f"p{p}_{dt}": (p, dt) for p, dt in (
    (65, "float64"), (65, "float32"), (100, "float64"), (100, "float32"),
    (166, "float64"), (167, "float64"), (200, "float64"), (237, "float32"),
    (238, "float32"), (240, "float32"), (452, "float64"), (453, "float64"),
    (460, "float64"), (624, "float64"), (625, "float64"), (700, "float64"),
    (651, "float32"), (905, "float32"))}


def _alpha_column_outputs(shape):
    """K2's and K5's outputs at ``shape`` of ``ALPHA_COLUMN_SHAPES``, one
    launch each (20 steps) from seeded inputs, on the CPU: K2 at n_s = 10
    and 100 and at n_s = 10 with two rows masked, K5 at B = 4 with member
    1 inactive and a row mask on member 2, and K5 at B = 3 with
    per-member weighted known blocks (member 1 inactive). Alpha and
    alpha_prev, then the cost, l_w and the active flag (``*_cost``) apart
    from the other scalars."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import ACTIVE, COST, L_W
    from demethify_tpu_torch.ops.cuda_small import (
        alpha_phase_full, alpha_phase_full_multi)

    p, dt = ALPHA_COLUMN_SHAPES[shape]
    n_u = 4
    saved = {}

    def put(key, alpha, alpha_prev, scal):
        cs = [COST, L_W] + ([ACTIVE] if scal.dim() == 2 else [])
        rest = [k for k in range(scal.shape[-1]) if k not in cs]
        saved.update({f"{key}_alpha": alpha.cpu(),
                      f"{key}_alpha_prev": alpha_prev.cpu(),
                      f"{key}_cost": scal[..., cs].cpu(),
                      f"{key}_scal": scal[..., rest].cpu()})

    for n_s, masked in ((N_S, False), (100, False), (N_S, True)):
        blocks, _, _, alpha, alpha_prev, scal = _phase_glue_inputs(
            p, p - n_u, dt, 740 + p + n_s + masked, n_s)
        mask = {}
        if masked:
            keep = torch.ones(p, device=DEV, dtype=alpha.dtype)
            keep[3] = keep[p - 2] = 0.0
            mask = {"row_mask": keep}
        alpha_phase_full(*blocks, alpha, alpha_prev, scal, N_INNER, n_u,
                         **mask)
        put(f"k2_ns{n_s}" + ("_masked" if masked else ""), alpha,
            alpha_prev, scal)
    for tag, n_b, weighted in (("k5", 4, False), ("k5w", 3, True)):
        (gtt, bt, gu, bu, usq, ydy, alpha_b, alpha_prev_b,
         scal_b) = _glue_multi_inputs(p - n_u, n_u, dt, n_b, (1,),
                                      760 + p + n_b, weighted=weighted)
        mask = ()
        if not weighted:
            keep = torch.ones((n_b, p), device=DEV, dtype=alpha_b.dtype)
            keep[2, 5] = 0.0
            mask = (keep,)
        alpha_phase_full_multi(gtt, bt, gu, bu, usq, ydy, alpha_b,
                               alpha_prev_b, scal_b, N_INNER, n_u, *mask)
        put(tag, alpha_b, alpha_prev_b, scal_b)
    return saved


# K9's and K10's shapes above 64 rows: those that the one-block wide loop
# before the column blocks ran (p <= 167 in float64, 237 in float32), and
# past eight blocks, where they took the device slabs (460 in clusters of
# 9; 625, 671 and 905 in the device rows): (p, n_s, dtype) by name
PHASE_SHAPES = {f"p{p}_ns{n_s}_{dt}": (p, n_s, dt) for p, n_s, dt in (
    (65, 10, "float64"), (100, 10, "float64"), (160, 10, "float64"),
    (166, 10, "float64"), (167, 10, "float64"), (100, 100, "float64"),
    (65, 10, "float32"), (100, 10, "float32"), (200, 10, "float32"),
    (237, 10, "float32"), (100, 100, "float32"), (460, 10, "float64"),
    (625, 10, "float64"), (671, 10, "float64"), (905, 10, "float32"))}


def _phase_outputs(shape):
    """K9's outputs (alpha, alpha_prev and the advanced scalars; with and
    without a row mask, 20 steps) and K10's (500 steps) at ``shape`` of
    ``PHASE_SHAPES``, one launch each from seeded inputs, on the CPU."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import (
        A_ALPHA, DMAX2, L_H_PREV, RT_SQ)
    from demethify_tpu_torch.ops.cuda_small import alpha_phase, fw_phase

    p, n_s, dt = PHASE_SHAPES[shape]
    saved = {}
    blocks, G, b, alpha, alpha_prev, scal = _phase_glue_inputs(
        p, p - 4, dt, 900 + p + n_s, n_s)
    l_h = (scal[RT_SQ] + blocks[4][0]) * scal[DMAX2]
    mask = torch.ones(p, device=DEV, dtype=alpha.dtype)
    mask[2] = mask[p - 1] = 0.0
    for mk, m in (("", None), ("_masked", mask)):
        out = alpha_phase(G, b, alpha, alpha_prev, scal[A_ALPHA],
                          scal[L_H_PREV], l_h, N_INNER, row_mask=m)
        saved.update({f"k9{mk}_alpha": out[0], f"k9{mk}_alpha_prev": out[1],
                      f"k9{mk}_scal": torch.stack(out[2:])})
    purity = torch.linspace(0.3, 0.9, n_s, device=DEV, dtype=alpha.dtype)
    a1 = (alpha[:p - 4] / alpha[:p - 4].sum(0) * purity).contiguous()
    a2 = (alpha[p - 4:] / alpha[p - 4:].sum(0) * (1 - purity)).contiguous()
    saved["k10_alpha"] = torch.cat(fw_phase(G, b, a1, a2, purity, P_INNER))
    return {k: v.cpu() for k, v in saved.items()}


# what save_outputs runs for each kind, and its named tables of
# (kind, shape) pairs
OUTPUT_KINDS = {"K1": _k1_outputs, "K4": _k4_outputs, "K7": _k7_outputs,
                "glue": _glue_outputs, "K3": _k3_outputs,
                "columns": _column_outputs,
                "alpha_columns": _alpha_column_outputs,
                "phase": _phase_outputs}
OUTPUT_TABLES = {"global": GLOBAL_SHAPES, "main": MAIN_SHAPES,
                 "state": STATE_SHAPES,
                 "glue": (("glue", "main"), ("glue", "cohort"),
                          ("K3", "main"), ("K3", "cohort"), ("K3", "k6")),
                 "glue_wide": (("glue", "wide"),),
                 "columns": (tuple(("columns", s) for s in COLUMN_SHAPES)
                             + tuple(("alpha_columns", s)
                                     for s in ALPHA_COLUMN_SHAPES)),
                 "phase": tuple(("phase", s) for s in PHASE_SHAPES)}


def save_outputs(root, path, shapes):
    """Saves the outputs of the kernels in the tree at ``root`` to
    ``path``, in one file, for a bit-for-bit comparison of two trees on one
    card with ``same_outputs``: ``shapes`` is a name of ``OUTPUT_TABLES``
    or a sequence of (kind, shape) pairs, kind a key of ``OUTPUT_KINDS``
    (K1, K4 and K7 at a shape of ``K1_OUTPUT_SHAPES`` /
    ``K4_OUTPUT_SHAPES`` / ``K7_OUTPUT_SHAPES``; "glue" and "K3" at a
    shape of ``GLUE_OUTPUT_SHAPES``; "phase", K9 and K10, at one of
    ``PHASE_SHAPES``). Run it once a tree, one process each:

        python3 -c 'import chip_smoke; chip_smoke.save_outputs("DIR", "OUT.pt", "global")'
    """
    sys.path.insert(0, os.path.abspath(root))
    import torch

    if isinstance(shapes, str):
        shapes = OUTPUT_TABLES[shapes]
    saved = {}
    for kind, shape in shapes:
        out = OUTPUT_KINDS[kind](shape)
        saved.update({f"{kind}_{shape}_{k}": v for k, v in out.items()})
        torch.cuda.empty_cache()
    torch.save(saved, path)


def same_outputs(path_a, path_b):
    """Prints whether two ``save_outputs`` files hold the same bits, and
    for each key that does not, the largest difference relative to the
    largest magnitude."""
    import torch

    a, b = torch.load(path_a), torch.load(path_b)
    same = {k: torch.equal(a[k], b[k]) for k in a}
    rel = {k: float((a[k] - b[k]).abs().max()
                    / a[k].abs().max().clamp_min(1e-300))
           for k in a if not same[k]}
    print(json.dumps({"a": path_a, "b": path_b, "bit_identical": same,
                      "n_same": sum(same.values()), "n": len(same),
                      "max_rel_diff": rel}), flush=True)


def _glue_time(kern, p, n_s, dt, steps=None, inner=20, n=200_000):
    """One glue kernel (``kern`` k2, k3, k5 or k6 with B = 8 members, all
    active, k9 or k10) at p, n_s and ``dt`` on seeded inputs (n sites):
    device ms a launch queued behind a device sleep (the median of 7 runs
    of ``inner`` launches), with us a step and a step and column, and the
    bound; ``steps`` the steps a launch (default 500 for the Frank-Wolfe
    kernels, 20 for the others)."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import (
        A_ALPHA, ACTIVE, DMAX2, L_H_PREV, RT_SQ)
    from demethify_tpu_torch.ops.cuda_small import (
        alpha_phase, alpha_phase_full, alpha_phase_full_multi, fw_phase,
        fw_phase_full, fw_phase_full_multi)

    fw = kern in ("k3", "k6", "k10")
    n_ct = p - 1 if fw else p - 4
    steps = steps or (P_INNER if fw else N_INNER)
    n_b = 8 if kern in ("k5", "k6") else 1
    if n_b > 1:
        (gtt, bt, gu, bu, usq, ydy, alpha_b, alpha_prev_b,
         scal_b) = _glue_multi_inputs(n_ct, p - n_ct, dt, n_b, (), 600 + p,
                                      n_s=n_s)
        scal_b[:, ACTIVE] = 1.0
        pur = torch.linspace(0.3, 0.9, n_s, device=DEV, dtype=alpha_b.dtype)
        fn = {"k5": lambda: alpha_phase_full_multi(
                  gtt, bt, gu, bu, usq, ydy, alpha_b, alpha_prev_b, scal_b,
                  steps, p - n_ct),
              "k6": lambda: fw_phase_full_multi(
                  gtt, bt, gu, bu, ydy, alpha_b, pur, scal_b, steps,
                  p - n_ct)}[kern]
    else:
        blocks, G, b, alpha, alpha_prev, scal = _phase_glue_inputs(
            p, n_ct, dt, 600 + p, n_s, n)
        pur = torch.linspace(0.3, 0.9, n_s, device=DEV, dtype=alpha.dtype)
        gtt, bt, gu, bu, usq, ydy = blocks
        l_h = (scal[RT_SQ] + usq[0]) * scal[DMAX2]
        fn = {"k2": lambda: alpha_phase_full(
                  *blocks, alpha, alpha_prev, scal, steps, p - n_ct),
              "k3": lambda: fw_phase_full(gtt, bt, gu, bu, ydy, alpha, pur,
                                          scal, steps, p - n_ct),
              "k9": lambda: alpha_phase(G, b, alpha, alpha_prev,
                                        scal[A_ALPHA], scal[L_H_PREV], l_h,
                                        steps),
              "k10": lambda: fw_phase(G, b, alpha[:n_ct].contiguous(),
                                      alpha[n_ct:].contiguous(), pur,
                                      steps)}[kern]
    ms = queued_ms(fn, inner=inner)
    itemsize = 8 if dt == "float64" else 4
    work = (phase_glue_work(p, n_s, steps, itemsize, fw=fw)
            if kern in ("k9", "k10") else
            glue_work(p, n_s, n_ct, steps, itemsize, n_members=n_b, fw=fw))
    bound_ms, bound_by = bound(*work, dt)
    log(f"[time] {kern} p={p} n_s={n_s} B={n_b} {dt} {steps} steps: "
        f"{ms:.4f} ms ({ms * 1e3 / steps:.3f} us a step), bound "
        f"{bound_ms:.2e} ms ({bound_by})")
    return {"kernel": kern, "p": p, "n_s": n_s, "dtype": dt, "steps": steps,
            "members": n_b, "ms": ms, "us_per_step": ms * 1e3 / steps,
            "us_per_step_column": ms * 1e3 / (steps * n_s * n_b),
            "bound_ms": bound_ms, "bound_by": bound_by}


def _p40_path_times():
    """The p = 40 path (``p40_runs``: partial-reference 100 x 20 and
    purity 10 x 500 at 1M x 10, float32) in ms per outer iteration (median
    of 3 solves, CUDA events) with K1's and the glue kernel's device us a
    launch from ``utils.device_profile``."""
    import torch

    paths = {}
    y, d, Rt = p40_problem()
    pur = torch.linspace(0.3, 0.9, P40[1], device=DEV, dtype=y.dtype)
    for tag, n1, _, glue, call in p40_runs(y, d, Rt, pur):
        call(2)
        ms = statistics.median(timed_ms(lambda: call(n1))[1] / n1
                               for _ in range(3))
        prefix = "alpha_phase" if glue == "alpha_phase_full" else "fw_phase"
        us = _profiled_us(lambda: call(10), (K1_KERNEL, prefix))
        paths[tag] = {"ms_per_outer": ms, "k1_us": us[K1_KERNEL],
                      "glue_us": us[prefix]}
        log(f"[time] {tag} path: {ms:.4f} ms per outer iteration; K1 "
            f"{us[K1_KERNEL]:.2f} us, {glue} {us[prefix]:.2f} us a launch")
    return paths


def _aic_sweep_time():
    """The AIC sweep to 25 ranks with SVD inits at 1M x 10
    (``phase_sweep``'s run, SWEEP_OUTER x 20): its seconds, the rank it
    chose and the solve ms per rank."""
    import torch

    from demethify_tpu_torch.selection.sweep import evaluate_best_ic

    y, d, Rt = (torch.as_tensor(x, device=DEV)
                for x in make_problem(np.float32)[2:])
    times = {}
    with _rank_times(times):
        res, ms = timed_ms(lambda: evaluate_best_ic(
            y, d, Rt, "SVD", "AIC", iter1=SWEEP_OUTER, iter2=N_INNER,
            tol=0.0, n_restarts=5, n_u_max=25, seed=3))
    return {"s": ms / 1e3, "chose": res[2],
            "ms_per_rank": {str(k): v for k, v in sorted(times.items())}}


def _past_path_times():
    """The paths past one block's shared memory, as
    ``phase_past_envelope`` runs them (20k x 10, float64, tol 0):
    partial-reference at 200 + 10 (p = 210) and 4 partial-reference
    restarts at 205 + 4 (p = 209), 10 x 10; purity at 179 + 1 (p = 180),
    4 purity restarts and the purity weights bootstrap (B = 4) at 205 + 4,
    5 x 100; ms per outer iteration, the median of 3 runs after one (CUDA
    events)."""
    import torch

    from demethify_tpu_torch.solvers.api import (
        partial_reference_deconv, purity_deconv)
    from demethify_tpu_torch.uncertainty.bootstrap import bootstrap_ci

    n, n1, n2 = ENVELOPE_SITES, 5, 100
    pur = torch.linspace(0.3, 0.9, N_S, device=DEV, dtype=torch.float64)
    calls = {}
    for tag, n_ct, n_u, r, seed in (("partial_ref_p210", 200, 10, 1, 190),
                                    ("partial_ref_restarts_p209", 205, 4, 4,
                                     192)):
        y, d, Rt = _wide_problem(n, N_S, n_ct, n_u, torch.float64, seed)
        calls[tag] = (lambda y=y, d=d, Rt=Rt, n_u=n_u, r=r:
                      partial_reference_deconv(
                          y, d, Rt, n_u, n_iter1=n1, n_iter2=10, tol=0.0,
                          seed=20, n_restarts=r))
    for tag, n_ct, n_u, r, seed in (("purity_p180", 179, 1, 1, 191),
                                    ("purity_restarts_p209", 205, 4, 4,
                                     193)):
        y, d, Rt = _wide_problem(n, N_S, n_ct, n_u, torch.float64, seed)
        calls[tag] = (lambda y=y, d=d, Rt=Rt, n_u=n_u, r=r: purity_deconv(
            y, d, Rt, n_u, pur, n_iter1=n1, n_iter2=n2, tol=0.0, seed=21,
            n_restarts=r))
    y, d, Rt = _wide_problem(n, N_S, 205, 4, torch.float64, seed=195)
    indices = np.random.default_rng(195).integers(0, n, size=(4, n))
    u_b, a_b = _member_inits(n, 4, 205, 4, seed=195,
                             purity=pur.cpu().numpy())
    calls["purity_bootstrap_p209"] = lambda: bootstrap_ci(
        y, d, Rt, 4, purity=pur, level=90, n_bootstrap=4, n_iter1=n1,
        n_iter2=n2, tol=0.0, method="weights", indices=indices,
        inits=list(zip(u_b, a_b)))
    out = {}
    for tag, call in calls.items():
        call()
        out[tag] = statistics.median(timed_ms(call)[1] / n1
                                     for _ in range(3))
        log(f"[time] {tag}: {out[tag]:.4f} ms per outer iteration")
    return out


# time_cases' tables: (name, function, keywords), each function returning
# a dict of numbers; the _k*_case timings are medians of back-to-back
# launches (CUDA events) beside their bound and twin
TIME_TABLES = {
    # K1's and K4's global layout, 200k sites: K1 160 + 4 at n_s = 64 and
    # the direct form 200 + 12 at n_s = 10 in float64, 400 + 4 at n_s = 64
    # in float32; K4 at B = 10, 160 + 4, and weighted at B = 4, 205 + 4
    "global": (
        ("k1_160", _k1_case, dict(
            n=N_WIDE, n_u=4, dtype_name="float64", n_s=64, n_ct=160,
            seed=400, timed=True, inner=1, reps=5, label="[global]")),
        ("k1_direct12", _k1_case, dict(
            n=N_WIDE, n_u=12, dtype_name="float64", n_s=N_S, n_ct=200,
            seed=401, timed=True, inner=1, reps=5, label="[global]")),
        ("k1_400_f32", _k1_case, dict(
            n=N_WIDE, n_u=4, dtype_name="float32", n_s=64, n_ct=400,
            seed=402, timed=True, inner=1, reps=5, label="[global]")),
        ("k4_160_b10", _k4_case, dict(
            n_u=4, dtype_name="float64", n_b=10, steps=N_INNER, n_ct=160,
            inactive=(1,), seed=404, timed=True, label="[global]",
            n=N_WIDE, n_s=64, quick=True)),
        ("k4w_205_b4", _k4w_case, dict(
            n_u=4, dtype_name="float64", n_b=4, steps=N_INNER, n_ct=205,
            inactive=(2,), seed=405, timed=True, label="[global]",
            n=N_WIDE))),
    # the n_u > 8 forms: K1 at the AIC sweep's ranks 9 and 25 (1M x 10,
    # 5 + n_u, float32, the direct form), K1 in the gram form at n_u = 12
    # and 17 and K4 at n_u = 12 and 16 (B = 4; 200k x 100, 5 + n_u,
    # float64); then the AIC sweep itself
    "state": tuple(
        (f"k1_rank{n_u}", _k1_case, dict(
            n=N_CPG, n_u=n_u, dtype_name="float32", seed=130 + n_u,
            timed=True, reps=5, inner=3, label=f"[rank {n_u}]"))
        for n_u in (9, 25)) + tuple(
        (f"k1_gram{n_u}", _k1_case, dict(
            n=N_WIDE, n_u=n_u, dtype_name="float64", n_s=100, n_ct=5,
            seed=140 + n_u, timed=True, reps=5, inner=1, label="[gram]"))
        for n_u in (12, 17)) + tuple(
        (f"k4_n_u{n_u}", _k4_case, dict(
            n_u=n_u, dtype_name="float64", n_b=4, steps=N_INNER, n_ct=5,
            seed=150 + n_u, timed=True, quick=True, n=N_WIDE, n_s=100,
            label=""))
        for n_u in (12, 16)) + (("aic_sweep", _aic_sweep_time, {}),),
    # the glue kernels at the two-row form's shapes: all six at p = 40,
    # K2 and K3 at p = 33 and 64, each at n_s = 10 and 100 in both dtypes;
    # then the p = 40 path
    "glue": tuple(
        (f"{kern}_p{p}_ns{n_s}_{dt}", _glue_time,
         dict(kern=kern, p=p, n_s=n_s, dt=dt))
        for p, kern in ([(40, k) for k in ("k2", "k3", "k5", "k6", "k9",
                                           "k10")]
                        + [(p, k) for p in (33, 64) for k in ("k2", "k3")])
        for n_s in TWO_ROW_NS for dt in ("float32", "float64"))
    + (("p40_paths", _p40_path_times, {}),),
    # K2, K3, K5 and K6 (B = 8) above 64 rows at n_s = 10: one block a
    # column (p = 100), clusters of two (p = 200, float64; 240, float32);
    # then the paths that run them
    "columns": tuple(
        (f"{kern}_p{p}_ns10_{dt}", _glue_time,
         dict(kern=kern, p=p, n_s=N_S, dt=dt))
        for p, dt in ((100, "float64"), (200, "float64"), (240, "float32"))
        for kern in ("k2", "k3", "k5", "k6"))
    + (("past_paths", _past_path_times, {}),),
    # K9 and K10 (float64, n_s = 10) at p = 100 and 160, which the one-block
    # wide loop before the column blocks also ran, beside the kernels that
    # share their column-block bodies: K2, K3, K5 and K6 at p = 100 and
    # 200, K2 at p = 460 and K3 at 490 (20 steps; clusters of 9 blocks,
    # the device slabs before them), and the main path's K1 and K2
    # (float32)
    "phase": (
        ("k1_main", _k1_case, dict(n=N_CPG, n_u=N_U, dtype_name="float32",
                                   timed=True)),
        ("k2_main", _k2_case, dict(n_ct=N_CT, dtype_name="float32",
                                   timed=True)))
    + tuple((f"{kern}_p{p}", _glue_time,
             dict(kern=kern, p=p, n_s=N_S, dt="float64",
                  inner=5 if (kern, p) == ("k10", 160) else 20))
            for p in (100, 160) for kern in ("k9", "k10"))
    + tuple((f"{kern}_p{p}", _glue_time,
             dict(kern=kern, p=p, n_s=N_S, dt="float64"))
            for p in (100, 200) for kern in ("k2", "k3", "k5", "k6"))
    + (("k2_p460", _glue_time, dict(kern="k2", p=460, n_s=N_S, dt="float64",
                                    inner=2, n=50_000)),
       ("k3_p490", _glue_time, dict(kern="k3", p=490, n_s=N_S, dt="float64",
                                    steps=20, inner=2, n=50_000))),
    # the column blocks past 8 blocks and the device rows past 16 (float64,
    # n_s = 10; 20 steps), beside the parent's device slabs: K2, K9 and K5
    # (B = 8) at p = 460 (9 blocks), K3, K10 and K6 at 490 (9), K2 and K9
    # at 624 (16) and 625 (the device rows), K3 and K10 at 670 and 671, K2
    # and K3 at p = 2000 (the device rows), and in float32 K2 and K9 at
    # 905, K3 and K10 at 947 (the device rows); then the main path's K1
    # and K2 and the column blocks at p = 100 and 200, which share the
    # loops' bodies
    "rows": tuple(
        (f"{kern}_p{p}", _glue_time,
         dict(kern=kern, p=p, n_s=N_S, dt="float64", steps=20,
              inner=2 if p >= 2000 else 5, n=50_000))
        for kern, p in (("k2", 460), ("k9", 460), ("k5", 460), ("k3", 490),
                        ("k10", 490), ("k6", 490), ("k2", 624), ("k9", 624),
                        ("k2", 625), ("k9", 625), ("k3", 670), ("k10", 670),
                        ("k3", 671), ("k10", 671), ("k2", 2000),
                        ("k3", 2000)))
    + tuple((f"{kern}_p{p}_f32", _glue_time,
             dict(kern=kern, p=p, n_s=N_S, dt="float32", steps=20, inner=5,
                  n=50_000))
            for kern, p in (("k2", 905), ("k9", 905), ("k3", 947),
                            ("k10", 947)))
    + (("k1_main", _k1_case, dict(n=N_CPG, n_u=N_U, dtype_name="float32",
                                  timed=True)),
       ("k2_main", _k2_case, dict(n_ct=N_CT, dtype_name="float32",
                                  timed=True)))
    + tuple((f"{kern}_p{p}", _glue_time,
             dict(kern=kern, p=p, n_s=N_S, dt="float64"))
            for p in (100, 200) for kern in ("k2", "k3", "k5", "k6")),
    # K9 and K10 where only the column blocks' tree runs them: p = 200
    # (clusters of two), K9 at p = 460 and K10 at 490 (20 steps; clusters
    # of 9, the device slabs before them); float64, n_s = 10
    "phase_new": (
        ("k9_p200", _glue_time, dict(kern="k9", p=200, n_s=N_S,
                                     dt="float64")),
        ("k10_p200", _glue_time, dict(kern="k10", p=200, n_s=N_S,
                                      dt="float64")),
        ("k9_p460", _glue_time, dict(kern="k9", p=460, n_s=N_S, dt="float64",
                                     inner=2, n=50_000)),
        ("k10_p490", _glue_time, dict(kern="k10", p=490, n_s=N_S,
                                      dt="float64", steps=20, inner=2,
                                      n=50_000))),
}


def time_cases(root, table):
    """Times the cases of ``TIME_TABLES[table]`` ("global", "state",
    "glue", "columns", "phase", "rows", "phase_new") with the tree at
    ``root``
    and prints one JSON line: the card's
    ``nvidia-smi`` name and power limit and each case's result by name.
    For a parent/change comparison on one card run parent, change, change,
    parent, one process each:

        python3 -c 'import chip_smoke; chip_smoke.time_cases("DIR", "global")'
    """
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    check(torch.cuda.is_available(), "time_cases needs a GPU")
    out = {"card": phase_device(), "root": root, "table": table}
    for name, fn, kw in TIME_TABLES[table]:
        out[name] = fn(**kw)
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def time_main_path(root):
    """Times the single-restart main path of the tree at ``root`` on one
    GPU and prints one JSON line: the card's ``nvidia-smi`` name and power
    limit, K1 and K2 at the main path's shape (the timed cases of phases
    3 and 4), K1 at the purity schedule's 500 steps and at the cohort
    shape (1M x 100, 25 + 4, float32), K2 there (p = 29, n_s = 100), K4
    and K5 at the partial-reference restart path's shape
    (B = 16, shared known blocks: the timed cases of phase 5; K5 also
    queued behind a device sleep, its device time alone), K4 with weights
    at B = 32, K3 at the purity schedule's 500 steps (p = 6, n_s = 10, and
    p = 29, n_s = 100), K6 at B = 8, the main path's ms per outer
    iteration, 300 x 20 through
    ``solvers.api.partial_reference_deconv`` on ``make_problem``'s data
    (tol = 0), five times, and the same call at 1 x 20 (the solve's fixed
    cost, set-up and result, plus one iteration), seven times, the 16
    batched restarts' ms per outer iteration (100 x 20, three times) and
    the purity path's (20 x 500, three times). Two trees unpacked side by
    side, a change and
    its parent, are compared on one card by timing them in turns, one
    process each (parent, change, change, parent):

        python3 -c 'import chip_smoke; chip_smoke.time_main_path("DIR")'
    """
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    from demethify_tpu_torch import state
    from demethify_tpu_torch.solvers.api import (
        partial_reference_deconv, purity_deconv)

    check(torch.cuda.is_available(), "time_main_path needs a GPU")
    card = phase_device()
    k1 = _k1_case(N_CPG, N_U, "float32", timed=True)
    k2 = _k2_case(N_CT, "float32", timed=True)
    k1_purity = _k1_case(N_CPG, N_U, "float32", steps=P_INNER, seed=7,
                         timed=True, label="[purity]")
    n, n_s, n_ct, n_u = COHORT
    k1_cohort = _k1_case(n, n_u, "float32", n_s=n_s, n_ct=n_ct, seed=8,
                         timed=True, inner=2, reps=5, label="[cohort]")
    k2_cohort = _k2_case(n_ct, "float32", n_u=n_u, n_s=n_s, seed=44,
                         timed=True)
    k4 = _k4_case(N_U, "float32", 16, N_INNER, inactive=(3, 7, 11),
                  timed=True, label="[restarts]")
    k4w = _k4w_case(N_U, "float32", 32, N_INNER, inactive=(3, 7, 11, 30),
                    timed=True, label="[bootstrap]")
    k5 = _k5_case(N_CT, N_U, "float32", 16, (2, 9), timed=True)
    k3 = _k3_case(N_CT, "float32", timed=True)
    k3_cohort = _k3_case(28, "float32", n_s=100, seed=61, timed=True)
    k6 = _k6_case("float32", timed=True)
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
    # the 16 batched restarts (100 x 20) and the purity path (20 x 500)
    kw_r = dict(n_iter2=N_INNER, tol=0.0, seed=3, n_restarts=16)
    partial_reference_deconv(y, d, Rt, N_U, n_iter1=2, **kw_r)      # warm
    restart_ms = [timed_ms(lambda: partial_reference_deconv(
        y, d, Rt, N_U, n_iter1=100, **kw_r))[1] / 100 for _ in range(3)]
    pur = state.purity_from_numpy(purity_draw(0), device=DEV,
                                  dtype=torch.float32)
    kw_p = dict(n_iter2=P_INNER, tol=0.0, init_provided=(u0, a0))
    purity_deconv(y, d, Rt, N_U, pur, n_iter1=2, **kw_p)            # warm
    purity_ms = [timed_ms(lambda: purity_deconv(
        y, d, Rt, N_U, pur, n_iter1=20, **kw_p))[1] / 20 for _ in range(3)]
    print(json.dumps({"root": root, "card": card, "k1_ms": k1["ms"],
                      "k2_ms": k2["ms"], "k1_purity_ms": k1_purity["ms"],
                      "k1_cohort_ms": k1_cohort["ms"],
                      "k2_cohort_ms": k2_cohort["ms"],
                      "k2_queued_ms": k2.get("queued_ms"),
                      "k2_cohort_queued_ms": k2_cohort.get("queued_ms"),
                      "k4_ms": k4["ms"], "k4w_ms": k4w["ms"],
                      "k5_ms": k5["ms"], "k5_queued_ms": k5["queued_ms"],
                      "k3_ms": k3["ms"], "k3_cohort_ms": k3_cohort["ms"],
                      "k6_ms": k6["ms"], "main_ms_per_iter": main_ms,
                      "one_iteration_solve_ms": one_ms,
                      "restarts16_ms_per_iter": restart_ms,
                      "purity_ms_per_iter": purity_ms}), flush=True)



def time_k8(root="."):
    """K8 of the tree at ``root`` timed on one GPU, queued behind a device
    sleep as ``_k8_case`` times it: at the main path's shape (1M x 10,
    p = 6) and the cohort shape (1M x 100, p = 29), on float32, float64
    and bf16 data, with the library calls beside it (float32 and float64;
    none on bf16 data, where no single call keeps K8's float32 sums); and
    the set-up sums the kernel solvers take before their loop,
    ``ops/gram.known_block_grams`` (row chunks of plain tensor ops), at
    the main path's known block (p = 5, n_s = 10) and the cohort's
    (p = 25, n_s = 100), float32, beside K8 on the same data; and the
    composed loop K7 -> K8 -> K9 (``composed_solve``, 1M x 10, 5 + 1,
    float32, 200 x 20, three times). Prints one JSON line. A change and its parent, unpacked side by side, are
    compared on one card in turns (parent, change, change, parent), one
    process each:

        python3 -c 'import chip_smoke; chip_smoke.time_k8("DIR")'
    """
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import grams
    from demethify_tpu_torch.ops.gram import known_block_grams

    check(torch.cuda.is_available(), "time_k8 needs a GPU")
    card = phase_device()
    rows = []
    for n, n_s, p in ((N_CPG, N_S, N_CT + N_U),
                      (COHORT[0], COHORT[1], COHORT[2] + COHORT[3])):
        for dt_name, data in (("float32", None), ("float64", None),
                              ("float32", "bfloat16")):
            yt, dt, rt = _grams_inputs(n, n_s, p, getattr(torch, dt_name),
                                       320)
            if data is not None:
                yt, dt, rt = (x.to(getattr(torch, data)) for x in
                              (yt, dt, rt))
            row = {"n": n, "n_s": n_s, "p": p,
                   "data": str(yt.dtype).replace("torch.", ""),
                   "ms": queued_ms(lambda: grams(yt, dt, rt), inner=10)}
            if data is None:
                row["library_ms"] = median_ms(lambda: (
                    torch.einsum("sn,qn,rn->sqr", dt, rt, rt),
                    rt @ (dt * yt).T, torch.sum(dt * yt * yt, 1)), reps=3,
                    inner=1, warmup=1)
            else:
                # on bf16 data the same calls form and sum their products
                # in bf16; no single PyTorch call keeps K8's float32 sums
                row["library_ms"] = None
            rows.append(row)
            log(f"[time_k8] {row}")
            del yt, dt, rt
            torch.cuda.empty_cache()
    setup = []
    for n_s, p in ((N_S, N_CT), (COHORT[1], COHORT[2])):
        yt, dt, rt = _grams_inputs(N_CPG, n_s, p, torch.float32, 330)
        y, d, r = yt.T, dt.T, rt.T
        row = {"n": N_CPG, "n_s": n_s, "p": p,
               "known_block_grams_ms": median_ms(
                   lambda: known_block_grams(r, d, y), reps=5, inner=1),
               "k8_ms": queued_ms(lambda: grams(yt, dt, rt), inner=10)}
        setup.append(row)
        log(f"[time_k8] set-up sums {row}")
        del yt, dt, rt, y, d, r
        torch.cuda.empty_cache()
    from demethify_tpu_torch import state
    u0, a0, y, d, Rt = state.from_numpy(*make_problem(), device=DEV,
                                        dtype=torch.float32)
    composed_solve(u0, a0, y, d, Rt, N_U, 5, N_INNER)                # warm
    composed = [timed_ms(lambda: composed_solve(
        u0, a0, y, d, Rt, N_U, 200, N_INNER))[1] / 200 for _ in range(3)]
    log(f"[time_k8] composed loop, ms per outer iteration: {composed}")
    print(json.dumps({"root": root, "card": card, "k8": rows,
                      "setup": setup, "composed_ms_per_iter": composed}),
          flush=True)


# K2's column-block step, piece by piece (time_column_variants): each
# variant is K2's sources with one edit, (the file, the text, its
# replacement). "u8*" unroll the row sum or the rank by 8 (the same
# bits); "no*" cut the row sum, the rank or the cumulative sum out of
# the step, so their times (not their outputs) say what the piece costs
_COL_SUM = "    for (int r = 0; r < p; ++r) ga += sg[r * rows + t] * a[r];"
_COL_RANK = ("                for (int r = 0; r < p; ++r) {\n"
             "                    const T vr = peer_load<DEV>(vk + r);")
_COL_CHAIN = ("        if (tid == 0) {\n"
              "            const T* __restrict__ u = srt;")
_COL_V = ("                v = sat[q] + (b_of(t) - column_row_dot(c.sg, sat, "
          "rows, t, p))\n                                 / l_h;")
_K2_SRC = "alpha_phase_full.cu"
_STEPS_SRC = "column_steps.cuh"
COLUMN_VARIANTS = {
    "base": None,
    "u8sum": ("small_common.cuh", _COL_SUM,
              "#pragma unroll 8\n" + _COL_SUM),
    "u8rank": (_STEPS_SRC, _COL_RANK, "#pragma unroll 8\n" + _COL_RANK),
    "nosum": (_STEPS_SRC, _COL_V, "                v = sat[q] + b_of(t) / l_h;"),
    "norank": (_STEPS_SRC, _COL_RANK, _COL_RANK.replace(
        "for (int r = 0; r < p;", "rk = q; for (int r = 0; r < 0;")),
    "nochain": (_STEPS_SRC, _COL_CHAIN, _COL_CHAIN.replace("tid == 0",
                                                           "tid < 0")),
}


def time_column_variants(cases=(("k2", 100, "float64"),
                                ("k2", 200, "float64"),
                                ("k5", 200, "float64"),
                                ("k2", 240, "float32"))):
    """K2's and K5's column blocks of this tree in each of
    ``COLUMN_VARIANTS`` (``alpha_phase_full.cu`` and its headers, the
    step loops in ``column_steps.cuh``, rebuilt
    alone, one library a variant, loaded in place of the whole library
    for these calls) at ``cases`` (kernel, p, dtype; n_s = 10, B = 8 for K5, 20
    steps): ms a launch queued behind a device sleep, the smallest of
    three rounds over the variants, and whether its outputs equal the
    unedited kernel's. Prints one JSON line:

        python3 -c 'import chip_smoke; chip_smoke.time_column_variants()'
    """
    import ctypes

    import torch

    from demethify_tpu_torch.ops import _build, cuda_small

    src_dir = os.path.join(HERE, "demethify_tpu_torch", "csrc")
    out_dir = os.path.join(_build.build_dir(), "column_variants")
    sources = {f: open(os.path.join(src_dir, f)).read()
               for f in (_K2_SRC, _STEPS_SRC, "glue_steps.cuh",
                         "small_common.cuh")}
    procs = {}
    for name, edit in COLUMN_VARIANTS.items():
        texts = dict(sources)
        if edit is not None:
            check(edit[1] in texts[edit[0]], f"variant {name}: no match")
            texts[edit[0]] = texts[edit[0]].replace(edit[1], edit[2])
        var_dir = os.path.join(out_dir, name)
        os.makedirs(var_dir, exist_ok=True)
        for f, t in texts.items():
            with open(os.path.join(var_dir, f), "w") as out:
                out.write(t)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             os.path.join(var_dir, "lib.so"),
             os.path.join(var_dir, _K2_SRC)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, proc in procs.items():
        log_text, _ = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"variant {name}: {log_text[-2000:]}")
        lib = ctypes.CDLL(os.path.join(out_dir, name, "lib.so"))
        for dt in ("f32", "f64"):
            fn = getattr(lib, f"dm_alpha_phase_full_{dt}")
            fn.argtypes, fn.restype = [vp] * 13 + [ci] * 6 + [vp], ci
            fn = getattr(lib, f"dm_alpha_phase_full_multi_{dt}")
            fn.argtypes = ([vp, ll] * 6 + [vp] * 2 + [ll, vp, ll] + [vp, ll]
                           + [vp] * 3 + [ci] * 7 + [vp])
            fn.restype = ci
        lib.dm_alpha_column_plan.argtypes = [ci, ci, vp]
        lib.dm_alpha_column_plan.restype = ll
        libs[name] = _build.KernelLibrary(lib, name, 0.0, "")
    whole = _build.load()
    res = {"card": phase_device()}
    try:
        for kern, p, dt in cases:
            if kern == "k5":
                (gtt, bt, gu, bu, usq, ydy, alpha_b, alpha_prev_b,
                 scal_b) = _glue_multi_inputs(p - 4, 4, dt, 8, (), 600 + p)
                args, state = ((gtt, bt, gu, bu, usq, ydy),
                               (alpha_b, alpha_prev_b, scal_b))
                fn = cuda_small.alpha_phase_full_multi
            else:
                args, _, _, alpha, alpha_prev, scal = _phase_glue_inputs(
                    p, p - 4, dt, 600 + p, N_S)
                state = (alpha, alpha_prev, scal)
                fn = cuda_small.alpha_phase_full
            outs, times = {}, {name: [] for name in libs}
            for name, lib in libs.items():
                _build._LIBRARY = lib
                outs[name] = tuple(x.clone() for x in state)
                fn(*args, *outs[name], N_INNER, 4)
            torch.cuda.synchronize()
            for _ in range(3):
                for name, lib in libs.items():
                    _build._LIBRARY = lib
                    st = tuple(x.clone() for x in state)
                    times[name].append(queued_ms(
                        lambda: fn(*args, *st, N_INNER, 4), inner=20))
            res[f"{kern}_p{p}_{dt}"] = {
                name: {"ms": min(times[name]),
                       "same_bits": all(torch.equal(a, b) for a, b in zip(
                           outs[name], outs["base"]))}
                for name in libs}
            log(f"[variants] {kern} p={p} {dt}: " + ", ".join(
                f"{n} {v['ms']:.4f} ms" for n, v in
                res[f"{kern}_p{p}_{dt}"].items()))
    finally:
        _build._LIBRARY = whole
    print(json.dumps(res), flush=True)


def time_steps(root="."):
    """K1 and K2 of the tree at ``root`` timed at several step counts on
    one GPU (median device ms of back-to-back launches, CUDA events; K2
    queued behind a device sleep, since back to back it times its Python
    wrapper): K1 at the main path's shape and at the cohort shape
    (1M x 100, 25 + 4), in the n_u > 8 form at the AIC sweep's ranks 9
    and 25 (1M x 10, 5 + n_u, float32, the direct form) and in the gram
    form at n_u = 12 (200k x 100, 5 + 12, float64), K2 at p = 6,
    n_s = 10 and at p = 29, n_s = 100, so that each launch splits into a
    fixed cost (at 0 steps: the staging, any C/M build and the Gram
    stage) and a cost per step. Prints one JSON line:

        python3 -c 'import chip_smoke; chip_smoke.time_steps()'
    """
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import (
        A_ALPHA, DMAX2, L_H_PREV, RT_SQ, u_phase_grams)
    from demethify_tpu_torch.ops.cuda_small import alpha_phase_full

    check(torch.cuda.is_available(), "time_steps needs a GPU")
    card = phase_device()
    rows = []
    for name, (n, n_s, n_ct, n_u), dt, steps in (
            ("K1 main", (N_CPG, N_S, N_CT, N_U), "float32", (0, 20, 100, 500)),
            ("K1 cohort", COHORT, "float32", (0, 20, 100)),
            ("K1 rank 9", (N_CPG, N_S, N_CT, 9), "float32", (0, 20, 40)),
            ("K1 rank 25", (N_CPG, N_S, N_CT, 25), "float32", (0, 20, 40)),
            ("K1 gram n_u=12", (N_WIDE, 100, 5, 12), "float64", (0, 20, 40))):
        ydt, rtt, alpha, uut, scal = _k1_inputs(n, n_s, n_ct, n_u,
                                                getattr(torch, dt), 0)
        a1, a2 = alpha[:-n_u], alpha[-n_u:]
        for k in steps:
            u, sc = uut.clone(), scal.clone()
            ms = median_ms(lambda: u_phase_grams(ydt, rtt, a1, a2, u, sc, k),
                           reps=5, inner=4 if n_s > N_S else 10)
            rows.append({"kernel": name, "steps": k, "ms": ms})
            log(f"[steps] {name} {k} steps: {ms:.4f} ms")
        del ydt, rtt, alpha, uut, scal
        torch.cuda.empty_cache()
    for name, (n_ct, n_u, n_s), steps in (
            ("K2 p=6", (N_CT, N_U, N_S), (0, 1, 20, 100)),
            ("K2 cohort", (25, 4, 100), (0, 1, 20, 100))):
        gtt, bt, gu, bu, usq, ydy, alpha, ydt, rtt, scal = _small_inputs(
            n_ct, n_u, "float32", 200_000, 3, n_s)
        scal[A_ALPHA], scal[RT_SQ], scal[DMAX2] = 1.8, torch.sum(
            rtt * rtt), ydt[n_s:].max() ** 2
        scal[L_H_PREV] = (scal[RT_SQ] + usq[0]) * scal[DMAX2]
        for k in steps:
            a, ap, sc = alpha.clone(), alpha.clone(), scal.clone()
            ms = queued_ms(lambda: alpha_phase_full(
                gtt, bt, gu, bu, usq, ydy, a, ap, sc, k, n_u), inner=20)
            rows.append({"kernel": name, "steps": k, "ms": ms})
            log(f"[steps] {name} {k} steps: {ms:.4f} ms")
    print(json.dumps({"root": root, "card": card, "steps": rows}),
          flush=True)


def _profile_main_calls():
    """``profile_kernels``' "main" calls: K1 at the main path's and the
    cohort shape, K2 and K3 (500 steps) at p = 6 and at p = 29,
    n_s = 100, K8 at 1M x 10, p = 6 and at the cohort shape in its three
    data types, and K4 at B = 16 and weighted at B = 32 (1M x 10)."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import (
        A_ALPHA, DMAX2, L_H_PREV, RT_SQ, grams, u_phase_grams)
    from demethify_tpu_torch.ops.cuda_multi import u_phase_grams_multi
    from demethify_tpu_torch.ops.cuda_small import (
        alpha_phase_full, fw_phase_full)

    calls = {}
    for name, (n, n_s, n_ct, n_u) in (("K1 main", (N_CPG, N_S, N_CT, N_U)),
                                      ("K1 cohort", COHORT)):
        ydt, rtt, alpha, uut, scal = _k1_inputs(n, n_s, n_ct, n_u,
                                                torch.float32, 0)
        calls[name] = functools.partial(
            u_phase_grams, ydt, rtt, alpha[:-n_u], alpha[-n_u:], uut, scal,
            N_INNER)
    for name, (n_ct, n_u, n_s) in (("K2 p=6", (N_CT, N_U, N_S)),
                                   ("K2 cohort", (25, 4, 100))):
        gtt, bt, gu, bu, usq, ydy, alpha, ydt, rtt, scal = _small_inputs(
            n_ct, n_u, "float32", 200_000, 3, n_s)
        scal[A_ALPHA], scal[RT_SQ], scal[DMAX2] = 1.8, torch.sum(
            rtt * rtt), ydt[n_s:].max() ** 2
        scal[L_H_PREV] = (scal[RT_SQ] + usq[0]) * scal[DMAX2]
        calls[name] = functools.partial(
            alpha_phase_full, gtt, bt, gu, bu, usq, ydy, alpha.clone(),
            alpha.clone(), scal, N_INNER, n_u)
        purity = torch.linspace(0.3, 0.9, n_s, device=DEV, dtype=alpha.dtype)
        calls["K3" + name[2:]] = functools.partial(
            fw_phase_full, gtt, bt, gu, bu, ydy, alpha.clone(), purity,
            scal.clone(), P_INNER, n_u)
    for name, (n, n_s, p), dt_name, data in (
            ("K8 main", (N_CPG, N_S, N_CT + N_U), "float32", None),
            ("K8 cohort", (COHORT[0], COHORT[1], COHORT[2] + COHORT[3]),
             "float32", None),
            ("K8 cohort float64", (COHORT[0], COHORT[1],
                                   COHORT[2] + COHORT[3]), "float64", None),
            ("K8 cohort bf16", (COHORT[0], COHORT[1], COHORT[2] + COHORT[3]),
             "float32", "bfloat16")):
        yt, dt, rt = _grams_inputs(n, n_s, p, getattr(torch, dt_name), 320)
        if data is not None:
            yt, dt, rt = (x.to(getattr(torch, data)) for x in (yt, dt, rt))
        calls[name] = functools.partial(grams, yt, dt, rt)
    for name, n_b, weighted in (("K4 B=16", 16, False),
                                ("K4 weighted B=32", 32, True)):
        ydt, rtt, alpha_b, uut_b, scal_b = _multi_inputs(
            N_CPG, N_S, N_CT, N_U, n_b, torch.float32, 20)
        w = (resample_weights(n_b, N_CPG, torch.float32, 50) if weighted
             else None)
        calls[name] = functools.partial(
            u_phase_grams_multi, ydt, rtt, alpha_b[:, :-N_U],
            alpha_b[:, -N_U:], uut_b, scal_b, N_INNER, weights=w)
    return calls


def _profile_calls(calls, reps=10):
    """Each call of ``calls`` (name -> function) run ``reps`` times under
    ``torch.profiler`` after 3 warm-up runs: a row per CUDA kernel with its
    launches and mean device us."""
    import torch

    rows = []
    for name, fn in calls.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        act = [torch.profiler.ProfilerActivity.CPU,
               torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=act) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for evt in prof.key_averages():
            dev_us = getattr(evt, "self_device_time_total",
                             getattr(evt, "self_cuda_time_total", 0))
            if dev_us and "kernel" in evt.key:
                rows.append({"call": name, "kernel": evt.key[:120],
                             "count": evt.count,
                             "device_us_mean": dev_us / evt.count})
                log(f"[profile] {name}: {evt.key[:80]} x{evt.count}: "
                    f"{dev_us / evt.count:.2f} us each")
    return rows


def _profile_global_calls():
    """``profile_kernels``' "global" calls: K1's and K4's global layout,
    200k sites, float64 unless stated: K1 at n_s = 64, 160 + 4, with 20
    steps and with none (the main pass without its steps: the C/M build,
    staging and the Gram stage), the direct form 200 + 12 at n_s = 10, and
    400 + 4 at n_s = 64 in float32 (with 20 steps and none); K4 at B = 10,
    160 + 4, and weighted at B = 4, 205 + 4, n_s = 10."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import u_phase_grams
    from demethify_tpu_torch.ops.cuda_multi import u_phase_grams_multi

    calls = {}
    for name, (n_s, n_ct, n_u, dt, steps) in (
            ("K1 160+4", (64, 160, 4, "float64", N_INNER)),
            ("K1 160+4, 0 steps", (64, 160, 4, "float64", 0)),
            ("K1 direct 200+12", (N_S, 200, 12, "float64", N_INNER)),
            ("K1 400+4 float32", (64, 400, 4, "float32", N_INNER)),
            ("K1 400+4 float32, 0 steps", (64, 400, 4, "float32", 0))):
        ydt, rtt, alpha, uut, scal = _k1_inputs(N_WIDE, n_s, n_ct, n_u,
                                                getattr(torch, dt), 400)
        calls[name] = functools.partial(
            u_phase_grams, ydt, rtt, alpha[:n_ct], alpha[n_ct:], uut, scal,
            steps)
    for name, (n_s, n_ct, n_b, weighted) in (
            ("K4 B=10 160+4", (64, 160, 10, False)),
            ("K4 weighted B=4 205+4", (N_S, 205, 4, True))):
        ydt, rtt, alpha_b, uut_b, scal_b = _multi_inputs(
            N_WIDE, n_s, n_ct, 4, n_b, torch.float64, 404)
        w = (resample_weights(n_b, N_WIDE, torch.float64, 405) if weighted
             else None)
        calls[name] = functools.partial(
            u_phase_grams_multi, ydt, rtt, alpha_b[:, :n_ct],
            alpha_b[:, n_ct:], uut_b, scal_b, N_INNER, weights=w)
    return calls


def _profile_staged_calls():
    """``profile_kernels``' "staged" calls: the staged layouts' K1 and K4
    launches whose code the U-phase megakernels' shared device functions
    reach, for a parent/change comparison of their main passes: K1 at the
    cohort shape (1M x 100, 25 + 4; the wide layout, tiled Gram stage)
    and at the main path's, K4 at B = 16 (1M x 10) and in the wide layout
    (200k x 100, 25 + 4, B = 4), float32."""
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import u_phase_grams
    from demethify_tpu_torch.ops.cuda_multi import u_phase_grams_multi

    calls = {}
    for name, (n, n_s, n_ct, n_u) in (("K1 cohort", COHORT),
                                      ("K1 main", (N_CPG, N_S, N_CT, N_U))):
        ydt, rtt, alpha, uut, scal = _k1_inputs(n, n_s, n_ct, n_u,
                                                torch.float32, 0)
        calls[name] = functools.partial(
            u_phase_grams, ydt, rtt, alpha[:-n_u], alpha[-n_u:], uut, scal,
            N_INNER)
    for name, (n, n_s, n_ct, n_u, n_b, seed) in (
            ("K4 B=16", (N_CPG, N_S, N_CT, N_U, 16, 20)),
            ("K4 wide", (200_000, 100, 25, 4, 4, 24))):
        ydt, rtt, alpha_b, uut_b, scal_b = _multi_inputs(
            n, n_s, n_ct, n_u, n_b, torch.float32, seed)
        calls[name] = functools.partial(
            u_phase_grams_multi, ydt, rtt, alpha_b[:, :-n_u],
            alpha_b[:, -n_u:], uut_b, scal_b, N_INNER)
    return calls


# profile_kernels' tables: the calls to profile and the launches of each
PROFILE_TABLES = {"main": (_profile_main_calls, 10),
                  "global": (_profile_global_calls, 5),
                  "staged": (_profile_staged_calls, 20)}


def profile_kernels(root=".", table="main"):
    """Device time per CUDA kernel (``torch.profiler``, its key averages)
    of the calls of ``PROFILE_TABLES[table]`` ("main": the main paths'
    kernels, ``_profile_main_calls``; "global": K1's and K4's global
    layout, ``_profile_global_calls``; "staged": the staged layouts' K1
    and K4 at four shapes, ``_profile_staged_calls``) with the tree at
    ``root``, launched
    back to back: each call's kernels (K1, K4: the prologue, the main
    pass, the fixed-order reduction) with their mean device time. Prints
    one JSON line:

        python3 -c 'import chip_smoke; chip_smoke.profile_kernels("DIR", "main")'
    """
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    check(torch.cuda.is_available(), "profile_kernels needs a GPU")
    card = phase_device()
    make, reps = PROFILE_TABLES[table]
    print(json.dumps({"root": root, "card": card, "table": table,
                      "kernels": _profile_calls(make(), reps)}), flush=True)


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


# the n_u > 8 form's shapes whose layouts the rule is fitted to, in
# LAYOUT_TIMES' terms: the sweep's direct form at n_s = 10 and the
# cohort's gram form at n_s = 100 (K1, and K4 with B = 4), 5 known types
STATE_LAYOUT_TIMES = tuple(
    (n_b, n_s, 5, n_u, N_INNER, dt, None, False, False)
    for dt in ("float32", "float64")
    for n_s, n_u in ((10, 9), (10, 12), (10, 16), (10, 25), (100, 9),
                     (100, 12), (100, 17))
    for n_b in ((0,) if n_u * n_u > 3 * n_s else (0, 4)))


def time_layouts(n=N_CPG, table=LAYOUT_TIMES):
    """Times K1 and K4 in each layout, forced, at every shape of ``table``
    (``LAYOUT_TIMES``, or ``STATE_LAYOUT_TIMES``) on ``n`` sites: the
    resident and the wide layout, above n_u = 8 the global one too (it
    also holds the state region on the chip), each where its shared
    memory fits one block; the median device ms of back-to-back launches
    (CUDA events) in the order of the layouts and back, each layout's
    shared memory and blocks per SM, and the layout ``u_phase_layout``
    plans. Prints one line per shape and one JSON line:

        python3 -c 'import chip_smoke; chip_smoke.time_layouts()'
        python3 -c 'import chip_smoke as c; c.time_layouts(table=c.STATE_LAYOUT_TIMES)'
    """
    import torch

    from demethify_tpu_torch.ops.cuda_kernels import (
        REG_N_U, SMEM_LIMIT, blocks_per_sm, gram_form, state_in_device,
        u_phase_grams, u_phase_layout, u_phase_smem)
    from demethify_tpu_torch.ops.cuda_multi import u_phase_grams_multi

    check(torch.cuda.is_available(), "time_layouts needs a GPU")
    card = phase_device()
    rows = []
    for n_b, n_s, n_ct, n_u, steps, dt, data, lagged, weighted in table:
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
        itemsize = uut.element_size()
        check(not state_in_device(itemsize, n_s, n_u, direct),
              f"n_s={n_s} n_u={n_u} {dt}: the state region does not fit")
        names = ("resident", "wide") + (("global",) if n_u > REG_N_U else ())
        smem = {lay: u_phase_smem(lay, itemsize, n_s, n_ct, n_u, direct,
                                  weighted=weighted) for lay in names}
        lays = [lay for lay in names if smem[lay] <= SMEM_LIMIT]
        inner = 10 if n_s * (n_ct + n_u) * max(n_b, 1) <= 2000 else 2
        ms = {lay: [] for lay in lays}
        for lay in lays + lays[::-1]:
            u, sc = uut.clone(), scal.clone()
            with forced_layout(lay):
                ms[lay].append(median_ms(lambda: fn(
                    ydt, rtt, a1, a2, u, sc, steps, lagged), inner=inner))
        plan = u_phase_layout("K4" if n_b else "K1", itemsize, n_s, n_ct,
                              n_u, direct, weighted=weighted)[0]
        best = min(lays, key=lambda lay: statistics.mean(ms[lay]))
        per_sm = {lay: blocks_per_sm(smem[lay]) for lay in lays}
        row = {"B": n_b, "n": n, "n_s": n_s, "n_ct": n_ct, "n_u": n_u,
               "steps": steps, "state": dt, "data": data or dt,
               "lagged": lagged, "weighted": weighted,
               "form": "direct" if direct else "gram", "ms": ms,
               "smem": smem, "blocks_per_sm": per_sm, "planned": plan,
               "fastest": best}
        rows.append(row)
        log(f"[layout times] {'K4 B=' + str(n_b) if n_b else 'K1'} "
            f"N={n} n_s={n_s} {n_ct}+{n_u} {row['form']} {steps} steps "
            f"{dt} state {data or dt} data{' lagged' if lagged else ''}"
            f"{' weighted' if weighted else ''}: "
            + ", ".join(f"{lay} {ms[lay]} ms ({smem[lay]} B, "
                        f"{per_sm[lay]} blocks/SM)" for lay in lays)
            + f"; planned {plan}, fastest {best}")
        del ydt, rtt, alpha, uut, scal, weights
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "n": n, "layout_times": rows}),
          flush=True)


def _layout_file(layout, case):
    """The suffix of the source that holds K1's (and, after K4's prefix,
    K4's) entry points in ``layout`` for the case's state and data dtypes:
    the global layout has one source a data type."""
    if layout != "global":
        return {"resident": ".cu", "wide": "_wide.cu"}[layout]
    if case.get("data") == "bfloat16":
        return "_global_bf16.cu"
    return "_global_f64.cu" if case.get("dtype") == "float64" else (
        "_global.cu")


def _state_rows(cases, sweep):
    """The kernels JSON line's rows of the n_u > 8 form beyond the
    envelope's n_u = 12 rows: K1 at the AIC sweep's rank 25 (its launches
    the sweep's in that form, ranks 9-25) and the state region in device
    memory in K1 and K4 (no path runs it: its check's launches), with
    ``phase_state_cols``' times."""
    src = "demethify_tpu_torch/csrc/"
    k1_at = "demethify_tpu/ops/pallas_kernels.py:218"
    k4_at = "demethify_tpu/ops/pallas_kernels.py:828"
    rank25 = next(c for c in cases if c["kind"] == "K1" and c["n"] == N_CPG
                  and c["n_u"] == 25)
    dev1 = next(c for c in cases if c["kind"] == "K1"
                and c["state_in_device"])
    dev4 = next(c for c in cases if c["kind"] == "K4"
                and c["state_in_device"])

    def row(name, source, replaces, case, launches, path):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": case["u_max_abs"], "ms": case["ms"],
                "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
                "bound_by": case["bound_by"], "library_ms": None,
                "path": path,
                "redesigned": "the per-site state on the chip (a "
                              "shared-memory state region, register "
                              "tiles)"}

    return [
        row("u_phase_grams{n_u>8, state on chip, direct}",
            "u_phase_grams" + _layout_file(rank25["layout"], rank25),
            k1_at + " (no n_u cap, via :499)", rank25,
            sweep["AIC"]["launches"]["u_phase_grams{n_u>8, state on chip}"],
            "AIC sweep --init SVD to 25 at 1M x 10 (times: rank 25, 1M x "
            "10, 5+25, float32)"),
        row("u_phase_grams{n_u>8, state in device memory}",
            "u_phase_grams_global_f64.cu", k1_at + " (no n_u cap, via :499)",
            dev1, dev1["launches"],
            "its check: 50k x 108, 5+18, float64 (no path runs it)"),
        row("u_phase_grams_multi{n_u>8, state in device memory}",
            "u_phase_grams_multi_global_f64.cu",
            k4_at + " (no n_u cap, via :1123)", dev4, dev4["launches"],
            "its check: 50k x 108, 5+18, B=3, float64 (no path runs it)")]


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
    k3w_b = bound(*glue_work(100, N_S, 99, P_INNER, 8, fw=True), "float64")
    return [
        row("u_phase_grams{wide}", k1_src + "_wide.cu",
            k1_at + " (lane tile shrunk by fused.py:76-108, via :612)", w1,
            env["wide"]["u_phase_grams{wide}"],
            "partial-ref 1M x 100, 25+4, float64, 100x20 (times: n_s=500)"),
        row("u_phase_grams_multi{wide}", k4_src + "_wide.cu",
            k4_at + " (via :1123)", w4,
            env["wide restarts"]["u_phase_grams_multi{wide}"],
            "4 restarts 200k x 100, 25+4, float64 (times: n_s=500, B=4)"),
        row("u_phase_grams{n_u>8, state on chip}",
            k1_src + _layout_file(k1_state["layout"], k1_state),
            k1_at + " (no n_u cap, via :499)", k1_state,
            env["p>32"]["u_phase_grams{n_u>8, state on chip}"],
            "partial-ref 200k x 100, 25+12, float64 (times: 5+12, n_s=100, "
            "float64)"),
        row("u_phase_grams_multi{n_u>8, state on chip}",
            k4_src + _layout_file(k4_state["layout"], k4_state),
            k4_at + " (no n_u cap, via :1123)", k4_state,
            env["p>32 restarts"]["u_phase_grams_multi{n_u>8, state on chip}"],
            "4 restarts 200k x 100, 25+12, float64 (times: 5+12, B=4, "
            "float64)"),
        row("alpha_phase_full{two-row}", src + "alpha_phase_full.cu",
            "demethify_tpu/ops/pallas_small.py:261 (32 < p <= 64, via "
            ":299)", glue["k2"], env["p=40"]["alpha_phase_full{two-row}"],
            "partial-ref 1M x 10, 39+1, float32, 100x20 (times: p=40, "
            "n_s=10, float64)"),
        row("fw_phase_full{two-row}", src + "fw_phase_full.cu",
            "demethify_tpu/ops/pallas_small.py:636 (32 < p <= 64, via "
            ":653)", glue["k3"],
            env["p=40 purity"]["fw_phase_full{two-row}"],
            "purity 1M x 10, 39+1, float32, 10x500 (times: p=40, n_s=10, "
            "float64)", bound_ms=k3_b[0], bound_by=k3_b[1]),
        row("alpha_phase_full_multi{two-row}", src + "alpha_phase_full.cu",
            "demethify_tpu/ops/pallas_small.py:388 (32 < p <= 64, via "
            ":485)", glue["k5"],
            env["p>32 restarts"]["alpha_phase_full_multi{two-row}"],
            "4 restarts 200k x 100, 25+12 (times: p=40, n_s=10, B=4, "
            "float64)"),
        row("fw_phase_full_multi{two-row}", src + "fw_phase_full.cu",
            "demethify_tpu/ops/pallas_small.py:571 (32 < p <= 64, via "
            ":592)", glue["k6"],
            env["p>32 purity restarts"]["fw_phase_full_multi{two-row}"],
            "4 purity restarts 200k x 100, 25+12 (times: p=40, n_s=10, "
            "B=4, float64)"),
        row("alpha_phase{two-row}", src + "alpha_phase.cu",
            "demethify_tpu/ops/pallas_small.py:70 (32 < p <= 64, via :97)",
            glue["k9"], glue["k9"]["check_launches"]["alpha_phase{two-row}"],
            "its check against the twin and K2 (no solver runs K9; times: "
            "p=40, n_s=10, float64)"),
        row("fw_phase{two-row}", src + "fw_phase.cu",
            "demethify_tpu/ops/pallas_small.py:204 (32 < p <= 64, via "
            ":213)", glue["k10"],
            glue["k10"]["check_launches"]["fw_phase{two-row}"],
            "its check against the twin and K3 (no solver runs K10; times: "
            "p=40, n_s=10, float64)"),
        dict(row("alpha_phase_full{column blocks, one block}",
                 src + "alpha_phase_full.cu",
                 "demethify_tpu/ops/pallas_small.py:261 (p > 64, via :299)",
                 glue["k2 wide"], glue["k2 wide"]["check_launches"][
                     "alpha_phase_full{column blocks}"],
                 "its check against the twin at p=100, n_s=10, float64 (no "
                 "path of this script runs p 65-166)"),
             redesigned=K2_COLUMNS),
        dict(row("fw_phase_full{column blocks, one block}",
                 src + "fw_phase_full.cu",
                 "demethify_tpu/ops/pallas_small.py:636 (p > 64, via :653)",
                 glue["k3 wide"], glue["k3 wide"]["check_launches"][
                     "fw_phase_full{column blocks}"],
                 "its check against the twin at p=100, n_s=10, float64 (no "
                 "path of this script runs p 65-168)", bound_ms=k3w_b[0],
                 bound_by=k3w_b[1]), redesigned=K3_COLUMNS),
        dict(row("alpha_phase{column blocks}", src + "alpha_phase.cu",
                 "demethify_tpu/ops/pallas_small.py:70 (p > 64, via :97)",
                 glue["k9 wide"], glue["k9 wide"]["check_launches"][
                     "alpha_phase{column blocks}"],
                 "its checks against the twin and K2 (no solver runs K9; "
                 "times: p=100, n_s=10, float64)"), redesigned=K2_COLUMNS),
        dict(row("fw_phase{column blocks}", src + "fw_phase.cu",
                 "demethify_tpu/ops/pallas_small.py:204 (p > 64, via :213)",
                 glue["k10 wide"], glue["k10 wide"]["check_launches"][
                     "fw_phase{column blocks}"],
                 "its checks against the twin and K3 (no solver runs K10; "
                 "times: p=100, n_s=10, float64)"), redesigned=K3_COLUMNS),
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


def _global_rows(glob, past):
    """The kernels JSON line's rows of the device-memory forms past one
    block's shared memory: launches from ``phase_past_envelope``'s runs,
    times and bounds from ``phase_global_kernels``' cases."""
    src = "demethify_tpu_torch/csrc/"
    k1_at = "demethify_tpu/ops/pallas_kernels.py:218"
    k4_at = "demethify_tpu/ops/pallas_kernels.py:828"

    def row(name, source, replaces, case, launches, path):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": case.get("alpha_max_abs",
                                        case.get("u_max_abs")),
                "ms": case["ms"], "plain_ms": case["plain_ms"],
                "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
                "library_ms": None, "path": path}

    k3_b = bound(*glue_work(200, N_S, 199, P_INNER, 8, fw=True), "float64")
    k3 = dict(glob["k3"], bound_ms=k3_b[0], bound_by=k3_b[1])
    return [
        row("u_phase_grams{global}", "u_phase_grams_global_f64.cu",
            k1_at + " (any p, via :499)", glob["k1"],
            past["global"]["u_phase_grams{global}"],
            "partial-ref 20k x 10, 200+10, float64, 10x10 (times: 200k x "
            "64, 160+4)"),
        row("u_phase_grams_multi{global}",
            "u_phase_grams_multi_global_f64.cu",
            k4_at + " (any p, via :1123)", glob["k4"],
            past["global restarts"]["u_phase_grams_multi{global}"],
            "4 restarts 20k x 10, 205+4, float64, 10x10 (times: 200k x 64, "
            "160+4, B=10)"),
        row("u_phase_grams_multi[weights]{global}",
            "u_phase_grams_multi_global_f64.cu",
            k4_at + " (weights operand, any p, via :1123)", glob["k4w"],
            past["global bootstrap"]["u_phase_grams_multi{global}"],
            "purity weights bootstrap 20k x 10, 205+4, B=4, float64, 5x100 "
            "(times: 200k x 10, B=4)"),
        dict(row("alpha_phase_full{column blocks}", "alpha_phase_full.cu",
                 "demethify_tpu/ops/pallas_small.py:261 (any p, via :299)",
                 glob["k2"],
                 past["global"]["alpha_phase_full{column blocks}"],
                 "partial-ref 20k x 10, 200+10, float64 (times: p=200)"),
             redesigned=K2_COLUMNS),
        dict(row("fw_phase_full{column blocks}", "fw_phase_full.cu",
                 "demethify_tpu/ops/pallas_small.py:636 (any p, via :653)",
                 k3, past["column blocks purity"][
                     "fw_phase_full{column blocks}"],
                 "purity 20k x 10, 179+1, float64, 5x100 (times: p=200)"),
             redesigned=K3_COLUMNS),
        dict(row("alpha_phase_full_multi{column blocks}",
                 "alpha_phase_full.cu",
                 "demethify_tpu/ops/pallas_small.py:388 (any p, via :485)",
                 glob["k5"], past["global restarts"][
                     "alpha_phase_full_multi{column blocks}"],
                 "4 restarts 20k x 10, 205+4, float64 (times: p=200, B=8)"),
             redesigned=K2_COLUMNS),
        dict(row("fw_phase_full_multi{column blocks}", "fw_phase_full.cu",
                 "demethify_tpu/ops/pallas_small.py:571 (any p, via :592)",
                 glob["k6"], past["global purity restarts"][
                     "fw_phase_full_multi{column blocks}"],
                 "4 purity restarts 20k x 10, 205+4, float64 (times: p=200, "
                 "B=8)"), redesigned=K3_COLUMNS)]


def _column_rows_rows(col_rows):
    """The kernels JSON line's rows of the glue kernels past 8 blocks a
    column (no path runs them): clusters of 9-16 blocks, timed at p = 460
    (K2, K9) and 490 (K3, K10), and the device rows past 16, timed at 625
    and 671; float64, n_s = 10, 20 steps. ``launches`` counts each form's
    launches in ``phase_column_rows``' checks (the column-block count
    there is of clusters of 9-16 blocks only)."""
    src = "demethify_tpu_torch/csrc/"
    rows = []
    for form, (pa, pf) in (("column blocks, 9-16 blocks", (460, 490)),
                           ("device rows", (625, 671))):
        counter = "device rows" if form == "device rows" else "column blocks"
        for name, source, at, case, p in (
                ("alpha_phase_full", "alpha_phase_full.cu",
                 "pallas_small.py:261 (any p, via :299)", "k2", pa),
                ("fw_phase_full", "fw_phase_full.cu",
                 "pallas_small.py:636 (any p, via :653)", "k3", pf),
                ("alpha_phase", "alpha_phase.cu",
                 "pallas_small.py:70 (any p, via :97)", "k9", pa),
                ("fw_phase", "fw_phase.cu",
                 "pallas_small.py:204 (any p, via :213)", "k10", pf)):
            res = col_rows[f"{case} p{p}"]
            if case == "k3":
                res = dict(res, **dict(zip(("bound_ms", "bound_by"), bound(
                    *glue_work(p, N_S, p - 1, 20, 8, fw=True), "float64"))))
            rows.append(dict(
                {"name": f"{name}{{{form}}}", "route": "cuda",
                 "source": src + source,
                 "replaces": "demethify_tpu/ops/" + at,
                 "launches": col_rows["launches"].get(
                     f"{name}{{{counter}}}", 0),
                 "max_abs_err": res["alpha_max_abs"], "ms": res["ms"],
                 "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                 "bound_by": res["bound_by"], "library_ms": None,
                 "path": f"its checks against the twin (no path runs p > "
                         f"452; times: p={p}, n_s=10, 20 steps, float64)"},
                redesigned=(K2_COLUMNS if case in ("k2", "k9")
                            else K3_COLUMNS)))
    return rows


# what the kernels line says of the kernels this round redesigned
K3_REDESIGN = ("row bucket P >= p; step sizes from a table; a warp per "
               "column over several blocks past 16 columns")
K3_COLUMNS = ("p > 64: a block, or a cluster of up to 16 blocks, a column, "
              "one row a thread, G_s rows in the blocks' shared memory (past "
              "16 blocks in device memory, up to 1024 threads a block), the "
              "minima folded through distributed shared memory")
K2_COLUMNS = ("p > 64: a block, or a cluster of up to 16 blocks, a column, "
              "one row a thread, G_s rows in the blocks' shared memory (past "
              "16 blocks in device memory, up to 1024 threads a block), v "
              "ranked across the cluster through distributed shared memory, "
              "one chain for the cumulative sum, the tests side by side")
K4_REDESIGN = ("members in groups (k4_member_plan): steps back to back, "
               "one Gram stage a group in tiles across the members; "
               "partials (n_blocks, B E)")


K8_REDESIGN = ("tensor cores: 3xTF32 (float32) and DMMA (float64) on the "
               "pair form, bf16 MMA per sample; a cp.async ring, two operand "
               "buffers")


def _single_phase_rows(single):
    """The kernels JSON line's rows of K7-K10: K7, K8 and K9 with their
    launches from the composed loop's full-width run, K10 with its
    launches in its own checks (no path runs it); times and bounds at the
    main path's shape (K8 with ``library_ms``, the einsum, matmul and sum
    that compute the same Grams, and its bound at its tensor-core route's
    rate, the CUDA-core bound beside it)."""
    src = "demethify_tpu_torch/csrc/"
    launches = single["composed"]["launches"]

    def row(name, source, replaces, case, n_launches, err,
            library_ms=None):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": replaces, "launches": n_launches,
                "max_abs_err": err, "ms": case["ms"],
                "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
                "bound_by": case["bound_by"], "library_ms": library_ms}

    k7, k8, k9, k10 = (single[k] for k in ("k7", "k8", "k9", "k10"))
    return [
        row("u_phase", "u_phase.cu",
            "demethify_tpu/ops/pallas_kernels.py:65 (via :117)", k7,
            launches["u_phase"], k7["u_max_abs"]),
        dict(row("grams", "grams.cu",
                 "demethify_tpu/ops/pallas_kernels.py:743 (via :776)", k8,
                 launches["grams"], k8["max_abs_err"], k8["library_ms"]),
             redesigned=K8_REDESIGN, bound_rate=k8["bound_rate"],
             cuda_core_bound_ms=k8["cuda_core_bound_ms"],
             float64={k: single["k8_f64"][k] for k in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
             library_ms_bf16_data=None),
        row("alpha_phase", "alpha_phase.cu",
            "demethify_tpu/ops/pallas_small.py:70 (via :97)", k9,
            launches["alpha_phase"], k9["alpha_max_abs"]),
        dict(row("fw_phase", "fw_phase.cu",
                 "demethify_tpu/ops/pallas_small.py:204 (via :213)", k10,
                 single["k10_launches"], k10["alpha_max_abs"]),
             redesigned="K3's loop: row bucket P >= p; step sizes from a "
                        "table")]


# ------------------------------------------------------------ phase 12
# Row-sharded runs: RANKS ranks on the one card over gloo (a correctness
# run: gloo sums through the host, so its times are not scaling), held to
# the one-rank kernel solve on the same card; the CLI with --multihost;
# NCCL over the cards where the machine has more than one.
RANKS = 2
RANK_OUTER, RANK_P_OUTER, RANK_BOOT_OUTER = 50, 10, 30
RANK_MEMBERS, RANK_BOOT = 4, 8
RANK_SEED = 11
# the kernels each row-sharded solve launches once an outer iteration
RANK_KERNELS = {
    "partial-ref float32": ("u_phase_grams", "alpha_phase_full"),
    "partial-ref float64": ("u_phase_grams", "alpha_phase_full"),
    "purity float64": ("u_phase_grams", "fw_phase_full"),
    "unsupervised float64": ("u_phase_grams", "alpha_phase_full"),
    "partial-ref multi float64": ("u_phase_grams_multi",
                                  "alpha_phase_full_multi"),
    "purity multi float64": ("u_phase_grams_multi", "fw_phase_full_multi"),
    "weights bootstrap float64": ("u_phase_grams_multi",
                                  "alpha_phase_full_multi")}


def rank_solves(axis, block):
    """The phase's solves on this rank's block of the 1M x 10 problem
    (5 + 1; unsupervised n_u = 3) through the row-sharded solvers, tol = 0:
    partial-reference float32 and float64 (RANK_OUTER x 20), purity
    float64 (RANK_P_OUTER x 500), unsupervised float64, the
    partial-reference and purity multi solvers at B = RANK_MEMBERS, and
    the row-sharded weights bootstrap (B = RANK_BOOT, RANK_BOOT_OUTER x
    20, ``bootstrap_ci(shard=)``). Each runs once with one outer
    iteration to warm up, once more so timed (its fixed cost), then with
    the counters set to 0 just before and read just after, timed with
    CUDA events. ``axis`` LOCAL with the whole block: the one-rank
    solves. -> {name: dict(u (this rank's data rows; the bootstrap: its u
    bounds, all rows), alpha, trace, n_iter, launches, ms_iter (all in),
    fixed_ms, further_ms (an outer iteration past the first))}."""
    import torch

    from demethify_tpu_torch.parallel.distributed import Shard
    from demethify_tpu_torch.solvers import fused
    from demethify_tpu_torch.uncertainty.bootstrap import bootstrap_ci

    out = {}

    def run(name, make, n_outer):
        """make(n_iter1) -> the solve's call."""
        make(1)()
        torch.cuda.synchronize()
        _, fixed_ms = timed_ms(make(1))
        reset_counts()
        res, ms = timed_ms(make(n_outer))
        launches = {k: v for k, v in read_counts().items() if v}
        want = {k: n_outer for k in RANK_KERNELS[name]}
        check(launches == want, f"[ranks] {name}: launches {launches} != "
                                f"{want} on rank {axis.rank}")
        if name.startswith("weights"):
            lo_p, hi_p, lo_u, hi_u = res
            u, alpha = (np.stack([lo_u, hi_u])[:, :block.n_rows],
                        np.stack([lo_p, hi_p]))
            trace, n_iter = np.zeros(0), np.asarray(n_outer)
        else:
            u, alpha, info = res
            u = u[..., :block.n_data, :].cpu().numpy()
            alpha, trace = alpha.cpu().numpy(), info["trace"].cpu().numpy()
            n_iter = np.asarray(info["n_iter"])
        out[name] = dict(u=u, alpha=alpha, trace=trace, n_iter=n_iter,
                         launches=launches, ms_iter=ms / n_outer,
                         fixed_ms=fixed_ms,
                         further_ms=(ms - fixed_ms) / (n_outer - 1))

    for dname, dt in (("float32", torch.float32), ("float64", torch.float64)):
        np_dt = np.float32 if dname == "float32" else np.float64
        u0, a0, y, d, Rt = make_problem(np_dt, seed=RANK_SEED)

        def rows(x, axis_=0):
            return torch.as_tensor(block.take(x, axis_)).to(DEV)

        yb, db, Rb = rows(y), rows(d), rows(Rt)
        a0t = torch.as_tensor(a0).to(DEV)

        def kw(n_iter1, n_iter2=N_INNER):
            return dict(n_iter1=n_iter1, n_iter2=n_iter2, tol=0.0,
                        record_trace=True)

        run(f"partial-ref {dname}",
            lambda n: lambda: fused.partial_ref_solve_fused_sharded(
                rows(u0), a0t, yb, db, Rb, N_U, axis, **kw(n)), RANK_OUTER)
        if dname == "float32":
            continue
        pur = torch.as_tensor(purity_draw(RANK_SEED)).to(DEV)
        run("purity float64",
            lambda n: lambda: fused.purity_solve_fused_sharded(
                rows(u0), a0t, yb, db, Rb, pur, N_U, axis, **kw(n, P_INNER)),
            RANK_P_OUTER)
        uu0, ua0 = unsupervised_init(N_CPG, np_dt, RANK_SEED)
        run("unsupervised float64",
            lambda n: lambda: fused.unsupervised_solve_fused_sharded(
                rows(uu0), torch.as_tensor(ua0).to(DEV), yb, db, U_N_U, axis,
                **kw(n)), RANK_OUTER)
        u_b, a_b = _member_inits(N_CPG, RANK_MEMBERS, N_CT, N_U, RANK_SEED)
        run("partial-ref multi float64",
            lambda n: lambda: fused.partial_ref_solve_fused_multi_sharded(
                rows(u_b, 1), torch.as_tensor(a_b).to(DEV), yb, db, Rb, N_U,
                axis, **kw(n)), RANK_OUTER)
        pu_b, pa_b = _member_inits(N_CPG, RANK_MEMBERS, N_CT, N_U,
                                   RANK_SEED, purity=purity_draw(RANK_SEED))
        run("purity multi float64",
            lambda n: lambda: fused.purity_solve_fused_multi_sharded(
                rows(pu_b, 1), torch.as_tensor(pa_b).to(DEV), yb, db, Rb, pur,
                N_U, axis, **kw(n, P_INNER)), RANK_P_OUTER)
        bkw = dict(shard=Shard(axis, block)) if axis.size > 1 else {}
        run("weights bootstrap float64", lambda n: lambda: bootstrap_ci(
            yb, db, Rb, N_U, level=90, n_bootstrap=RANK_BOOT, n_iter1=n,
            n_iter2=N_INNER, tol=0.0, seed=RANK_SEED, method="weights",
            **bkw), RANK_BOOT_OUTER)
    return out


def rank_worker(out_dir, store, n_ranks, rank):
    """One rank of ``phase_ranks``: ``rank_solves`` on its block, saved to
    out_dir/rankRANK.npz (arrays) and .json (launches, times)."""
    from demethify_tpu_torch.parallel.distributed import (
        initialize_layout,
        shutdown,
    )
    from demethify_tpu_torch.parallel.mesh import row_block

    layout, device = initialize_layout(store, n_ranks, rank)
    axis = layout.world
    try:
        t0 = time.perf_counter()
        res = rank_solves(axis, row_block(N_CPG, n_ranks, rank))
        arrays = {f"{name}/{k}": v for name, r in res.items()
                  for k, v in r.items() if isinstance(v, np.ndarray)}
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump({"backend": axis.backend, "device": str(device),
                       "wall_s": time.perf_counter() - t0,
                       "solves": {name: {k: r[k] for k in (
                           "launches", "ms_iter", "fixed_ms", "further_ms")}
                                  for name, r in res.items()}}, f)
    finally:
        shutdown(axis)
    return 0


def _run_rank_processes(argvs, timeout, cards=False):
    """Run the rank processes (``cards``: LOCAL_RANK r, each on a card of
    its own); fail unless every one exits 0."""
    from demethify_tpu_torch.parallel.distributed import run_ranks

    envs = ([dict(os.environ, LOCAL_RANK=str(r)) for r in range(len(argvs))]
            if cards else None)
    codes = run_ranks([[sys.executable, *a] for a in argvs], timeout, envs,
                      cwd=HERE)
    check(codes == [0] * len(argvs), f"rank processes exited {codes}")


def phase_ranks(card):
    """RANKS ranks on the one card (gloo), and where the machine has
    several cards one rank a card (NCCL), each against the one-rank
    kernel solve: float64 cost trace rtol 1e-9, u and alpha atol 1e-9
    (float32: TRAJ_TOL), every rank with the same bits of cost, alpha and
    n_iter, and the launches of each solve on each rank one per kernel and
    outer iteration. Returns {name: {one, two, launches}} of the one-card
    run (one and two: the times of one rank and of the slowest rank)."""
    import torch

    from demethify_tpu_torch.parallel.distributed import LOCAL
    from demethify_tpu_torch.parallel.mesh import row_block

    t0 = time.perf_counter()
    one = rank_solves(LOCAL, row_block(N_CPG, 1, 0))
    log(f"[ranks] the one-rank solves took {time.perf_counter() - t0:.1f} s")
    out = _ranks_vs_one(one, RANKS, card, False)
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        log(f"[ranks] NCCL over several cards: this machine has {n_cards} "
            f"card; the multi-card run waits for a machine with more than "
            f"one")
    else:
        _ranks_vs_one(one, n_cards, card, True)
    return out


def _ranks_vs_one(one, n_ranks, card, cards):
    """``rank_worker`` on n_ranks processes (``cards``: one a card) against
    the one-rank results ``one``."""
    with tempfile.TemporaryDirectory() as root:
        store = "file://" + os.path.join(root, "store")
        t0 = time.perf_counter()
        _run_rank_processes([[os.path.join(HERE, "chip_smoke.py"),
                              "--ranks-worker", root, store, str(n_ranks),
                              str(r)] for r in range(n_ranks)], 900, cards)
        t_two = time.perf_counter() - t0
        ranks = [dict(np.load(os.path.join(root, f"rank{r}.npz")))
                 for r in range(n_ranks)]
        meta = []
        for r in range(n_ranks):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                meta.append(json.load(f))
    backend = "nccl" if cards else "gloo"
    log(f"[ranks] {n_ranks} ranks on {[m['device'] for m in meta]} (card "
        f"{card}), sums by {meta[0]['backend']}: the processes took "
        f"{t_two:.1f} s (solves {max(m['wall_s'] for m in meta):.1f} s)")
    check(all(m["backend"] == backend for m in meta),
          f"{n_ranks} ranks: sums by {[m['backend'] for m in meta]}, not "
          f"{backend}")
    what = ("one a card, NCCL" if cards else
            "on the one card (correctness run: gloo through the host, not "
            "scaling)")
    out = {}
    for name, want in one.items():
        tol = (TRAJ_TOL["float32"] if "float32" in name else
               {"cost": 1e-9, "alpha": 1e-9})
        # u moves with alpha: float32 takes alpha's trajectory bound
        utol = tol["alpha"]
        key = f"{name}/"
        for r in ranks[1:]:
            for k in ("alpha", "trace", "n_iter"):
                check(np.array_equal(r[key + k], ranks[0][key + k],
                                     equal_nan=True),
                      f"[ranks] {name}: ranks disagree on {k}")
        u = (ranks[0][key + "u"] if name.startswith("weights") else
             np.concatenate([r[key + "u"] for r in ranks], axis=-2))
        err_u = float(np.max(np.abs(u - want["u"])))
        err_a = float(np.max(np.abs(ranks[0][key + "alpha"] - want["alpha"])))
        tr, tw = ranks[0][key + "trace"], want["trace"]
        err_c = (float(np.max(np.abs(tr - tw) / np.abs(tw))) if tw.size
                 else 0.0)
        same_iter = np.array_equal(ranks[0][key + "n_iter"], want["n_iter"])
        launches = [m["solves"][name]["launches"] for m in meta]
        two = {k: max(m["solves"][name][k] for m in meta)
               for k in ("ms_iter", "fixed_ms", "further_ms")}
        log(f"[ranks] {name}: {n_ranks} ranks vs one: cost trace max rel "
            f"diff {err_c:.3e} (tol {tol['cost']:.0e}), alpha max|diff| "
            f"{err_a:.3e} (tol {tol['alpha']:.0e}), u max|diff| {err_u:.3e} "
            f"(tol {utol:.0e}), n_iter equal {same_iter}; launches per rank "
            f"{launches}; ms per outer iteration past the first (all in; "
            f"fixed cost) one rank {want['further_ms']:.4f} "
            f"({want['ms_iter']:.4f}; {want['fixed_ms']:.2f}), {n_ranks} "
            f"ranks {what} {two['further_ms']:.4f} ({two['ms_iter']:.4f}; "
            f"{two['fixed_ms']:.2f})")
        check(same_iter and err_c <= tol["cost"] and err_a <= tol["alpha"]
              and err_u <= utol, f"[ranks] {name}: {n_ranks} ranks differ "
                                 f"from one")
        check(all(lc == want["launches"] for lc in launches),
              f"[ranks] {name}: launches {launches} != {want['launches']}")
        out[name] = dict(one={k: want[k] for k in two}, two=two,
                         launches=want["launches"])
    return out


def _parts(outdir, n_ranks=RANKS):
    """The multi-process profile part files, reassembled in row order."""
    header, rows = None, []
    for r in range(n_ranks):
        h, part = _read_csv(os.path.join(
            outdir, f"methylation_profile_estimate.part{r:04d}.csv"))
        header = h[1:]
        rows.extend(part)
    check([int(r[0]) for r in rows] == list(range(len(rows))),
          "part files' global rows")
    return header, np.array([[float(x) for x in r[1:]] for r in rows])


def phase_ranks_cli():
    """The CLI with --multihost as RANKS processes on the one card against
    the one-process CLI, float64, on the phase-10 fixture: proportions
    within 1e-8, the part files reassembling into the profile,
    ``--confidence 90 7`` (with ``--restart 4``), ``--ic AIC --icmax 3``,
    ``--savestate`` and a warm start from ``--initstate``; then ``--shard``
    over the cards where there are several."""
    import torch

    from demethify_tpu_torch.cli import main as cli_main

    with tempfile.TemporaryDirectory() as root:
        samples, ref = _write_fixture(root)
        base = ["--methfreq", *samples, "--bedmethyl", "--noprint",
                "--device", DEV, "--dtype", "float64", "--ref", ref]
        ckpt = os.path.join(root, "ckpt")
        iters = ["--iterations", "200", "20"]
        runs = (("confidence", ["--nbunknown", "1", *iters, "--restart", "4",
                                "--confidence", "90", "7"],
                 ["--savestate", ckpt + "-one"], ["--savestate", ckpt]),
                ("ic", ["--ic", "AIC", "--icmax", "3", *iters], [], []),
                ("warm start", ["--nbunknown", "1", *iters], ["--initstate",
                                                              ckpt],
                 ["--initstate", ckpt]))
        for tag, extra, one_extra, two_extra in runs:
            one = os.path.join(root, f"{tag}-one")
            two = os.path.join(root, f"{tag}-two")
            t0 = time.perf_counter()
            check(cli_main(base + extra + one_extra + ["--outdir", one]) == 0,
                  f"CLI {tag}: one process")
            t_one = time.perf_counter() - t0
            store = "file://" + os.path.join(root, f"{tag}-store")
            t0 = time.perf_counter()
            _run_rank_processes(
                [["-m", "demethify_tpu_torch", *base, *extra, *two_extra,
                  "--outdir", two, "--multihost", store, str(RANKS), str(r)]
                 for r in range(RANKS)], 600)
            t_two = time.perf_counter() - t0
            props = [np.array([[float(x) for x in r[1:]] for r in _read_csv(
                os.path.join(o, "celltypes_proportions.csv"))[1]])
                for o in (one, two)]
            err = float(np.max(np.abs(props[0] - props[1])))
            msg = (f"[ranks cli] {tag}: {RANKS} processes vs one, "
                   f"proportions max|diff| {err:.3e} (tol 1e-8)")
            check(err <= 1e-8, msg)
            if tag == "ic":
                logs = [open(os.path.join(o, "log.log")).read().splitlines()
                        for o in (one, two)]
                check(logs[0][1] == logs[1][1], f"--ic chose {logs}")
                msg += f"; {logs[1][1]}"
            else:
                h1, p1 = _read_csv(os.path.join(
                    one, "methylation_profile_estimate.csv"))
                h2, p2 = _parts(two)
                p1 = np.array([[float(x) for x in r] for r in p1])
                err_u = float(np.max(np.abs(p1 - p2)))
                check(h1 == h2 and err_u <= 1e-8,
                      f"{tag}: part files vs the profile {err_u}")
                msg += f", part files vs the profile {err_u:.3e}"
            if tag == "confidence":
                for name, index in (
                        ("confidence_interval_celltypes_proportions.csv",
                         True),
                        ("confidence_interval_methylation_estimate.csv",
                         False)):
                    lo1, hi1 = _read_ci(os.path.join(one, name), index)
                    lo2, hi2 = _read_ci(os.path.join(two, name), index)
                    rel = float(max(np.max(np.abs(lo1 - lo2) / np.maximum(
                        np.abs(lo1), 1e-300)), np.max(np.abs(hi1 - hi2)
                                                     / np.maximum(
                                                         np.abs(hi1), 1e-300))))
                    check(rel <= 1e-10, f"{name}: rel diff {rel}")
                    msg += f", {name} rel diff {rel:.1e}"
            log(f"{msg}; wall one {t_one:.1f} s, {RANKS} processes "
                f"{t_two:.1f} s")
        n_cards = torch.cuda.device_count()
        if n_cards < 2:
            log(f"[ranks cli] --shard over NCCL: this machine has {n_cards} "
                f"card; the multi-card run waits for a machine with more "
                f"than one")
            return
        outs = [os.path.join(root, f"shard-{k}") for k in ("one", "cards")]
        flags = base + ["--nbunknown", "1", *iters]
        check(cli_main(flags + ["--outdir", outs[0]]) == 0, "CLI one card")
        check(cli_main(flags + ["--shard", "--outdir", outs[1]]) == 0,
              "CLI --shard")
        props = [np.array([[float(x) for x in r[1:]] for r in _read_csv(
            os.path.join(o, "celltypes_proportions.csv"))[1]]) for o in outs]
        err = float(np.max(np.abs(props[0] - props[1])))
        check(err <= 1e-8, f"--shard proportions differ by {err}")
        _, p_shard = _parts(outs[1], n_cards)
        check(p_shard.shape == (N_CLI, 1), "--shard part files")
        log(f"[ranks cli] --shard over {n_cards} cards (NCCL): proportions "
            f"max|diff| {err:.3e} from the one-card run (tol 1e-8), part "
            f"files of {p_shard.shape[0]} rows")


# ------------------------------------------------------------ phase 13
# The CLI's last flags and the host tools: --profile, --debugnans, the
# feature selection's device path, the preprocessing pipeline a user runs,
# and the 2-D layout (--multihost --shard: LAYOUT_PROCS processes of
# LAYOUT_LOCAL workers, all on the one card over gloo: a correctness run,
# not scaling).
OBS_OUTER = 50
NAN_COST_OUTER = 200
SELECT_ROWS, SELECT_COLS, SELECT_KEEP = 2_000_000, 25, 20_000
PIPE_REF, PIPE_TYPES, PIPE_KEEP = 50_000, 8, 20_000
LAYOUT_PROCS, LAYOUT_LOCAL = 2, 2
N_2D = 200_000
LAYOUT_OUTER, LAYOUT_BOOT, LAYOUT_BOOT_OUTER = 30, 8, 20
# the 2-D CCC sweep of the API run: ranks 1-2 over ``across``, each rank's
# restarts (and the winner's, solved again) batched through the
# row-sharded multi-member solvers over ``rows``
LAYOUT_CCC_OUTER = 20
LAYOUT_CCC = dict(seed=22, iter2=N_INNER, tol=0.0, n_restarts=3, n_u_max=2)
LAUNCH_2D = ("import sys; from demethify_tpu_torch.cli import "
             "_run_shard_workers; sys.exit(_run_shard_workers(sys.argv[2:], "
             "int(sys.argv[1])))")
# K1's main pass and K2's kernels by name in a trace (K2's register,
# two-row and column-block forms, the device rows among the last; K5
# takes the same kernels with a member grid, and runs on no path of this
# phase's profiled run)
K1_KERNEL = "u_phase_grams_kernel"
K2_KERNELS = ("alpha_phase_reg_kernel", "alpha_phase_two_row_kernel",
              "alpha_phase_columns_kernel")


def _same_csvs(a, b, what):
    names = sorted(n for n in os.listdir(a) if n.endswith(".csv"))
    check(names and names == sorted(n for n in os.listdir(b)
                                    if n.endswith(".csv")),
          f"{what}: CSV files {names}")
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            check(fa.read() == fb.read(), f"{what}: {name} differs")
    return names


def _trace_kernels(path):
    """{kernel name: (count, summed device us)} of a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") == "kernel":
            n, us = out.get(e["name"], (0, 0.0))
            out[e["name"]] = (n + 1, us + float(e.get("dur", 0.0)))
    return out


def phase_observability(problem32, card):
    """(a) ``--profile``: the CLI in partial-reference mode at 1M x 10,
    float32, OBS_OUTER x 20: K1's main pass and K2 appear in the trace as
    often as their counters count, each kernel's summed device time is
    printed, and the CSVs are byte-identical to the run without the flag.
    (b) ``--debugnans``: the same run byte-identical with and without the
    flag; the ms per outer iteration of the main path (1M x 10, 200 x 20,
    tol = 0) with and without it (off, on, on, off), the same bits; and an
    input that gives NaN (a warm start whose unknown alpha block is zero)
    makes the CLI exit non-zero with FloatingPointError. Returns the
    numbers."""
    import torch

    from demethify_tpu_torch import state
    from demethify_tpu_torch.checkpoint import save_factors
    from demethify_tpu_torch.cli import main as cli_main
    from demethify_tpu_torch.solvers.api import partial_reference_deconv
    from demethify_tpu_torch.utils import enable_nan_debugging

    out = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        samples, ref = _write_fixture(root, seed=13, n=N_CPG)
        log(f"[observability] 1M-row fixture written in "
            f"{time.perf_counter() - t0:.1f} s")
        base = ["--methfreq", *samples, "--bedmethyl", "--noprint",
                "--device", DEV, "--ref", ref, "--nbunknown", "1",
                "--iterations", str(OBS_OUTER), str(N_INNER)]
        runs = {}
        for tag, extra in (("plain", []), ("profile", [
                "--profile", os.path.join(root, "trace")]),
                ("debugnans", ["--debugnans"])):
            outdir = os.path.join(root, tag)
            reset_counts()
            t0 = time.perf_counter()
            check(cli_main(base + extra + ["--outdir", outdir]) == 0,
                  f"CLI --{tag}")
            runs[tag] = (read_counts(), time.perf_counter() - t0)
        for tag in ("profile", "debugnans"):
            names = _same_csvs(os.path.join(root, "plain"),
                               os.path.join(root, tag), f"--{tag}")
        launches = runs["profile"][0]
        kernels = _trace_kernels(os.path.join(root, "trace", "trace.json"))
        n_k1 = sum(n for k, (n, _) in kernels.items() if K1_KERNEL in k)
        n_k2 = sum(n for k, (n, _) in kernels.items()
                   if any(s in k for s in K2_KERNELS))
        for name, (n, us) in sorted(kernels.items(),
                                    key=lambda kv: -kv[1][1]):
            log(f"[profile] {name[:100]}: x{n}, {us / 1e3:.4f} ms in all, "
                f"{us / n:.2f} us each")
        log(f"[profile] CLI --profile at 1M x {N_S}, 5+1, float32, "
            f"{OBS_OUTER}x{N_INNER}, card {card}: K1 main pass x{n_k1}, K2 "
            f"x{n_k2} in the trace; counters u_phase_grams "
            f"{launches['u_phase_grams']}, alpha_phase_full "
            f"{launches['alpha_phase_full']}; CSVs byte-identical to the "
            f"run without the flag ({', '.join(names)}); wall "
            f"{runs['profile'][1]:.1f} s ({runs['plain'][1]:.1f} s without)")
        check(launches["u_phase_grams"] > 0
              and n_k1 == launches["u_phase_grams"]
              and n_k2 == launches["alpha_phase_full"],
              f"trace counts K1 {n_k1}, K2 {n_k2} vs counters {launches}")
        out["trace"] = {k[:120]: {"count": n, "device_us": us}
                        for k, (n, us) in kernels.items()}
        out["launches"] = {k: v for k, v in launches.items() if v}
        log(f"[debugnans] CLI --debugnans at 1M x {N_S}: CSVs "
            f"byte-identical to the run without the flag; launches "
            f"{ {k: v for k, v in runs['debugnans'][0].items() if v} }")
        check(runs["debugnans"][0] == runs["plain"][0],
              "--debugnans changed the launches")

        # what the check costs per outer iteration, on the main path
        u0, a0, y, d, Rt = state.from_numpy(*problem32, device=DEV,
                                            dtype=torch.float32)
        kw = dict(n_iter1=NAN_COST_OUTER, n_iter2=N_INNER, tol=0.0)

        def solve(flag):
            enable_nan_debugging(flag)
            try:
                res, ms = timed_ms(lambda: partial_reference_deconv(
                    y, d, Rt, N_U, init_provided=(u0, a0), **kw))
            finally:
                enable_nan_debugging(False)
            return res, ms / NAN_COST_OUTER

        solve(False)                                                # warm
        turns = [solve(flag) for flag in (False, True, True, False)]
        same = all(torch.equal(r.proportions, turns[0][0].proportions)
                   and torch.equal(r.u, turns[0][0].u) for r, _ in turns)
        off = [ms for (_, ms), f in zip(turns, (0, 1, 1, 0)) if not f]
        on = [ms for (_, ms), f in zip(turns, (0, 1, 1, 0)) if f]
        log(f"[debugnans] main path 1M x {N_S}, 5+1, float32, "
            f"{NAN_COST_OUTER}x{N_INNER}, tol=0, card {card}: ms per outer "
            f"iteration off {off[0]:.4f}, on {on[0]:.4f}, on {on[1]:.4f}, off "
            f"{off[1]:.4f}; the same bits: {same}")
        check(same, "--debugnans changed the main path's bits")
        out["ms_iter_off"], out["ms_iter_on"] = off, on

        # an input that gives NaN: the unknown alpha block starts at zero
        rng = np.random.default_rng(14)
        os.makedirs(os.path.join(root, "small"))
        small, small_ref = _write_fixture(os.path.join(root, "small"),
                                          seed=15)
        ckpt = os.path.join(root, "zero-unknown")
        save_factors(ckpt, alpha=np.vstack([
            rng.dirichlet(np.ones(N_CT), size=N_S).T, np.zeros((1, N_S))]),
            cost=np.asarray(1.0), u=rng.uniform(size=(N_CLI, 1)))
        proc = subprocess.run(
            [sys.executable, "-m", "demethify_tpu_torch", "--methfreq",
             *small, "--bedmethyl", "--noprint", "--device", DEV, "--ref",
             small_ref, "--nbunknown", "1", "--iterations", "5", "5",
             "--initstate", ckpt, "--debugnans", "--outdir",
             os.path.join(root, "nan")], capture_output=True, text=True,
            timeout=600, cwd=HERE)
        last = (proc.stderr.strip().splitlines() or [""])[-1]
        log(f"[debugnans] NaN input (zero unknown alpha block) on the card: "
            f"exit {proc.returncode}, {last}")
        check(proc.returncode != 0 and "FloatingPointError" in proc.stderr,
              "the NaN input did not fail with FloatingPointError")
    return out


def phase_feature_selection(card):
    """``preprocessing.feature_selection.scores`` at SELECT_ROWS x
    SELECT_COLS on the card (float32, its device path) by variance and by
    SVD leverage, timed (the device work with CUDA events, the whole call
    with its copies on the host clock), held to numpy float64 on the host:
    variance scores within 1e-5 relative each, SVD scores within 1e-4 of
    the largest; the rows kept (SELECT_KEEP) equal the host's wherever the
    score gap at the cut exceeds that tolerance. The columns are cell
    types with distinct spreads (uniform values scaled by 1 down to 0.3),
    so the singular values are distinct. On i.i.d. columns, whose
    spectrum is near-degenerate, the float32 Gram path's leverage scores
    are ill-conditioned: their distance to float64 there is printed, not
    held."""
    import torch

    from demethify_tpu_torch.ops.tall_svd import tall_svd
    from demethify_tpu_torch.preprocessing.feature_selection import (
        rank_rows, scores)

    rng = np.random.default_rng(16)
    iid = rng.uniform(size=(SELECT_ROWS, SELECT_COLS))
    values = iid * np.linspace(1.0, 0.3, SELECT_COLS)
    x = torch.as_tensor(values, dtype=torch.float32, device=DEV)
    out = {}
    for method in ("var", "svd"):
        t0 = time.perf_counter()
        got = scores(values, SELECT_KEEP, method, device=DEV)
        call_s = time.perf_counter() - t0
        if method == "var":
            dev_ms = median_ms(lambda: torch.var(x, dim=1, correction=1),
                               reps=5)
            want = values.var(axis=1, ddof=1)
            err = float(np.max(np.abs(got - want) / np.abs(want)))
            tol, extra = 1e-5, ""
        else:
            dev_ms = median_ms(lambda: torch.sum(torch.abs(
                tall_svd(x)[0][:, :SELECT_KEEP]), dim=1), reps=5)

            def leverage(v):
                U, _, _ = np.linalg.svd(v, full_matrices=False)
                return np.abs(U[:, :SELECT_KEEP]).sum(axis=1)
            want = leverage(values)
            err = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
            tol = 1e-4
            want_iid = leverage(iid)
            err_iid = float(np.max(np.abs(
                scores(iid, SELECT_KEEP, method, device=DEV) - want_iid))
                / np.max(want_iid))
            extra = (f"; on i.i.d. uniform columns (near-degenerate "
                     f"spectrum, not held) {err_iid:.3e}")
            out["svd_iid_err"] = err_iid
        cut = np.sort(want)[::-1]
        gap = float(cut[SELECT_KEEP - 1] - cut[SELECT_KEEP])
        same_rows = set(rank_rows(got, SELECT_KEEP, method).tolist()) == set(
            rank_rows(want, SELECT_KEEP, method).tolist())
        log(f"[select] {method} scores at {SELECT_ROWS} x {SELECT_COLS}, "
            f"float32 on the card {card}: device {dev_ms:.4f} ms (CUDA "
            f"events), the whole call with its copies {call_s * 1e3:.1f} ms "
            f"(host clock); vs numpy float64 "
            f"{'rel' if method == 'var' else 'of the largest'} {err:.3e} "
            f"(tol {tol:.0e}){extra}; score gap at the cut {gap:.3e}, the "
            f"same {SELECT_KEEP} rows: {same_rows}")
        check(got.dtype == np.float32, "the device path is not float32")
        check(err <= tol, f"{method} scores differ from numpy by {err}")
        check(same_rows or gap <= tol * float(np.max(np.abs(want))),
              f"{method}: other rows kept at a gap of {gap}")
        out[method] = {"device_ms": dev_ms, "call_ms": call_s * 1e3,
                       "err": err}
    return out


def _read_props(path):
    h, rows = _read_csv(os.path.join(path, "celltypes_proportions.csv"))
    return [r[0] for r in rows], np.array([[float(v) for v in r[1:]]
                                           for r in rows])


def phase_pipeline(card):
    """The tools in the order a user runs them: ``simulate`` 10 samples
    from a seeded PIPE_REF-row reference of PIPE_TYPES cell types (5
    known, one unknown component), ``feature_selection`` of PIPE_KEEP
    rows of its reference, ``intersect`` of the selected reference with
    the samples, then the CLI's deconvolution of the intersected files on
    the card and with ``--device cpu`` (float64, ``--init SVD``: no
    random draw, so the two solve the same problem), held within 1e-6.
    ``--plot``: where matplotlib is not installed the CLI exits non-zero
    naming it before it reads any data; where it is installed the three
    figure families are written."""
    from demethify_tpu_torch.cli import main as cli_main
    from demethify_tpu_torch.io.table import write_table
    from demethify_tpu_torch.preprocessing.feature_selection import (
        feature_select)
    from demethify_tpu_torch.preprocessing.intersect import (
        intersect_bed_files)
    from demethify_tpu_torch.simulate import generate_dataset

    rng = np.random.default_rng(17)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        pos = np.arange(PIPE_REF) * 100
        ref_bed = write_table(
            os.path.join(root, "atlas.bed"),
            ["chrom", "start", "end"] + [f"type{k}" for k in
                                         range(PIPE_TYPES)],
            [np.array(["chr1"] * PIPE_REF, dtype=object), pos, pos + 2]
            + list(rng.beta(0.5, 0.5, size=(PIPE_TYPES, PIPE_REF))))
        portion = np.linspace(0.05, 0.3, N_S)
        sim = generate_dataset(ref_bed, os.path.join(root, "sim"),
                               nb_samples=N_S, nb_known=N_CT,
                               unknown_portion=portion, seed=18)
        t_sim = time.perf_counter() - t0
        t0 = time.perf_counter()
        sel = feature_select(sim["ref"], PIPE_KEEP, os.path.join(root, "sel"),
                             "svd")
        t_sel = time.perf_counter() - t0
        t0 = time.perf_counter()
        files = intersect_bed_files([sel, *sim["samples"]],
                                    os.path.join(root, "int"))
        t_int = time.perf_counter() - t0
        common = ["--methfreq", *files[1:], "--ref", files[0],
                  "--bedmethyl", "--noprint", "--init", "SVD",
                  "--iterations", "200", "20", "--dtype", "float64"]
        base = common + ["--nbunknown", "1"]
        outs = {}
        for device in (DEV, "cpu"):
            outs[device] = os.path.join(root, f"deconv-{device}")
            t0 = time.perf_counter()
            check(cli_main(base + ["--device", device, "--outdir",
                                   outs[device]]) == 0, f"CLI {device}")
            log(f"[pipeline] deconvolution --device {device}: "
                f"{time.perf_counter() - t0:.1f} s")
        (names, card_p), (_, cpu_p) = (_read_props(outs[k])
                                      for k in (DEV, "cpu"))
        err = float(np.max(np.abs(card_p - cpu_p)))
        with open(sim["proportions"]) as f:
            truth = np.array([[float(v) for v in ln.split("\t")[1:]]
                              for ln in f.read().splitlines()[1:]])
        rmse = float(np.sqrt(np.mean((card_p - truth) ** 2)))
        n_rows = sum(1 for _ in open(files[0])) - 1
        log(f"[pipeline] simulate {N_S} samples from a {PIPE_REF}-row "
            f"reference {t_sim:.1f} s, select {PIPE_KEEP} rows (svd) "
            f"{t_sel:.1f} s, intersect 11 files ({n_rows} rows) "
            f"{t_int:.1f} s; deconvolution card vs CPU (float64, --init SVD, "
            f"200x20): proportions max|diff| {err:.3e} (tol 1e-6); RMSE to "
            f"the simulated truth {rmse:.4f} (reported, not held); cell "
            f"types {names}")
        check(n_rows == PIPE_KEEP, f"intersect kept {n_rows} rows")
        check(err <= 1e-6, f"pipeline card vs CPU {err}")

        plot_dir = os.path.join(root, "plot")
        try:
            import matplotlib  # noqa: F401
            has_mpl = True
        except ImportError:
            has_mpl = False
        argv = base + ["--device", DEV, "--outdir", plot_dir, "--plot"]
        if not has_mpl:
            t0 = time.perf_counter()
            try:
                cli_main(argv)
                code = 0
            except SystemExit as e:
                code = e.code
            log(f"[pipeline] --plot without matplotlib: exit {code!r} after "
                f"{time.perf_counter() - t0:.2f} s, no output directory: "
                f"{not os.path.exists(plot_dir)}")
            check(code not in (0, None) and "matplotlib" in str(code)
                  and not os.path.exists(plot_dir),
                  "--plot without matplotlib did not stop before the data")
        else:
            check(cli_main(common + ["--device", DEV, "--outdir", plot_dir,
                                     "--plot", "--ic", "AIC", "--icmax",
                                     "2"]) == 0, "CLI --plot")
            made = sorted(os.listdir(os.path.join(plot_dir, "plots")))
            log(f"[pipeline] --plot wrote {made}")
            check("ic_plot.png" in made
                  and "proportions_stackedbar.png" in made
                  and len(made) == N_S + 2, f"--plot files {made}")
    return {"err": err, "rmse": rmse}


def layout_worker(out_dir, store, n_procs, proc_id, n_local, local_id):
    """One worker of ``phase_layout``'s API run: on its share of the
    N_2D x 10 problem (float64) the plain partial-reference solve
    row-sharded over the world (LAYOUT_OUTER x 20, tol = 0) and the
    weights bootstrap (B = LAYOUT_BOOT, LAYOUT_BOOT_OUTER x 20) with the
    replicates over ``across`` and each row-sharded over ``rows``, and the
    ``--ic CCC`` sweep (LAYOUT_CCC, LAYOUT_CCC_OUTER x 20) the same way,
    each with the counters at 0 just before and read just after, timed
    with CUDA events past a 1-iteration call's fixed cost. Saves
    out_dir/worker<rank>.json."""
    import torch

    from demethify_tpu_torch.parallel.distributed import (
        Shard, initialize_layout, shard_dataset_global, shutdown)
    from demethify_tpu_torch.selection.sweep import evaluate_best_ic
    from demethify_tpu_torch.solvers.api import partial_reference_deconv
    from demethify_tpu_torch.uncertainty.bootstrap import bootstrap_ci

    layout, device = initialize_layout(store, n_procs, proc_id, n_local,
                                       local_id, DEV)
    try:
        u0, a0, y, d, Rt = make_problem(np.float64, seed=19, n_cpg=N_2D)

        def shard_on(axis):
            block, *yd = shard_dataset_global(
                y, d, Rt, axis, lambda x: torch.as_tensor(x, device=device))
            return yd, Shard(axis, block)

        def run(call, n_outer):
            """(result, launches, fixed ms, ms an outer iteration past the
            first): one warm-up and one timed 1-iteration call, then the
            counted n_outer-iteration call."""
            call(1)
            _, fixed = timed_ms(lambda: call(1))
            reset_counts()
            out, ms = timed_ms(lambda: call(n_outer))
            return (out, {k: v for k, v in read_counts().items() if v},
                    fixed, (ms - fixed) / (n_outer - 1))

        res = {}
        (yw, dw, rw), sw = shard_on(layout.world)
        init = tuple(torch.as_tensor(x, device=device)
                     for x in (sw.block.take(u0), a0))
        out, launches, fixed, further = run(
            lambda n: partial_reference_deconv(
                yw, dw, rw, N_U, init_provided=init, shard=sw, n_iter1=n,
                n_iter2=N_INNER, tol=0.0), LAYOUT_OUTER)
        res["solve"] = {"ms_iter": further, "fixed_ms": fixed,
                        "launches": launches,
                        "alpha": out.proportions.cpu().numpy().tolist()}
        (yr, dr, rr), sr = shard_on(layout.rows)
        (lo_p, hi_p, _, _), launches, fixed, further = run(
            lambda n: bootstrap_ci(
                yr, dr, rr, N_U, level=90, n_bootstrap=LAYOUT_BOOT,
                n_iter1=n, n_iter2=N_INNER, tol=0.0, seed=20,
                method="weights", axis=layout.across, shard=sr),
            LAYOUT_BOOT_OUTER)
        res["boot"] = {"ms_iter": further, "fixed_ms": fixed,
                       "launches": launches,
                       "lo": lo_p.tolist(), "hi": hi_p.tolist()}
        (_, alpha, n_u, _), launches, fixed, further = run(
            lambda n: evaluate_best_ic(
                yr, dr, rr, "uniform_", "CCC", iter1=n, axis=layout.across,
                shard=sr, **LAYOUT_CCC), LAYOUT_CCC_OUTER)
        res["ccc"] = {"ms_iter": further, "fixed_ms": fixed,
                      "launches": launches, "n_u": n_u,
                      "alpha": alpha.cpu().numpy().tolist()}
        res["layout"] = [[a.rank, a.size, a.backend] for a in (
            layout.world, layout.rows, layout.across)]
        with open(os.path.join(out_dir,
                               f"worker{layout.world.rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        shutdown(layout.world)
    return 0


def phase_layout(card):
    """The 2-D layout on the one card: LAYOUT_PROCS processes x
    LAYOUT_LOCAL workers over gloo, at N_2D x 10, 5 + 1, float64.

    The CLI (each process ``--multihost ADDR 2 ID --shard``, its workers
    started by the worker launcher) against the one-process CLI within
    1e-8: the plain solve with the weights bootstrap (LAYOUT_OUTER x 20,
    B = LAYOUT_BOOT: proportions, intervals, the part files of the four
    workers) and ``--ic AIC --init SVD --icmax 3`` (20 x 10: the same
    number of unknowns, proportions and profile). Then the same routes
    and the ``--ic CCC`` sweep through the API in ``layout_worker``
    processes, for each worker's ms per outer iteration and launches (one
    per kernel and outer iteration: K1 + K2 for the solve, K4 + K5 for the
    bootstrap's replicates, K4 + K5 twice for CCC: its rank's restarts and
    the winner's), every worker with the same bits, CCC's against the
    one-process sweep within 1e-8 with the same rank."""
    import torch

    from demethify_tpu_torch import state
    from demethify_tpu_torch.cli import main as cli_main
    from demethify_tpu_torch.parallel.distributed import run_ranks
    from demethify_tpu_torch.selection.sweep import evaluate_best_ic

    n_workers = LAYOUT_PROCS * LAYOUT_LOCAL
    out = {}
    with tempfile.TemporaryDirectory() as root:
        samples, ref = _write_fixture(root, seed=21, n=N_2D)
        base = ["--methfreq", *samples, "--bedmethyl", "--noprint",
                "--device", DEV, "--dtype", "float64", "--ref", ref]
        for tag, extra in (
                ("solve + weights bootstrap", [
                    "--nbunknown", "1", "--iterations", str(LAYOUT_OUTER),
                    str(N_INNER), "--confidence", "90", str(LAYOUT_BOOT),
                    "--cimethod", "weights"]),
                ("ic", ["--ic", "AIC", "--init", "SVD", "--icmax", "3",
                        "--iterations", "20", "10"])):
            key = tag.split()[0]
            one, two = (os.path.join(root, f"{key}-{k}")
                        for k in ("one", "2d"))
            t0 = time.perf_counter()
            check(cli_main(base + extra + ["--outdir", one]) == 0,
                  f"CLI {tag}: one process")
            t_one = time.perf_counter() - t0
            store = "file://" + os.path.join(root, f"{key}-store")
            t0 = time.perf_counter()
            codes = run_ranks(
                [[sys.executable, "-c", LAUNCH_2D, str(LAYOUT_LOCAL), *base,
                  *extra, "--outdir", two, "--multihost", store,
                  str(LAYOUT_PROCS), str(p), "--shard"]
                 for p in range(LAYOUT_PROCS)], 900, cwd=HERE)
            t_two = time.perf_counter() - t0
            check(codes == [0] * LAYOUT_PROCS, f"2-D CLI {tag}: {codes}")
            (_, p1), (_, p2) = _read_props(one), _read_props(two)
            err = float(np.max(np.abs(p1 - p2)))
            msg = (f"[layout] CLI {tag}, {LAYOUT_PROCS} x {LAYOUT_LOCAL} "
                   f"workers vs one process, {N_2D} x {N_S}, float64: "
                   f"proportions max|diff| {err:.3e}")
            if key == "ic":
                logs = [open(os.path.join(o, "log.log")).read().splitlines()
                        for o in (one, two)]
                check(logs[0][1] == logs[1][1], f"--ic chose {logs}")
                _, u1 = _read_csv(os.path.join(
                    one, "methylation_profile_estimate.csv"))
                _, u2 = _read_csv(os.path.join(
                    two, "methylation_profile_estimate.csv"))
                err_u = float(np.max(np.abs(np.array(u1, float)
                                            - np.array(u2, float))))
                msg += f", profile {err_u:.3e}; {logs[1][1]}"
            else:
                _, u1 = _read_csv(os.path.join(
                    one, "methylation_profile_estimate.csv"))
                _, u2 = _parts(two, n_workers)
                err_u = float(np.max(np.abs(np.array(u1, float) - u2)))
                msg += f", part files vs the profile {err_u:.3e}"
                for name, index in (
                        ("confidence_interval_celltypes_proportions.csv",
                         True),
                        ("confidence_interval_methylation_estimate.csv",
                         False)):
                    lo1, hi1 = _read_ci(os.path.join(one, name), index)
                    lo2, hi2 = _read_ci(os.path.join(two, name), index)
                    e = float(max(np.max(np.abs(lo1 - lo2)),
                                  np.max(np.abs(hi1 - hi2))))
                    err_u = max(err_u, e)
                    msg += f", {name} {e:.3e}"
            log(f"{msg} (tol 1e-8); wall one {t_one:.1f} s, 2-D "
                f"{t_two:.1f} s")
            check(max(err, err_u) <= 1e-8, f"2-D CLI {tag} differs")

        t0 = time.perf_counter()
        store = "file://" + os.path.join(root, "api-store")
        codes = run_ranks(
            [[sys.executable, os.path.join(HERE, "chip_smoke.py"),
              "--layout-worker", root, store, str(LAYOUT_PROCS), str(p),
              str(LAYOUT_LOCAL), str(i)]
             for p in range(LAYOUT_PROCS) for i in range(LAYOUT_LOCAL)],
            900, [dict(os.environ, LOCAL_RANK=str(i))
                  for _ in range(LAYOUT_PROCS) for i in range(LAYOUT_LOCAL)],
            cwd=HERE)
        check(codes == [0] * n_workers, f"layout workers exited {codes}")
        workers = []
        for r in range(n_workers):
            with open(os.path.join(root, f"worker{r}.json")) as f:
                workers.append(json.load(f))
        for route in ("solve", "boot", "ccc"):
            keys = ("lo", "hi") if route == "boot" else ("alpha", )
            check(all(w[route][k] == workers[0][route][k] for w in workers
                      for k in keys), f"2-D {route}: workers differ")
        # the one-process CCC sweep on the same problem
        full = state.from_numpy(*make_problem(np.float64, seed=19,
                                              n_cpg=N_2D),
                                device=DEV, dtype=torch.float64)
        _, alpha1, n_u1, _ = evaluate_best_ic(
            *full[2:], "uniform_", "CCC", iter1=LAYOUT_CCC_OUTER,
            **LAYOUT_CCC)
        err = float(np.max(np.abs(alpha1.cpu().numpy()
                                  - np.array(workers[0]["ccc"]["alpha"]))))
        log(f"[layout] API --ic CCC ({LAYOUT_CCC['n_restarts']} restarts, "
            f"ranks 1-{LAYOUT_CCC['n_u_max']}), 2 x 2 workers vs one "
            f"process: n_u {workers[0]['ccc']['n_u']} vs {n_u1}, "
            f"proportions max|diff| {err:.3e} (tol 1e-8)")
        check(workers[0]["ccc"]["n_u"] == n_u1 and err <= 1e-8,
              "2-D CCC differs from one process")
        want = {"solve": dict(u_phase_grams=LAYOUT_OUTER,
                              alpha_phase_full=LAYOUT_OUTER),
                "boot": dict(u_phase_grams_multi=LAYOUT_BOOT_OUTER,
                             alpha_phase_full_multi=LAYOUT_BOOT_OUTER),
                "ccc": dict(u_phase_grams_multi=2 * LAYOUT_CCC_OUTER,
                            alpha_phase_full_multi=2 * LAYOUT_CCC_OUTER)}
        for route in ("solve", "boot", "ccc"):
            per = [w[route]["launches"] for w in workers]
            ms = [w[route]["ms_iter"] for w in workers]
            fixed = [w[route]["fixed_ms"] for w in workers]
            log(f"[layout] API {route} on {n_workers} workers "
                f"({LAYOUT_PROCS} x {LAYOUT_LOCAL}, gloo, card {card}), "
                f"{N_2D} x {N_S}, float64, tol=0: ms an outer iteration "
                f"past the first {[round(m, 4) for m in ms]} (CUDA events), "
                f"a 1-iteration call {[round(m, 1) for m in fixed]} ms; "
                f"launches per worker {per}; layouts "
                f"{[w['layout'] for w in workers]}")
            for p in per:
                check(all(p.get(k, 0) == v for k, v in want[route].items())
                      and set(p) == set(want[route]),
                      f"2-D {route} launches {p}, want {want[route]}")
            out[route] = {"ms_iter": ms, "fixed_ms": fixed,
                          "launches": per}
        log(f"[layout] every worker ended with the same bits; API run "
            f"{time.perf_counter() - t0:.1f} s")
    return out


# ------------------------------------------- phase 14: row-distributed set-up
# the cohort's widths at 4M rows, float32, 2 ranks on the one card (gloo)
ROW_N, ROW_S, ROW_CT, ROW_U = 4_000_000, 100, 25, 4
ROW_CHUNK, ROW_SEED, ROW_RANKS = 250_000, 23, 2
# outer iterations of the solve after each init (x N_INNER), the weights
# bootstrap's chunk and the CCC rank's restarts
ROW_OUTER, ROW_BOOT, ROW_CCC_RESTARTS = 3, 8, 3
ROW_INITS = ("uniform_", "uniform", "SVD", "ICA")
# 2 ranks against one, float32 (every sum over the rows adds the ranks'
# partials in another order): the draws bit for bit; a WLS fit (the
# 'uniform' init, the supervised proportions, the SVD and ICA inits'
# known block) to 1e-3 of the largest entry (float32 Grams over 2M-row
# halves, through the NNLS polish's solve); the SVD init's factors to
# 1e-3 (its top singular vectors are well apart); the solves, the
# bootstrap's intervals and the CCC rank's alpha to TRAJ_TOL's float32
# alpha bound; ICA in float32 is decided by rounding (its whitened null
# direction scales float32 rounding; tests/test_torch_svd_ica.py), so it
# is held through its parts: the basis B and S = B'X reconstruct the
# residual to 1e-4 of its norm on every rank, and the init lies on its
# supports (profiles in [0, 1], alpha on the simplex).
ROW_TOL = {"wls": 1e-3, "svd": 1e-3, "solve": TRAJ_TOL["float32"]["alpha"],
           "cost": 1e-5, "ica_parts": 1e-4}
# rank 0's peak device memory against rank 1's, each route
ROW_PEAK_RATIO = 1.15


def row_problem(block, n_rows, device):
    """This rank's rows of the phase's problem, float32 on ``device``:
    (y, d, R) made chunk by chunk of ROW_CHUNK rows, each from its own
    generator seeded by (ROW_SEED, chunk), so that a rank makes only the
    chunks its rows lie in and any layout holds the same rows; padded
    rows zero. 25 known and 4 unknown profiles U(0, 1), one alpha a
    sample from Dirichlet(1) (ROW_SEED), y = clip([R U] alpha + 0.01 N,
    0, 1), coverage Poisson(30) + 1."""
    import torch

    f32 = torch.float32
    alpha = torch.as_tensor(np.random.default_rng(ROW_SEED).dirichlet(
        np.ones(ROW_CT + ROW_U), size=ROW_S).T, dtype=f32, device=device)
    m = block.stop - block.start
    lo, hi = block.start, min(block.stop, n_rows)
    y = torch.zeros((m, ROW_S), dtype=f32, device=device)
    d = torch.zeros((m, ROW_S), dtype=f32, device=device)
    R = torch.zeros((m, ROW_CT), dtype=f32, device=device)
    for c in range(lo // ROW_CHUNK, -(-hi // ROW_CHUNK)):
        c0, c1 = c * ROW_CHUNK, min((c + 1) * ROW_CHUNK, n_rows)
        g = torch.Generator(device=device)
        g.manual_seed(int(np.random.SeedSequence(
            ROW_SEED, spawn_key=(c,)).generate_state(1, np.uint64)[0] >> 1))
        rc = torch.rand((c1 - c0, ROW_CT + ROW_U), generator=g, dtype=f32,
                        device=device)
        noise = torch.randn((c1 - c0, ROW_S), generator=g, dtype=f32,
                            device=device)
        dc = torch.poisson(torch.full((c1 - c0, ROW_S), 30.0, dtype=f32,
                                      device=device), generator=g) + 1.0
        a, b = max(c0, lo), min(c1, hi)
        y[a - lo:b - lo] = torch.clamp(rc[a - c0:b - c0] @ alpha
                                       + 0.01 * noise[a - c0:b - c0], 0, 1)
        d[a - lo:b - lo] = dc[a - c0:b - c0]
        R[a - lo:b - lo] = rc[a - c0:b - c0, :ROW_CT]
    return y, d, R


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ica_parts(y, d, R, shard):
    """(max |B S - X| / max |X|, S) of the ICA init's dual basis on this
    rank's rows: X the clipped residual of the known block's row-sharded
    WLS (padded rows zero), B its tall-SVD basis, S = B'X summed over the
    ranks."""
    import torch

    from demethify_tpu_torch.ops.nnls import wls_intercept_batch
    from demethify_tpu_torch.ops.tall_svd import tall_svd
    from demethify_tpu_torch.parallel.distributed import axis_of

    axis = axis_of(shard)
    H1 = wls_intercept_batch(y, d, R, axis=axis)
    X = torch.clamp_min(y - R @ H1, 1e-8)
    if shard is not None:
        X = shard.data_rows(X)
    B = tall_svd(X, axis)[0]
    S = axis.sum_(B.T @ X)
    err = axis.max_(torch.max(torch.abs(B @ S - X)))
    scale = axis.max_(torch.max(torch.abs(X)))
    return float(err / scale), S


def row_routes(axis, block, n_rows, device):
    """The phase's routes on this rank's rows (``axis`` LOCAL with every
    row: the one-rank run), each with the counters at 0 and the peak
    device memory reset just before: the partial-reference inits of
    ROW_INITS, each followed by ROW_OUTER x N_INNER of the row-sharded
    solve from it (K1 + K2); the supervised WLS; one weights-bootstrap
    chunk of ROW_BOOT replicates with uniform_ inits (K4 + K5); one CCC
    sweep rank (1 unknown, ROW_CCC_RESTARTS restarts, K4 + K5). ->
    ({route: {arrays: {...}, init_ms, ms, peak_bytes, launches}}, the
    bytes of this rank's Y, D and R)."""
    import torch

    from demethify_tpu_torch.parallel.distributed import Shard
    from demethify_tpu_torch.selection.sweep import evaluate_best_ic
    from demethify_tpu_torch.solvers import api, init
    from demethify_tpu_torch.uncertainty.bootstrap import bootstrap_ci

    y, d, R = row_problem(block, n_rows, device)
    shard = Shard(axis, block) if axis.size > 1 else None
    data_bytes = sum(x.numel() * x.element_size() for x in (y, d, R))
    n_data = block.n_data
    solve_kw = dict(n_iter1=ROW_OUTER, n_iter2=N_INNER, tol=0.0)
    on_card = device.type == "cuda"
    out = {}

    def host(x):
        return x.detach().cpu().numpy()

    def route(name, make, follow=None):
        """make() timed (the init), then follow(made) (the solve), with
        the counters and the peak memory over both."""
        _sync(device)
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        reset_counts()
        t0 = time.perf_counter()
        made = make()
        _sync(device)
        init_ms = (time.perf_counter() - t0) * 1e3
        arrays = follow(made) if follow else made
        _sync(device)
        out[name] = dict(
            arrays=arrays, init_ms=init_ms,
            ms=(time.perf_counter() - t0) * 1e3,
            peak_bytes=(torch.cuda.max_memory_allocated(device) if on_card
                        else 0),
            launches={k: v for k, v in read_counts().items() if v})

    # one draw first, so that no route's time holds the first launch of
    # the draws' kernels
    init.init_partial(torch.Generator(device=device), "uniform_", y, d, R,
                      ROW_U, shard=shard)
    for option in ROW_INITS:
        def make(option=option):
            g = torch.Generator(device=device)
            g.manual_seed(ROW_SEED)
            return init.init_partial(g, option, y, d, R, ROW_U, shard=shard)

        def follow(u0a0):
            res = api.partial_reference_deconv(
                y, d, R, ROW_U, init_provided=u0a0, shard=shard, **solve_kw)
            return {"u0": host(u0a0[0][:n_data]), "a0": host(u0a0[1]),
                    "alpha": host(res.proportions),
                    "cost": np.asarray(res.cost)}
        route(f"init {option}", make, follow)
    err, S = _ica_parts(y, d, R, shard)
    out["init ICA"]["arrays"].update(parts_err=np.asarray(err), S=host(S))
    route("supervised", lambda: api.supervised_deconv(y, d, R, axis=axis),
          lambda res: {"alpha": host(res.proportions),
                       "cost": np.asarray(res.cost)})
    route("weights bootstrap", lambda: bootstrap_ci(
        y, d, R, ROW_U, level=90, n_bootstrap=ROW_BOOT, seed=ROW_SEED,
        method="weights", shard=shard, **solve_kw),
        lambda ci: {"props": np.stack(ci[:2]),
                    "u_bounds": np.stack(ci[2:])[:, :n_rows]})
    route("CCC rank", lambda: evaluate_best_ic(
        y, d, R, "uniform_", "CCC", seed=ROW_SEED, iter1=ROW_OUTER,
        iter2=N_INNER, tol=0.0, n_restarts=ROW_CCC_RESTARTS, n_u_max=1,
        shard=shard),
        lambda res: {"u": host(res[0][:n_data]), "alpha": host(res[1]),
                     "list": np.asarray(res[3])})
    return out, data_bytes


def row_init_worker(out_dir, store, n_ranks, rank, device_name, n_rows):
    """One rank of ``phase_row_init``: ``row_routes`` on its block, saved
    to out_dir/rowRANK.npz (arrays) and .json (times, memory, launches)."""
    from demethify_tpu_torch.parallel.distributed import (
        initialize_layout,
        shutdown,
    )
    from demethify_tpu_torch.parallel.mesh import row_block

    layout, device = initialize_layout(store, n_ranks, rank,
                                       device_name=device_name)
    axis = layout.world
    try:
        res, data_bytes = row_routes(axis, row_block(n_rows, n_ranks, rank),
                                     n_rows, device)
        np.savez(os.path.join(out_dir, f"row{rank}.npz"),
                 **{f"{name}/{k}": v for name, r in res.items()
                    for k, v in r["arrays"].items()})
        with open(os.path.join(out_dir, f"row{rank}.json"), "w") as f:
            json.dump({"backend": axis.backend, "device": str(device),
                       "data_bytes": data_bytes,
                       "routes": {name: {k: r[k] for k in (
                           "init_ms", "ms", "peak_bytes", "launches")}
                           for name, r in res.items()}}, f)
    finally:
        shutdown(axis)
    return 0


def _row_err(got, want):
    """max |got - want| / max(1, max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return np.inf
    return float(np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want))))


def phase_row_init(card, n_rows=ROW_N, device_name=DEV):
    """The row-distributed set-up of a row-sharded run: ROW_RANKS ranks on
    the one card (processes of this script, ``--row-init-worker``, over
    gloo), each making only its rows of the ROW_N x ROW_S problem (25 + 4,
    float32), against the one-rank run of the same routes in this process
    (``row_routes``): the inits uniform_ (its draws bit for bit), uniform,
    SVD and ICA (dual: above 4096 rows) and the row-sharded solve after
    each, the supervised WLS, one weights-bootstrap chunk and one CCC
    sweep rank, at ROW_TOL; every rank with the same bits of what is
    replicated; each rank's peak device memory beside its rows' bytes of
    Y, D and R, rank 0's within ROW_PEAK_RATIO of rank 1's; the launches
    of each rank one per kernel and outer iteration (K1 + K2 after the
    inits, K4 + K5 for the bootstrap chunk and the CCC rank). Returns
    {route: launches per rank}."""
    import gc

    import torch

    from demethify_tpu_torch.parallel.distributed import LOCAL
    from demethify_tpu_torch.parallel.mesh import row_block

    device = torch.device(device_name)
    on_card = device.type == "cuda"
    t0 = time.perf_counter()
    one, one_bytes = row_routes(LOCAL, row_block(n_rows, 1, 0), n_rows,
                                device)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_one = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as root:
        store = "file://" + os.path.join(root, "store")
        t0 = time.perf_counter()
        _run_rank_processes([[os.path.join(HERE, "chip_smoke.py"),
                              "--row-init-worker", root, store,
                              str(ROW_RANKS), str(r), device_name,
                              str(n_rows)] for r in range(ROW_RANKS)], 900)
        t_ranks = time.perf_counter() - t0
        ranks = [dict(np.load(os.path.join(root, f"row{r}.npz")))
                 for r in range(ROW_RANKS)]
        meta = []
        for r in range(ROW_RANKS):
            with open(os.path.join(root, f"row{r}.json")) as f:
                meta.append(json.load(f))
    log(f"[row init] {ROW_RANKS} ranks on {[m['device'] for m in meta]} "
        f"(card {card}), sums by {meta[0]['backend']}, {n_rows} x {ROW_S}, "
        f"{ROW_CT} + {ROW_U}, float32: the one-rank routes took {t_one:.1f} "
        f"s, the rank processes {t_ranks:.1f} s; Y, D, R bytes one rank "
        f"{one_bytes / 1e9:.3f} GB, per rank "
        f"{[round(m['data_bytes'] / 1e9, 3) for m in meta]} GB")

    def joined(key):
        """A result over the ranks: row arrays concatenated in rank
        order, a replicated one from rank 0 (after checking every rank
        holds its bits)."""
        if key.split("/")[1] in ("u0", "u"):
            return np.concatenate([r[key] for r in ranks])
        for r in ranks[1:]:
            check(np.array_equal(r[key], ranks[0][key], equal_nan=True),
                  f"[row init] ranks disagree on {key}")
        return ranks[0][key]

    want_launches = {"supervised": {}}
    for name in one:
        if name.startswith("init"):
            want_launches[name] = {"u_phase_grams": ROW_OUTER,
                                   "alpha_phase_full": ROW_OUTER}
        elif name in ("weights bootstrap", "CCC rank"):
            want_launches[name] = {"u_phase_grams_multi": ROW_OUTER,
                                   "alpha_phase_full_multi": ROW_OUTER}
    out = {}
    for name, ref in one.items():
        want = ref["arrays"]
        errs = {k: _row_err(joined(f"{name}/{k}"), v)
                for k, v in want.items() if k not in ("parts_err", "S")}
        if name == "init uniform_":
            check(all(np.array_equal(joined(f"{name}/{k}"), want[k])
                      for k in ("u0", "a0")),
                  "[row init] uniform_: the draws differ from one rank's")
            tol = {"u0": 0.0, "a0": 0.0}
        elif name == "init uniform":
            check(np.array_equal(joined(f"{name}/u0"), want["u0"]),
                  "[row init] uniform: u's draw differs from one rank's")
            tol = {"u0": 0.0, "a0": ROW_TOL["wls"]}
        elif name == "init SVD":
            tol = {"u0": ROW_TOL["svd"], "a0": ROW_TOL["svd"]}
        elif name == "init ICA":
            parts = [float(r[f"{name}/parts_err"]) for r in ranks]
            u0, a0 = joined(f"{name}/u0"), joined(f"{name}/a0")
            on_support = (u0.min() >= 0 and u0.max() <= 1 and a0.min() >= 0
                          and np.allclose(a0.sum(0), 1.0, atol=1e-5))
            s_err = _row_err(joined(f"{name}/S"), want["S"])
            log(f"[row init] init ICA parts: |B S - X| / |X| per rank "
                f"{parts} (one rank {float(want['parts_err']):.3e}; tol "
                f"{ROW_TOL['ica_parts']:.0e}), S vs one rank {s_err:.3e} "
                f"(not held: its small singular directions are rounding), "
                f"on its supports {on_support}")
            check(max(parts) <= ROW_TOL["ica_parts"] and on_support,
                  "[row init] ICA: the basis or the supports fail")
            tol = {}
        elif name == "supervised":
            tol = {"alpha": ROW_TOL["wls"]}
            c1, c2 = float(want["cost"]), float(joined(f"{name}/cost"))
            errs["cost"] = abs(c2 - c1) / abs(c1)
            tol["cost"] = ROW_TOL["cost"]
        else:
            tol = {k: ROW_TOL["solve"] for k in want if k != "list"}
        if name.startswith("init") and name != "init ICA":
            tol.update(alpha=ROW_TOL["solve"])
        if name == "CCC rank":
            errs["list"] = float(np.max(np.abs(joined(f"{name}/list")
                                               - want["list"])))
            tol["list"] = 1e-6
        per = [m["routes"][name] for m in meta]
        peaks = [p["peak_bytes"] for p in per]
        launches = [p["launches"] for p in per]
        # each kernel's launches (its layout's form counters, such as
        # ``u_phase_grams{wide}``, count the same launches again)
        kernels = [{k: v for k, v in lc.items() if "{" not in k}
                   for lc in launches]
        log(f"[row init] {name}: 2 ranks vs one "
            f"{ {k: float(f'{v:.3e}') for k, v in errs.items()} } (tol "
            f"{tol}); init ms per rank {[round(p['init_ms'], 1) for p in per]}"
            f" (one rank {ref['init_ms']:.1f}), route ms "
            f"{[round(p['ms'], 1) for p in per]} (one rank {ref['ms']:.1f});"
            f" peak device memory per rank "
            f"{[round(b / 1e9, 3) for b in peaks]} GB (one rank "
            f"{ref['peak_bytes'] / 1e9:.3f}) beside its rows' Y, D, R "
            f"{[round(m['data_bytes'] / 1e9, 3) for m in meta]} GB; "
            f"launches per rank {launches}")
        check(all(errs[k] <= v for k, v in tol.items()),
              f"[row init] {name}: 2 ranks differ from one")
        if on_card:
            check(peaks[0] <= ROW_PEAK_RATIO * peaks[1],
                  f"[row init] {name}: rank 0's peak {peaks[0]} is over "
                  f"{ROW_PEAK_RATIO} x rank 1's {peaks[1]}")
            check(all(lc == want_launches[name] for lc in kernels),
                  f"[row init] {name}: launches {kernels} != "
                  f"{want_launches[name]}")
        out[name] = kernels
    log("[row init] every rank ended with the same bits; no rank held "
        "another's rows")
    return out


# wall seconds of each phase of ``main``
PHASE_TIMES = {}


def run_phase(fn, *args):
    """fn(*args), with its wall seconds logged and kept in PHASE_TIMES."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_TIMES[fn.__name__] = time.perf_counter() - t0
    log(f"[time] {fn.__name__} {PHASE_TIMES[fn.__name__]:.1f} s")
    return out


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
    card = run_phase(phase_device)
    run_phase(phase_build)
    k1 = run_phase(phase_k1)
    k1_bf16, k1_bf16c = run_phase(phase_k1_bf16)
    k2 = run_phase(phase_k2)
    k2_cohort = run_phase(phase_redesign)
    run_phase(phase_redesign_k4k3)
    k3 = run_phase(phase_k3)
    k4, k4_uns, k4_pur = run_phase(phase_k4)
    k5 = run_phase(phase_k5)
    k6 = run_phase(phase_k6)
    k4w, _, _ = run_phase(phase_k4_weighted)
    k4_bf16, k4w_bf16 = run_phase(phase_k4_bf16, k4, k4w)
    k5w = run_phase(phase_k5_weighted)
    k6w = run_phase(phase_k6_weighted)
    run_phase(phase_layouts)
    run_phase(phase_narrow_bits)
    wide = run_phase(phase_wide_kernels)
    partial = run_phase(phase_partial_buffer)
    k1_state, k4_state, state_cases = run_phase(phase_state_cols)
    glue = run_phase(phase_wide_glue)
    glob = run_phase(phase_global_kernels)
    col_rows = run_phase(phase_column_rows)
    masks = run_phase(phase_masks)
    folded = run_phase(phase_rt_folded)
    k1_bf16c_direct = run_phase(phase_bf16c_direct, card)
    run_phase(phase_solver_trajectory)
    run_phase(phase_bf16_solvers)
    identical = run_phase(phase_multi_solvers)
    run_phase(phase_weighted_solvers)
    run_phase(phase_bootstrap_parity)
    run_phase(phase_bootstrap_direct)
    problem32 = make_problem(np.float32, seed=0)
    launches, main_ms = run_phase(phase_main_path, problem32, card)
    p_launches, _, _ = run_phase(phase_purity_path, problem32, card)
    run_phase(phase_unsupervised_path, problem32, card)
    restarts = run_phase(phase_restarts, problem32, card, {
        "partial-ref": k4["ms"], "purity": k4_pur["ms"],
        "unsupervised": k4_uns["ms"]})
    boot = run_phase(phase_bootstrap, problem32, card)
    bf16 = run_phase(phase_bf16_paths, problem32, card)
    mask_paths = run_phase(phase_mask_paths, card)
    env = run_phase(phase_envelope_paths, card)
    cohort = run_phase(phase_cohort, card)
    single = run_phase(phase_single_phase_kernels, card, main_ms)
    run_phase(phase_cli)
    past = run_phase(phase_past_envelope, card)
    run_phase(phase_inits, card)
    sweep = run_phase(phase_sweep, problem32, card)
    run_phase(phase_cli_inits_ic)
    ranks = run_phase(phase_ranks, card)
    run_phase(phase_ranks_cli)
    obs = run_phase(phase_observability, problem32, card)
    run_phase(phase_feature_selection, card)
    run_phase(phase_pipeline, card)
    layout = run_phase(phase_layout, card)
    row_init = run_phase(phase_row_init, card)
    log("[time] the longest phases: " + ", ".join(
        f"{name} {t:.1f} s" for name, t in sorted(
            PHASE_TIMES.items(), key=lambda kv: -kv[1])[:12]))
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
         "bound_by": k1_b[1], "library_ms": None,
         "redesigned": "momentum table once per launch; Gram stage in "
                       "register micro-tiles above 128 entries a block; "
                       "cp.async staging"},
        {"name": "alpha_phase_full", "route": "cuda",
         "source": "demethify_tpu_torch/csrc/alpha_phase_full.cu",
         "replaces": "demethify_tpu/ops/pallas_small.py:261",
         "launches": launches["alpha_phase_full"],
         "max_abs_err": k2["alpha_max_abs"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2_b[0],
         "bound_by": k2_b[1], "library_ms": None,
         "redesigned": "collectives to a row bucket P >= p; a warp per "
                       "column over several blocks; momentum table"},
        {"name": "alpha_phase_full{cohort}", "route": "cuda",
         "source": "demethify_tpu_torch/csrc/alpha_phase_full.cu",
         "replaces": "demethify_tpu/ops/pallas_small.py:261",
         "launches": cohort["launches"]["alpha_phase_full"],
         "max_abs_err": k2_cohort["alpha_max_abs"], "ms": k2_cohort["ms"],
         "plain_ms": k2_cohort["plain_ms"],
         "bound_ms": k2_cohort["bound_ms"],
         "bound_by": k2_cohort["bound_by"], "library_ms": None,
         "redesigned": "p = 29, n_s = 100: 13 blocks of 8 columns",
         "path": "cohort 1M x 100, 25+4, float32, 1000x20"},
        {"name": "fw_phase_full", "route": "cuda",
         "source": "demethify_tpu_torch/csrc/fw_phase_full.cu",
         "replaces": "demethify_tpu/ops/pallas_small.py:636",
         "launches": p_launches["fw_phase_full"],
         "max_abs_err": k3["alpha_max_abs"], "ms": k3["ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3_b[0],
         "bound_by": k3_b[1], "library_ms": None,
         "redesigned": K3_REDESIGN},
        {"name": "u_phase_grams_multi", "route": "cuda",
         "source": "demethify_tpu_torch/csrc/u_phase_grams_multi.cu",
         "replaces": "demethify_tpu/ops/pallas_kernels.py:828 (via :1123)",
         "launches": restarts["partial-ref"]["launches"][
             "u_phase_grams_multi"],
         "max_abs_err": k4["u_max_abs"], "ms": k4["ms"],
         "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
         "bound_by": k4["bound_by"], "library_ms": None,
         "redesigned": K4_REDESIGN},
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
         "bound_by": k6["bound_by"], "library_ms": None,
         "redesigned": K3_REDESIGN},
        {"name": "u_phase_grams_multi[weights]", "route": "cuda",
         "source": "demethify_tpu_torch/csrc/u_phase_grams_multi.cu",
         "replaces": "demethify_tpu/ops/pallas_kernels.py:828 (weights "
                     "operand :1015-1120, via :1123)",
         "launches": boot["weights partial-ref"]["launches"][
             "u_phase_grams_multi"],
         "max_abs_err": k4w["u_max_abs"], "ms": k4w["ms"],
         "plain_ms": k4w["plain_ms"], "bound_ms": k4w["bound_ms"],
         "bound_by": k4w["bound_by"], "library_ms": None,
         "redesigned": K4_REDESIGN},
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
         "bound_by": k6w["bound_by"], "library_ms": None,
         "redesigned": K3_REDESIGN},
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
         "bound_by": k4_bf16["bound_by"], "library_ms": None,
         "redesigned": K4_REDESIGN},
        {"name": "u_phase_grams_multi[bf16,weights]", "route": "cuda",
         "source": "demethify_tpu_torch/csrc/u_phase_grams_multi.cu",
         "replaces": "demethify_tpu/ops/pallas_kernels.py:828 (bf16 blocks "
                     "with the weights operand :1015-1120, via :1123)",
         "launches": bf16["bootstrap"]["launches"][
             "u_phase_grams_multi[bf16]"],
         "max_abs_err": k4w_bf16["u_max_abs"], "ms": k4w_bf16["ms"],
         "plain_ms": k4w_bf16["plain_ms"], "bound_ms": k4w_bf16["bound_ms"],
         "bound_by": k4w_bf16["bound_by"], "library_ms": None,
         "redesigned": K4_REDESIGN}]}
    kernels["kernels"].extend(_envelope_rows(
        wide, k1_state, k4_state, glue, masks, folded, k1_bf16c_direct,
        mask_paths, env))
    kernels["kernels"].extend(_global_rows(glob, past))
    kernels["kernels"].extend(_column_rows_rows(col_rows))
    kernels["kernels"].extend(_state_rows(state_cases, sweep))
    kernels["kernels"].extend(_single_phase_rows(single))
    for row in kernels["kernels"]:
        # K1-K6: launches on each rank of the row-sharded solves, and on
        # each worker of the 2-D layout's routes
        per_rank = {name: r["launches"][row["name"]]
                    for name, r in ranks.items()
                    if row["name"] in r["launches"]}
        if per_rank:
            row["sharded_launches_per_rank"] = per_rank
        per_worker = {route: [w[row["name"]] for w in r["launches"]]
                      for route, r in layout.items()
                      if row["name"] in r["launches"][0]}
        if per_worker:
            row["layout_2d_launches_per_worker"] = per_worker
        # K1, K2, K4, K5: launches on each rank after the row-distributed
        # set-up (phase 14)
        per_route = {route: [r.get(row["name"], 0) for r in per]
                     for route, per in row_init.items()
                     if any(row["name"] in r for r in per)}
        if per_route:
            row["row_init_launches_per_rank"] = per_route
        # K1 and K2: their device time in the program's own trace
        # (--profile, the main path's CLI run)
        traced = [v for k, v in obs["trace"].items()
                  if (row["name"] == "u_phase_grams" and K1_KERNEL in k)
                  or (row["name"] == "alpha_phase_full"
                      and any(n in k for n in K2_KERNELS))]
        if traced:
            row["profile_trace_us_each"] = (sum(v["device_us"]
                                                for v in traced)
                                            / sum(v["count"]
                                                  for v in traced))
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
    if sys.argv[1:2] == ["--ranks-worker"]:
        sys.path.insert(0, HERE)
        sys.exit(rank_worker(sys.argv[2], sys.argv[3], int(sys.argv[4]),
                             int(sys.argv[5])))
    if sys.argv[1:2] == ["--layout-worker"]:
        sys.path.insert(0, HERE)
        sys.exit(layout_worker(sys.argv[2], sys.argv[3],
                               *map(int, sys.argv[4:8])))
    if sys.argv[1:2] == ["--row-init-worker"]:
        sys.path.insert(0, HERE)
        sys.exit(row_init_worker(sys.argv[2], sys.argv[3], int(sys.argv[4]),
                                 int(sys.argv[5]), sys.argv[6],
                                 int(sys.argv[7])))
    sys.exit(main())
