"""bfloat16 storage in the port on the CPU, against the JAX package: Y, D
and R stored in bf16, u, alpha and every sum over the CpG axis in float32.

The same numpy inputs go through both packages, cast to bf16 by each
(the two conversions give the same bits, which the first tests hold).
The JAX side runs its Pallas kernels in interpret mode and its solvers
jitted, as its own tests do; the port's kernel wrappers run their plain
twins on CPU tensors. The JAX solvers' compiled programs round a product
of bf16 values only where XLA keeps it as a bf16 array, and the port
rounds at the same points (``ops/gram.py``, ``solvers/fused.py``).

Tolerances:
- conversions and the bootstrap's bf16 counts: bit for bit;
- the set-up helpers (Grams, C, ||Rt||^2, cost): rtol 1e-6 (float32 sums
  in another order);
- the K1 and K4 twins on bf16 blocks against ``u_phase_grams`` /
  ``u_phase_grams_multi``: rtol 1e-5 with an atol floor of 1e-5, the
  float32 bounds of tests/test_torch_kernels.py;
- the ``bf16_compute`` twin against ``u_phase_grams(bf16_compute=True)``:
  the same bound at n_u = 2 (gram form), where the interpret-mode program
  rounds every product the TPU kernel rounds; 2e-3 at n_u = 1 and in the
  direct form (measured 6e-4 and 1e-3), where XLA forms some of those
  products, and in the direct form all of them, in float32 (the twin
  without any rounding matches the direct form to 2e-7);
- the solvers, 12 outer x 6 inner iterations from injected inits: state
  atol 1e-4 and cost rtol 1e-5 with the absolute floor 1e-6 sum(D Y^2)
  (the float32 bounds of tests/test_torch_solver.py and
  tests/test_torch_purity.py); ``bf16_compute``: state atol 5e-4 and
  cost rtol 1e-3 (measured at most 1.6e-4 and 5.9e-4 over init seeds 6
  and 9).
  Two discrete events can move a solve by more than float32 noise, and
  the inits' seed (9) has neither within the 12 iterations: the plain
  solvers round the residual y - bf16(Rt a1) to bf16 after a float32
  product summed in another order, so one site's residual may land one
  bf16 step apart (u moves by up to 2e-4, seen at seed 6); Frank-Wolfe
  picks its vertex by an argmin, which a near-tie within float32 noise
  flips (alpha moves by gamma purity, 0.125, seen at seed 6);
- the fused solve over a longer schedule (50 x 20, 2000 sites of the
  bench workload), port against JAX in each form: alpha atol 1e-4 in
  float32 and bf16 storage (measured 2.4e-5 and 1.2e-5), 5e-3 in
  ``bf16_compute`` (measured 2.4e-3: the rounding points where the
  interpret-mode program forms products in float32, above, add up over
  1000 U steps); the port's bf16 drift from its float32 solve below 1e-3
  (measured 2.5e-4) and its ``bf16_compute`` drift below 3x JAX's own
  (measured 3.1e-3 against 4.7e-3);
- the bootstrap on injected draws: atol 1e-4 on every bound;
- the CLI with ``--dtype bfloat16`` against the JAX CLI: proportions
  RMSE < 0.1, as tests/test_torch_cli.py (the random inits differ); with
  ``--restart`` the files, labels and column sums only (each package
  keeps the best of its own draws).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from demethify_tpu.cli import main as jax_cli_main
from demethify_tpu.ops import cost as j_cost
from demethify_tpu.ops import gram as j_gram
from demethify_tpu.ops.pallas_kernels import u_phase_grams as j_k1
from demethify_tpu.ops.pallas_kernels import u_phase_grams_multi as j_k4
from demethify_tpu.solvers import fused as j_fused
from demethify_tpu.solvers.api import purity_deconv as j_purity_deconv
from demethify_tpu.solvers.partial_ref import partial_ref_solve as j_partial
from demethify_tpu.solvers.purity import purity_solve as j_purity
from demethify_tpu.solvers.unsupervised import unsupervised_solve as j_unsup
from demethify_tpu.uncertainty.bootstrap import _percentiles as j_percentiles
from demethify_tpu_torch import state
from demethify_tpu_torch.cli import main as torch_cli_main
from demethify_tpu_torch.device import resolve_dtype, state_dtype
from demethify_tpu_torch.ops import cost, cuda_kernels, cuda_multi, gram
from demethify_tpu_torch.ops.cuda_kernels import (
    A_U,
    ACTIVE,
    L_W,
    L_W_PREV,
    N_SCAL,
    N_SCAL_MULTI,
)
from demethify_tpu_torch.solvers import fused
from demethify_tpu_torch.solvers.api import purity_deconv
from demethify_tpu_torch.solvers.partial_ref import partial_ref_solve
from demethify_tpu_torch.solvers.purity import purity_solve
from demethify_tpu_torch.solvers.unsupervised import unsupervised_solve
from demethify_tpu_torch.uncertainty.bootstrap import bootstrap_ci
from tests.test_torch_cli import N_CPG, _write_fixture

BF = torch.bfloat16
TILE = 64
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
STATE, COST, YDY_FLOOR = 1e-4, 1e-5, 1e-6
LONG_BF16C = 5e-3
KW = dict(n_iter1=12, n_iter2=6, tol=1e-9, record_trace=True)
INIT_SEED = 9


def jb(x):
    return jnp.asarray(x, jnp.bfloat16)


def jf(x):
    return jnp.asarray(x, jnp.float32)


def tb(x):
    return torch.tensor(np.ascontiguousarray(x)).to(BF)


def tf(x):
    return torch.tensor(np.ascontiguousarray(x, np.float32))


def _pad(x):
    target = -(-x.shape[-1] // TILE) * TILE
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, target - x.shape[-1])])


def _bf16_values(x):
    """x rounded to bf16, as float32 numpy (the values both sides see)."""
    return np.asarray(jb(x)).astype(np.float32)


# ------------------------------------------------------------ conversions
def _conversion_inputs(kind):
    rng = np.random.default_rng(3)
    if kind == "random":
        return (rng.normal(size=4096) * 10.0 ** rng.integers(-8, 8, 4096)
                ).astype(np.float32)
    if kind == "ties":
        # exactly halfway between two finite bf16 values: the low 16 bits
        # 0x8000, the high 16 bits below the exponent of inf (0x7f80)
        hi = rng.integers(0, 0x7F80, size=2048, dtype=np.uint32) << 16
        return (hi | np.uint32(0x8000)).view(np.float32)
    return np.arange(0, 700, dtype=np.float32)        # counts above 256


@pytest.mark.parametrize("kind", ["random", "ties", "counts"])
def test_bf16_conversion_bits_match_jax(kind):
    x = _conversion_inputs(kind)
    want = np.asarray(jb(x)).view(np.uint16)
    got = torch.tensor(x).to(BF).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)


def test_bootstrap_counts_stop_at_256_as_jax():
    """The JAX bootstrap adds 1 per draw into a bf16 row: 256 + 1 rounds
    back to 256, so a count stops there. The port's weight rows hold the
    same values."""
    idx = np.r_[np.zeros(300, int), np.ones(256, int), np.full(5, 2)]
    want = np.asarray(jnp.zeros(4, jnp.bfloat16).at[idx].add(1.0))
    got = torch.clamp(torch.bincount(torch.tensor(idx), minlength=4),
                      max=256).to(BF)
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))


def test_storage_and_state_dtypes():
    assert resolve_dtype("bfloat16") == BF
    assert state_dtype(BF) == torch.float32
    assert state_dtype(torch.float64) == torch.float64
    rng = np.random.default_rng(0)
    u, a = rng.uniform(size=(5, 1)), rng.uniform(size=(3, 2))
    y, d, r = (rng.uniform(size=(5, 2)) for _ in range(3))
    got = state.from_numpy(u, a, y, d, r, device="cpu", dtype=BF)
    assert [t.dtype for t in got] == [torch.float32] * 2 + [BF] * 3
    pur = state.purity_from_numpy(np.array([0.3, 0.7]), device="cpu",
                                  dtype=BF)
    assert pur.dtype == BF


# ---------------------------------------------------------- set-up helpers
@pytest.mark.parametrize("what", ["known_block_grams", "sample_grams",
                                  "incremental", "u_constant_term",
                                  "cost"])
def test_helpers_on_bf16_match_jax(small_problem, what):
    """The helpers on bf16 inputs against the JAX ones, jitted as they run
    inside the JAX solvers."""
    p = small_problem
    y, d, Rt, n_u = p["y"], p["d"], p["R_trunc"], p["n_u"]
    alpha = p["alpha"].astype(np.float32)
    u = p["u_true"].astype(np.float32)
    if what == "known_block_grams":
        want = jax.jit(j_gram.known_block_grams)(jb(Rt), jb(d), jb(y))
        got = gram.known_block_grams(tb(Rt), tb(d), tb(y))
    elif what == "sample_grams":
        want = jax.jit(j_gram.sample_grams)(jf(u), jb(d), jb(y))
        got = gram.sample_grams(tf(u), tb(d), tb(y))
    elif what == "incremental":
        kb = jax.jit(j_gram.known_block_grams)(jb(Rt), jb(d), jb(y))
        want = jax.jit(j_gram.sample_grams_incremental)(
            *kb[:2], jb(Rt), jf(u), jb(d), jb(y))
        got = gram.sample_grams_incremental(
            *(torch.tensor(np.asarray(x)) for x in kb[:2]), tb(Rt), tf(u),
            tb(d), tb(y))
    elif what == "u_constant_term":
        want = [jax.jit(j_gram.u_constant_term)(
            jb(y), jb(d), jb(Rt), jf(alpha[:-n_u]), jf(alpha[-n_u:]))]
        got = [gram.u_constant_term(tb(y), tb(d), tb(Rt),
                                    tf(alpha[:-n_u]), tf(alpha[-n_u:]))]
    else:
        R0 = np.hstack([Rt, u])
        want = [jax.jit(j_cost.weighted_cost)(jb(y), jb(R0), jf(alpha),
                                              jb(d))]
        got = [cost.weighted_cost(tb(y), tb(R0), tf(alpha), tb(d))]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max())


def test_rt_sq_rounds_its_float32_sum_as_jax(small_problem):
    Rt = small_problem["R_trunc"]
    want = jax.jit(lambda r: jnp.sum(r * r))(jb(Rt))
    got = gram.row_sum_sq(None, torch.float32)(tb(Rt))
    assert got.dtype == torch.float32
    assert float(got) == float(np.asarray(want).astype(np.float32))


# ---------------------------------------------------------------- K1 twin
def _k1_problem(n_u, n_s, seed=0):
    rng = np.random.default_rng(seed)
    n, n_ct = 200, 4
    R = rng.uniform(size=(n, n_ct + n_u))
    alpha = rng.dirichlet(np.ones(n_ct + n_u), size=n_s).T
    d = rng.poisson(50, size=(n, n_s)) + 1.0
    y = np.clip(R @ alpha + 0.01 * rng.normal(size=(n, n_s)), 0, 1)
    u = rng.uniform(size=(n, n_u))
    up = np.clip(u + 0.05 * rng.normal(size=u.shape), 0, 1)
    f32 = lambda x: np.asarray(x, np.float32)       # noqa: E731
    return f32(y), f32(d), f32(R[:, :n_ct]), f32(alpha), f32(u), f32(up)


def _k1_both(n_u, n_s, known, lagged, bf16_compute):
    y, d, Rt, alpha, u, up = _k1_problem(n_u, n_s)
    n = y.shape[0]
    l_w = np.float32(np.sum(alpha[-n_u:] ** 2) * d.max() ** 2)
    a, l_w_prev, steps = np.float32(1.7), np.float32(0.9 * l_w), 5
    want = j_k1(jb(_pad(y.T)), jb(_pad(d.T)),
                jb(_pad(Rt.T)) if known else None,
                jf(alpha[:-n_u]) if known else None, jf(alpha[-n_u:]),
                jf(_pad(u.T)), jf(_pad(up.T)), jf(a), jf(l_w),
                jf(l_w_prev), steps, lagged=lagged,
                bf16_compute=bf16_compute, tile=TILE)
    u_w, up_w, a_w, lwp_w, gu_w, bu_w, usq_w = (np.asarray(x) for x in want)
    scal = torch.zeros(N_SCAL)
    scal[A_U], scal[L_W], scal[L_W_PREV] = float(a), float(l_w), float(
        l_w_prev)
    uut = tf(np.concatenate([u.T, up.T]))
    ydt = tb(np.concatenate([y.T, d.T]))
    gu, bu, usq = cuda_kernels.u_phase_grams(
        ydt, tb(Rt.T) if known else None,
        tf(alpha[:-n_u]) if known else None, tf(alpha[-n_u:]), uut, scal,
        steps, lagged=lagged, bf16_compute=bf16_compute)
    assert ydt.dtype == BF and gu.dtype == uut.dtype == torch.float32
    got = (uut[:n_u].numpy(), uut[n_u:].numpy(), gu.numpy(), bu.numpy(),
           usq.numpy())
    want = (u_w[:, :n], up_w[:, :n], gu_w, bu_w, usq_w)
    return got, want, (float(scal[A_U]), float(a_w)), (
        float(scal[L_W_PREV]), float(lwp_w))


def _assert_k1(got, want, tol):
    scale = np.abs(want[2]).max()             # Gram entries are O(N d)
    for g, w, s in zip(got, want, (1.0, 1.0, scale, scale, want[4])):
        np.testing.assert_allclose(g / s, w / s, **tol)


@pytest.mark.parametrize("n_u,n_s,known,lagged", [
    (1, 6, True, False), (2, 6, True, False), (3, 6, False, True),
    (2, 6, True, True), (2, 1, True, False)],
    ids=["gram-n_u1", "gram-n_u2", "gram-none-lagged", "gram-lagged",
         "direct"])
def test_u_phase_grams_bf16_storage_matches_pallas(n_u, n_s, known, lagged):
    got, want, a, lwp = _k1_both(n_u, n_s, known, lagged, False)
    _assert_k1(got, want, KERNEL_TOL)
    np.testing.assert_allclose(*a, rtol=1e-6)
    np.testing.assert_allclose(*lwp, rtol=1e-6)
    assert cuda_kernels.u_phase_grams.launches_bf16 == 0


@pytest.mark.parametrize("n_u,n_s,known,tol", [
    (2, 6, True, KERNEL_TOL), (3, 6, False, KERNEL_TOL),
    (1, 6, True, dict(rtol=0, atol=2e-3)),
    (2, 1, True, dict(rtol=0, atol=2e-3))],
    ids=["gram-n_u2", "gram-none-n_u3", "gram-n_u1", "direct"])
def test_u_phase_grams_bf16_compute_matches_pallas(n_u, n_s, known, tol):
    got, want, _, _ = _k1_both(n_u, n_s, known, False, True)
    _assert_k1(got, want, tol)
    assert cuda_kernels.u_phase_grams.launches_bf16_compute == 0


def test_bf16_compute_rounds_and_storage_does_not():
    """The storage form equals the float32 form on the bf16 values bit for
    bit (the data are converted once, exactly); bf16_compute differs."""
    y, d, Rt, alpha, u, up = _k1_problem(2, 6)
    n_u = 2

    def run(ydt, rtt, bf16c):
        scal = torch.zeros(N_SCAL)
        scal[A_U], scal[L_W], scal[L_W_PREV] = 1.7, 50.0, 40.0
        uut = tf(np.concatenate([u.T, up.T]))
        out = cuda_kernels.u_phase_grams(ydt, rtt, tf(alpha[:-n_u]),
                                         tf(alpha[-n_u:]), uut, scal, 5,
                                         bf16_compute=bf16c)
        return [uut.numpy(), *(x.numpy() for x in out)]

    ydt = np.concatenate([y.T, d.T])
    storage = run(tb(ydt), tb(Rt.T), False)
    plain = run(tf(_bf16_values(ydt)), tf(_bf16_values(Rt.T)), False)
    ignored = run(tf(_bf16_values(ydt)), tf(_bf16_values(Rt.T)), True)
    rounded = run(tb(ydt), tb(Rt.T), True)
    for s, p, i in zip(storage, plain, ignored):
        np.testing.assert_array_equal(s, p)
        np.testing.assert_array_equal(i, p)
    assert not np.array_equal(rounded[2], storage[2])


# ---------------------------------------------------------------- K4 twin
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weights"])
@pytest.mark.parametrize("n_u,known,lagged", [(1, True, False),
                                              (3, False, True)],
                         ids=["n_u1-known", "n_u3-none-lagged"])
def test_u_phase_grams_multi_bf16_matches_pallas(n_u, known, lagged,
                                                 weighted):
    rng = np.random.default_rng(20 + n_u)
    n, n_s, active = 150, 6, np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    n_b, n_ct = len(active), 4 if known else 0
    p = n_ct + n_u
    R = rng.uniform(size=(n, p))
    d = rng.poisson(50, size=(n, n_s)) + 1.0
    y = np.clip(R @ rng.dirichlet(np.ones(p), size=n_s).T
                + 0.01 * rng.normal(size=(n, n_s)), 0, 1)
    alpha_b = np.stack([rng.dirichlet(np.ones(p), size=n_s).T
                        for _ in range(n_b)]).astype(np.float32)
    u_b = rng.uniform(size=(n_b, n_u, n)).astype(np.float32)
    up_b = np.clip(u_b + 0.05 * rng.normal(size=u_b.shape), 0,
                   1).astype(np.float32)
    w = (rng.integers(0, 4, size=(n_b, n)).astype(np.float32) if weighted
         else None)
    Rt = R[:, :n_ct]
    l_w = (np.sum(alpha_b[:, -n_u:] ** 2, axis=(1, 2))
           * d.max() ** 2).astype(np.float32)
    a = np.linspace(1.2, 2.4, n_b).astype(np.float32)
    want = j_k4(jb(_pad(y.T)), jb(_pad(d.T)),
                jb(_pad(Rt.T)) if known else None,
                jf(alpha_b[:, :n_ct]) if known else None,
                jf(alpha_b[:, n_ct:]), jf(_pad(u_b)), jf(_pad(up_b)), jf(a),
                jf(l_w), jf(0.9 * l_w), 5, active=jf(active), lagged=lagged,
                weights=None if w is None else jf(_pad(w)), tile=TILE)
    u_w, up_w, _, _, gu_w, bu_w, usq_w = (np.asarray(x) for x in want)

    scal_b = torch.zeros((n_b, N_SCAL_MULTI))
    scal_b[:, A_U], scal_b[:, L_W] = tf(a), tf(l_w)
    scal_b[:, L_W_PREV], scal_b[:, ACTIVE] = tf(0.9 * l_w), tf(active)
    uut_b = tf(np.concatenate([u_b, up_b], axis=1))
    alpha_t = tf(alpha_b)
    gu, bu, usq = cuda_multi.u_phase_grams_multi(
        tb(np.concatenate([y.T, d.T])), tb(Rt.T) if known else None,
        alpha_t[:, :n_ct] if known else None, alpha_t[:, n_ct:], uut_b,
        scal_b, 5, lagged, weights=None if w is None else tf(w))
    assert gu.dtype == torch.float32
    act = active > 0
    np.testing.assert_allclose(uut_b[:, :n_u].numpy(), u_w[:, :, :n],
                               **KERNEL_TOL)
    np.testing.assert_allclose(uut_b[:, n_u:].numpy(), up_w[:, :, :n],
                               **KERNEL_TOL)
    scale = np.abs(gu_w).max(axis=(1, 2, 3))[:, None, None, None]
    np.testing.assert_allclose(gu.numpy()[act] / scale[act],
                               gu_w[act] / scale[act], **KERNEL_TOL)
    np.testing.assert_allclose(bu.numpy()[act] / scale[act, ..., 0],
                               bu_w[act] / scale[act, ..., 0], **KERNEL_TOL)
    np.testing.assert_allclose(usq.numpy()[act], usq_w[act], rtol=1e-5)
    assert cuda_multi.u_phase_grams_multi.launches_bf16 == 0


@pytest.mark.parametrize("bad", ["bf16_state", "f64_state", "mixed_data"])
def test_u_phase_grams_rejects_dtype_mixes(bad):
    y, d, Rt, alpha, u, up = _k1_problem(1, 6)
    ydt, rtt = tb(np.concatenate([y.T, d.T])), tb(Rt.T)
    a1, a2 = tf(alpha[:-1]), tf(alpha[-1:])
    uut, scal = tf(np.concatenate([u.T, up.T])), torch.zeros(N_SCAL)
    if bad == "bf16_state":
        uut, a1, a2, scal = (x.to(BF) for x in (uut, a1, a2, scal))
    elif bad == "f64_state":
        uut, a1, a2, scal = (x.double() for x in (uut, a1, a2, scal))
    else:
        rtt = rtt.float()
    with pytest.raises((TypeError, ValueError)):
        cuda_kernels.u_phase_grams(ydt, rtt, a1, a2, uut, scal, 3)


# ------------------------------------------------------------------ solvers
def _inits(p, seed=INIT_SEED, n_b=3):
    rng = np.random.default_rng(seed)
    n, n_s = p["y"].shape
    n_ct, n_u, n_uu = p["R_trunc"].shape[1], p["n_u"], 3
    f32 = lambda x: np.asarray(x, np.float32)       # noqa: E731
    pur = f32(rng.uniform(0.3, 0.7, size=n_s))

    def alphas(k, size):
        return f32(rng.dirichlet(np.ones(k), size=size)).swapaxes(-1, -2)

    def purify(a):
        a = a.copy()
        a[..., :n_ct, :] *= pur / a[..., :n_ct, :].sum(-2, keepdims=True)
        a[..., n_ct:, :] *= (1 - pur) / a[..., n_ct:, :].sum(-2,
                                                              keepdims=True)
        return a

    u0, a0 = f32(rng.uniform(size=(n, n_u))), alphas(n_ct + n_u, n_s)
    u0u, a0u = f32(rng.uniform(size=(n, n_uu))), alphas(n_uu, n_s)
    ub, ab = f32(rng.uniform(size=(n_b, n, n_u))), alphas(n_ct + n_u,
                                                          (n_b, n_s))
    ubu, abu = f32(rng.uniform(size=(n_b, n, n_uu))), alphas(n_uu,
                                                             (n_b, n_s))
    wb = np.stack([np.bincount(rng.integers(0, n, n), minlength=n)
                   for _ in range(n_b)]).astype(np.float32)
    return dict(u0=u0, a0=a0, a0p=purify(a0), u0u=u0u, a0u=a0u, ub=ub,
                ab=ab, abp=purify(ab), ubu=ubu, abu=abu, wb=wb, pur=pur,
                n_uu=n_uu)


def _solver_runs(p, i, mode):
    """(JAX result, port result) of one solver on bf16 y, d, R."""
    y, d, R, n_u = p["y"], p["d"], p["R_trunc"], p["n_u"]
    Y, D, Rb = tb(y), tb(d), tb(R)
    nu = i["n_uu"]
    if mode == "partial_fused":
        return (j_fused.partial_ref_solve_fused(
            jf(i["u0"]), jf(i["a0"]), jb(y), jb(d), jb(R), n_u, **KW),
            fused.partial_ref_solve_fused(tf(i["u0"]), tf(i["a0"]), Y, D, Rb,
                                          n_u, **KW))
    if mode == "partial_fused_bf16_compute":
        return (j_fused.partial_ref_solve_fused(
            jf(i["u0"]), jf(i["a0"]), jb(y), jb(d), jb(R), n_u,
            bf16_compute=True, **KW),
            fused.partial_ref_solve_fused(tf(i["u0"]), tf(i["a0"]), Y, D, Rb,
                                          n_u, bf16_compute=True, **KW))
    if mode == "unsupervised_fused":
        return (j_fused.unsupervised_solve_fused(
            jf(i["u0u"]), jf(i["a0u"]), jb(y), jb(d), nu, **KW),
            fused.unsupervised_solve_fused(tf(i["u0u"]), tf(i["a0u"]), Y, D,
                                           nu, **KW))
    if mode == "purity_fused":
        return (j_fused.purity_solve_fused(
            jf(i["u0"]), jf(i["a0p"]), jb(y), jb(d), jb(R), jb(i["pur"]),
            n_u, **KW),
            fused.purity_solve_fused(tf(i["u0"]), tf(i["a0p"]), Y, D, Rb,
                                     tb(i["pur"]), n_u, **KW))
    if mode == "partial_plain":
        return (j_partial(jf(i["u0"]), jf(i["a0"]), jb(y), jb(d), jb(R), n_u,
                          **KW),
                partial_ref_solve(tf(i["u0"]), tf(i["a0"]), Y, D, Rb, n_u,
                                  **KW))
    if mode == "partial_plain_weighted":
        w = i["wb"][0]
        return (j_partial(jf(i["u0"]), jf(i["a0"]), jb(y), jb(d), jb(R), n_u,
                          row_weights=jb(w), **KW),
                partial_ref_solve(tf(i["u0"]), tf(i["a0"]), Y, D, Rb, n_u,
                                  row_weights=tb(w), **KW))
    if mode == "unsupervised_plain":
        return (j_unsup(jf(i["u0u"]), jf(i["a0u"]), jb(y), jb(d), nu, **KW),
                unsupervised_solve(tf(i["u0u"]), tf(i["a0u"]), Y, D, nu,
                                   **KW))
    if mode == "purity_plain":
        return (j_purity(jf(i["u0"]), jf(i["a0p"]), jb(y), jb(d), jb(R),
                         jb(i["pur"]), n_u, **KW),
                purity_solve(tf(i["u0"]), tf(i["a0p"]), Y, D, Rb,
                             tb(i["pur"]), n_u, **KW))
    w = {} if not mode.endswith("weighted") else dict(
        row_weights_b=i["wb"])
    jw = {k: jb(v) for k, v in w.items()}
    tw = {k: tb(v) for k, v in w.items()}
    if mode.startswith("partial_multi"):
        return (j_fused.partial_ref_solve_fused_multi(
            jf(i["ub"]), jf(i["ab"]), jb(y), jb(d), jb(R), n_u, **jw, **KW),
            fused.partial_ref_solve_fused_multi(
                tf(i["ub"]), tf(i["ab"]), Y, D, Rb, n_u, **tw, **KW))
    if mode.startswith("purity_multi"):
        return (j_fused.purity_solve_fused_multi(
            jf(i["ub"]), jf(i["abp"]), jb(y), jb(d), jb(R), jb(i["pur"]),
            n_u, **jw, **KW),
            fused.purity_solve_fused_multi(
                tf(i["ub"]), tf(i["abp"]), Y, D, Rb, tb(i["pur"]), n_u,
                **tw, **KW))
    return (j_fused.unsupervised_solve_fused_multi(
        jf(i["ubu"]), jf(i["abu"]), jb(y), jb(d), nu, **KW),
        fused.unsupervised_solve_fused_multi(tf(i["ubu"]), tf(i["abu"]), Y, D,
                                             nu, **KW))


SOLVER_MODES = ["partial_fused", "partial_fused_bf16_compute",
                "unsupervised_fused", "purity_fused", "partial_plain",
                "partial_plain_weighted", "unsupervised_plain",
                "purity_plain", "partial_multi", "unsupervised_multi",
                "purity_multi", "partial_multi_weighted",
                "purity_multi_weighted"]


@pytest.mark.parametrize("mode", SOLVER_MODES)
def test_solvers_on_bf16_match_jax(small_problem, mode):
    p = small_problem
    want, got = _solver_runs(p, _inits(p), mode)
    bf16c = mode.endswith("bf16_compute")
    state_tol, cost_tol = (5e-4, 1e-3) if bf16c else (STATE, COST)
    floor = YDY_FLOOR * float(np.sum(p["d"] * p["y"] ** 2))
    if "weighted" in mode:
        floor *= float(_inits(p)["wb"].max())
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=state_tol)
    assert got[0].dtype == got[1].dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(got[2]["n_iter"]),
                                  np.asarray(want[2]["n_iter"]))
    for key in ("cost", "trace"):
        np.testing.assert_allclose(got[2][key].numpy(),
                                   np.asarray(want[2][key]), rtol=cost_tol,
                                   atol=floor)


def test_fused_solvers_keep_the_data_in_bf16(small_problem, monkeypatch):
    """``_data_t`` keeps the storage dtype, and K1 and K4 receive bf16
    Y, D and Rt: no float32 copy of the data is made."""
    p = small_problem
    Y, D, Rb = tb(p["y"]), tb(p["d"]), tb(p["R_trunc"])
    ydt, rtt, dmax = fused._data_t(Y, D, Rb, torch.float32)
    assert ydt.dtype == rtt.dtype == BF and dmax.dtype == torch.float32
    seen = []

    def spy(real):
        def wrapper(ydt, rtt, *args, **kw):
            seen.append((ydt.dtype, None if rtt is None else rtt.dtype))
            return real(ydt, rtt, *args, **kw)
        return wrapper

    monkeypatch.setattr(fused, "u_phase_grams", spy(fused.u_phase_grams))
    monkeypatch.setattr(fused, "u_phase_grams_multi",
                        spy(fused.u_phase_grams_multi))
    i = _inits(p)
    kw = dict(KW, n_iter1=2)
    fused.partial_ref_solve_fused(tf(i["u0"]), tf(i["a0"]), Y, D, Rb,
                                  p["n_u"], **kw)
    fused.unsupervised_solve_fused(tf(i["u0u"]), tf(i["a0u"]), Y, D, 3, **kw)
    fused.purity_solve_fused_multi(tf(i["ub"]), tf(i["abp"]), Y, D, Rb,
                                   tb(i["pur"]), p["n_u"],
                                   row_weights_b=tb(i["wb"]), **kw)
    assert len(seen) == 6
    assert all(s in ((BF, BF), (BF, None)) for s in seen)


def test_member_cap_charges_data_and_state_itemsizes():
    """bf16 storage halves the shared copies of Y, D and Rt; the members'
    bytes stay float32."""
    n_cpg, n_s, n_ct, n_u, free = 1_000_000, 10, 5, 1, 79 * 10 ** 9
    f32 = fused.max_multi_members(n_cpg, n_s, n_ct, n_u, 4, 4, free)
    bf16 = fused.max_multi_members(n_cpg, n_s, n_ct, n_u, 4, 2, free)
    per_member = 4 * (cuda_kernels.gram_entries(n_s, n_ct, n_u)
                      * -(-n_cpg // 128) + 4 * n_u * n_cpg)
    assert bf16 == (free // 2 - 2 * n_cpg * (2 * n_s + n_ct)) // per_member
    assert bf16 > f32 == 2162


def test_purity_deconv_rounds_purity_to_bf16(small_problem):
    """The JAX API casts purity to y.dtype: under bf16 storage each
    column's known-block mass is the bf16 value of 1 - p/100."""
    p = small_problem
    y, d, R, n_u = p["y"], p["d"], p["R_trunc"], p["n_u"]
    purity = np.linspace(0.31, 0.83, y.shape[1])
    i = _inits(p)
    kw = dict(n_iter1=4, n_iter2=6, tol=1e-9)
    got = purity_deconv(tb(y), tb(d), tb(R), n_u, purity, **kw,
                        init_provided=(tf(i["u0"]), tf(i["a0p"])))
    want = j_purity_deconv(jb(y), jb(d), jb(R), n_u, jnp.asarray(purity),
                           **kw, init_provided=(jf(i["u0"]), jf(i["a0p"])))
    mass = got.proportions[:-n_u].sum(0).double().numpy()
    np.testing.assert_allclose(mass, _bf16_values(purity), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        mass, np.asarray(want.proportions)[:-n_u].sum(0), rtol=0, atol=1e-6)
    assert np.abs(_bf16_values(purity) - purity).max() > 1e-4


# ---------------------------------------------------------------- bootstrap
@pytest.mark.parametrize("method", ["weights", "resample"])
@pytest.mark.parametrize("mode", ["partial", "purity"])
def test_bootstrap_on_bf16_matches_jax(small_problem, mode, method):
    """Injected draws and inits; the JAX side solves the replicates as its
    bootstrap routes them where its kernels run: the weights layout
    through the fused multi solver with the replicates' bf16 row counts
    (the layout the port runs through K4), the resample layout through
    the solver on the gathered bf16 rows."""
    p = small_problem
    y, d, R, n_u = p["y"], p["d"], p["R_trunc"], p["n_u"]
    n, n_s = y.shape
    rng = np.random.default_rng(8)
    n_boot, level = 4, 90.0
    kw = dict(n_iter1=8, n_iter2=5, tol=1e-9)
    indices = rng.integers(0, n, size=(n_boot, n))
    purity = (rng.uniform(0.3, 0.7, size=n_s).astype(np.float32)
              if mode == "purity" else None)
    inits = []
    for _ in range(n_boot):
        a0 = rng.dirichlet(np.ones(R.shape[1] + n_u), size=n_s).T
        if purity is not None:
            a0[:-n_u] *= purity / a0[:-n_u].sum(0)
            a0[-n_u:] *= (1 - purity) / a0[-n_u:].sum(0)
        inits.append((rng.uniform(size=(n, n_u)).astype(np.float32),
                      a0.astype(np.float32)))
    props, us = [], []
    if method == "weights":
        w_b = jnp.stack([jnp.zeros((n,), jnp.bfloat16).at[idx].add(1.0)
                         for idx in indices])
        u_b, a_b = (jf(np.stack(x)) for x in zip(*inits))
        args = (u_b, a_b, jb(y), jb(d), jb(R))
        if purity is None:
            u, a, _ = j_fused.partial_ref_solve_fused_multi(
                *args, n_u, row_weights_b=w_b, **kw)
        else:
            u, a, _ = j_fused.purity_solve_fused_multi(
                *args, jb(purity), n_u, row_weights_b=w_b, **kw)
        props, us = list(np.asarray(a)), list(np.asarray(u))
    for idx, (u0, a0) in zip(indices, inits):
        if method == "weights":
            break
        args = (jb(y[idx]), jb(d[idx]), jb(R[idx]))
        if purity is None:
            u, a, _ = j_partial(jf(u0), jf(a0), *args, n_u, **kw)
        else:
            u, a, _ = j_purity(jf(u0), jf(a0), *args, jb(purity), n_u, **kw)
        props.append(np.asarray(a))
        us.append(np.asarray(u))
    want = (*j_percentiles(np.stack(props), level),
            *j_percentiles(np.stack(us), level))
    got = bootstrap_ci(tb(y), tb(d), tb(R), n_u, level=level,
                       n_bootstrap=n_boot, method=method, purity=purity,
                       indices=indices, inits=inits, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


# ---------------------------------------------------- long-schedule drift
DRIFT_FORMS = (("float32", False), ("bfloat16", False),
               ("bf16_compute", True))


def bench_problem(n_cpg, seed=0):
    """The smoke script's bench workload (10 samples, 5 known cell types +
    1 unknown; y from a Dirichlet mix plus noise, Poisson(50) + 1
    coverage) at n_cpg sites, with its u0 and alpha0."""
    rng = np.random.default_rng(seed)
    n_s, n_ct, n_u = 10, 5, 1
    f32 = lambda x: np.asarray(x, np.float32)       # noqa: E731
    Rt = f32(rng.uniform(size=(n_cpg, n_ct)))
    at = rng.dirichlet(np.ones(n_ct + n_u), size=n_s).T
    ut = rng.uniform(size=(n_cpg, n_u))
    y = f32(np.clip(np.hstack([Rt, ut]) @ at
                    + 0.01 * rng.normal(size=(n_cpg, n_s)), 0, 1))
    d = f32(rng.poisson(50, size=(n_cpg, n_s)) + 1)
    u0 = f32(rng.uniform(size=(n_cpg, n_u)))
    a0 = f32(rng.dirichlet(np.ones(n_ct + n_u), size=n_s).T)
    return u0, a0, y, d, Rt


def long_schedule_runs(n_cpg, n_iter1, n_iter2=20):
    """(final alpha, cost trace) of the fused partial-reference solve on
    the bench workload, tol 0, from one init, for each package ('jax',
    'port') and each form of DRIFT_FORMS."""
    u0, a0, y, d, Rt = bench_problem(n_cpg)
    kw = dict(n_iter1=n_iter1, n_iter2=n_iter2, tol=0.0, record_trace=True)
    out = {}
    for form, bf16c in DRIFT_FORMS:
        jd = jnp.float32 if form == "float32" else jnp.bfloat16
        td = torch.float32 if form == "float32" else BF
        _, a, info = j_fused.partial_ref_solve_fused(
            jf(u0), jf(a0), *(jnp.asarray(x, jd) for x in (y, d, Rt)), 1,
            bf16_compute=bf16c, **kw)
        out["jax", form] = np.asarray(a), np.asarray(info["trace"])
        _, a, info = fused.partial_ref_solve_fused(
            tf(u0), tf(a0), *(tf(x).to(td) for x in (y, d, Rt)), 1,
            bf16_compute=bf16c, **kw)
        out["port", form] = a.numpy(), info["trace"].numpy()
    return out


def drift_table(runs):
    """max|d alpha| of each form against the same package's float32
    solve; max|d alpha| and the cost traces' largest relative difference
    of the port against JAX in each form."""
    rows = {}
    for form, _ in DRIFT_FORMS:
        if form != "float32":
            for pkg in ("jax", "port"):
                rows[f"alpha, {pkg} {form} vs {pkg} float32"] = float(np.abs(
                    runs[pkg, form][0] - runs[pkg, "float32"][0]).max())
        (a_p, c_p), (a_j, c_j) = runs["port", form], runs["jax", form]
        rows[f"alpha, port {form} vs jax {form}"] = float(
            np.abs(a_p - a_j).max())
        rows[f"cost trace (relative), port {form} vs jax {form}"] = float(
            np.max(np.abs(c_p.astype(np.float64) - c_j) / np.abs(c_j)))
    return rows


def test_long_schedule_alpha_tracks_jax():
    """50 x 20 on 2000 sites of the bench workload: the port's fused solve
    stays on JAX's trajectory in every form, the drift of each form from
    float32 within a factor of the same drift in JAX."""
    rows = drift_table(long_schedule_runs(2000, 50))
    for form, bf16c in DRIFT_FORMS:
        assert rows[f"alpha, port {form} vs jax {form}"] < (
            LONG_BF16C if bf16c else STATE), rows
    assert rows["alpha, port bfloat16 vs port float32"] < 1e-3, rows
    assert rows["alpha, port bf16_compute vs port float32"] < (
        3 * rows["alpha, jax bf16_compute vs jax float32"]), rows


# ---------------------------------------------------------------------- CLI
@pytest.fixture
def fixture_files(tmp_path):
    return _write_fixture(str(tmp_path))


@pytest.mark.parametrize("extra", [[], ["--restart", "2"]],
                         ids=["single", "restarts"])
def test_cli_bfloat16_close_to_jax(tmp_path, fixture_files, extra):
    samples, ref = fixture_files
    base = ["--methfreq", *samples, "--ref", ref, "--bedmethyl",
            "--noprint", "--dtype", "bfloat16", "--nbunknown", "1",
            "--iterations", "300", "10", *extra]
    out_j, out_t = tmp_path / "jax", tmp_path / "torch"
    assert jax_cli_main(base + ["--outdir", str(out_j),
                                "--platform", "cpu"]) == 0
    assert torch_cli_main(base + ["--outdir", str(out_t),
                                  "--device", "cpu"]) == 0
    want = pd.read_csv(out_j / "celltypes_proportions.csv", index_col=0)
    got = pd.read_csv(out_t / "celltypes_proportions.csv", index_col=0)
    assert list(got.index) == list(want.index)
    assert list(got.columns) == list(want.columns)
    np.testing.assert_allclose(got.values.sum(axis=0), 1.0, atol=1e-5)
    assert (got.values >= 0).all()
    if not extra:
        assert np.sqrt(np.mean((got.values - want.values) ** 2)) < 0.1
    prof = pd.read_csv(out_t / "methylation_profile_estimate.csv")
    assert prof.shape == (N_CPG, 1)
    assert os.path.exists(out_t / "log.log")


if __name__ == "__main__":
    # the drift table at a size this runs on a CPU in minutes:
    #   python -m tests.test_torch_bf16 200000 1000
    import sys

    jax.config.update("jax_platforms", "cpu")
    n_cpg, n_iter1 = (int(a) for a in sys.argv[1:3])
    print(f"bench workload, {n_cpg} sites x 10 samples, 5+1, "
          f"{n_iter1} x 20, tol 0, fused partial-reference solve on the CPU")
    for name, value in drift_table(long_schedule_runs(n_cpg,
                                                      n_iter1)).items():
        print(f"  {name}: {value:.4e}")
