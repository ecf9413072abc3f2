"""The port's model selection on the CPU (``demethify_tpu_torch/selection``)
against the JAX package's: the criteria, CCC, minka (both spectra), BCV
and each sweep of ``evaluate_best_ic``, and the plain unsupervised
solver's ``row_mask``.

torch cannot draw ``jax.random``'s numbers, so the sweeps take the JAX
package's own draws, made here with ``jax.random`` and its
``_padded_init_batch`` / ``_masked_init_batch`` and fold keys, through
``evaluate_best_ic(inits=, masks=)``: the JAX package solves every rank
padded to n_u_max under row masks, the port each rank at its own width
from the same inits restricted to the rank's rows. Tolerance, float64:
the same chosen rank, and the criterion list within 1e-8 relative (the
padded and the lower-rank solve agree to rounding, over a fixed schedule,
tol = 0); the chosen factors within 1e-8. The criteria, CCC and minka's
evidence are host arithmetic: 1e-12 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demethify_tpu.selection import batched_sweep as j_bs
from demethify_tpu.selection import bcv as j_bcv
from demethify_tpu.selection import minka as j_minka
from demethify_tpu.selection.ccc import compute_ccc as j_ccc
from demethify_tpu.selection.criteria import compute_aic as j_aic
from demethify_tpu.selection.criteria import compute_bic as j_bic
from demethify_tpu.selection.sweep import evaluate_best_ic as j_sweep
from demethify_tpu.solvers import init as j_init
from demethify_tpu.solvers.unsupervised import unsupervised_solve as j_unsup
from demethify_tpu_torch.selection import bcv, minka, sweep
from demethify_tpu_torch.selection.ccc import compute_ccc
from demethify_tpu_torch.selection.criteria import compute_aic, compute_bic
from demethify_tpu_torch.solvers import api
from demethify_tpu_torch.solvers.unsupervised import unsupervised_solve

N_CPG, N_S, N_CT, N_U_MAX, SEED = 300, 6, 3, 4, 3
SCHED = dict(iter1=25, iter2=5, tol=0.0)


def _problem(n_s=N_S, seed=0, n_true=2):
    rng = np.random.default_rng(seed)
    R = rng.uniform(size=(N_CPG, N_CT + n_true))
    alpha = rng.dirichlet(np.ones(N_CT + n_true), size=n_s).T
    d = rng.poisson(30, size=(N_CPG, n_s)).astype(np.float64) + 1
    y = np.clip(R @ alpha + 0.01 * rng.normal(size=(N_CPG, n_s)), 0, 1)
    return y, d, R[:, :N_CT]


def _active(u_pad, a_pad, n_ct, rank):
    """A padded member's factors on the rank's own rows."""
    u_pad, a_pad = np.asarray(u_pad), np.asarray(a_pad)
    return (u_pad[:, :rank],
            np.concatenate([a_pad[:n_ct], a_pad[n_ct:n_ct + rank]], 0))


def _jax_draws(ic, option, y, d, ref, n_restarts):
    """The JAX sweep's random inits, as ``inits(rank, j)``, and BCV's
    train masks (None for the other criteria)."""
    key = jax.random.PRNGKey(SEED)
    y, d = jnp.asarray(y), jnp.asarray(d)
    ref = None if ref is None else jnp.asarray(ref)
    n_ct = 0 if ref is None else ref.shape[1]
    masks = j_bs._member_masks(n_ct, N_U_MAX)
    if ic == "minka":
        # the follow-up solve inits from key itself
        def inits(rank, j):
            if ref is None:
                return j_init.init_unsupervised(key, option, y, d, rank)
            return j_init.init_partial(key, option, y, d, ref, rank)
        return inits, None
    if ic in ("AIC", "BIC") and option not in j_bs.RANDOM_INITS:
        # SVD/ICA: the fallback ranks above n_samples draw uniform_ from
        # fold_in(key, rank)
        def inits(rank, j):
            u, a = j_bs._masked_uniform_init(
                jax.random.fold_in(key, rank), y.shape[0], n_ct, N_U_MAX,
                y.shape[1], y.dtype, masks[rank - 1])
            return _active(u, a, n_ct, rank)
        return inits, None
    if ic in ("AIC", "BIC"):
        u_b, a_b = j_bs._padded_init_batch(y, d, ref, option, N_U_MAX, key,
                                           masks)
        return (lambda rank, j: _active(u_b[rank - 1], a_b[rank - 1], n_ct,
                                        rank)), None
    if ic == "CCC":
        if option not in j_bs.RANDOM_INITS:        # the serial path
            def inits(rank, j):
                k = jax.random.split(jax.random.fold_in(key, rank),
                                     n_restarts)[j]
                if ref is None:
                    return j_init.init_unsupervised(k, option, y, d, rank)
                return j_init.init_partial(k, option, y, d, ref, rank)
            return inits, None
        masks_b = jnp.repeat(masks, n_restarts, axis=0)
        keys = jax.random.split(key, N_U_MAX * n_restarts)
        u_b, a_b = j_bs._masked_init_batch(keys, option, y, d, ref, n_ct,
                                           N_U_MAX, masks_b)
        return (lambda rank, j: _active(
            u_b[(rank - 1) * n_restarts + j],
            a_b[(rank - 1) * n_restarts + j], n_ct, rank)), None
    # BCV: the shared fold masks, and the data-independent inits drawn
    # once for all folds (this test's options)
    k_folds, k_init = jax.random.split(key)
    train = [np.asarray(jax.random.uniform(jax.random.fold_in(k_folds, f),
                                           y.shape) < bcv.FRACTION)
             for f in range(n_restarts)]
    if option not in j_bs.RANDOM_INITS:
        return None, train
    u_b, a_b = j_bs._masked_init_batch(jax.random.split(k_init, N_U_MAX),
                                       option, y, d, ref, n_ct, N_U_MAX,
                                       masks)
    return (lambda rank, j: _active(u_b[rank - 1], a_b[rank - 1], n_ct,
                                    rank)), train


@pytest.mark.parametrize("ic,option,with_ref,n_s", [
    ("AIC", "uniform_", True, N_S),
    ("BIC", "SVD", True, N_S),
    ("AIC", "SVD", False, 3),            # ranks 4 > n_s: uniform_ fallback
    ("AIC", "ICA", True, N_S),
    ("CCC", "uniform_", True, N_S),
    ("CCC", "beta", False, N_S),
    ("CCC", "SVD", True, N_S),           # the serial path
    ("BCV", "uniform_", True, N_S),
    ("BCV", "SVD", True, N_S),           # inits per fold on masked data
    ("BCV", "uniform_", False, N_S),
    ("minka", "uniform_", True, N_S),
    ("minka", "SVD", False, N_S),
])
def test_sweep_matches_jax(ic, option, with_ref, n_s):
    y, d, R = _problem(n_s=n_s, seed=1)
    ref = R if with_ref else None
    n_r = 3
    inits, masks = _jax_draws(ic, option, y, d, ref, n_r)
    ju, ja, jn, jlist = j_sweep(
        jnp.asarray(y), jnp.asarray(d),
        None if ref is None else jnp.asarray(ref), option, ic,
        key=jax.random.PRNGKey(SEED), n_restarts=n_r, n_u_max=N_U_MAX,
        **SCHED)
    got_u, got_a, got_n, got_list = sweep.evaluate_best_ic(
        torch.tensor(y), torch.tensor(d),
        None if ref is None else torch.tensor(ref), option, ic,
        n_restarts=n_r, n_u_max=N_U_MAX, inits=inits, masks=masks,
        **SCHED)
    assert got_n == jn
    np.testing.assert_allclose(got_list, jlist, rtol=1e-8)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(ja), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got_u.numpy(), np.asarray(ju), rtol=0,
                               atol=1e-8)


def test_sweep_draws_its_own_inits_per_member():
    """Without injected draws: each member's generator, the same for a
    repeat run, and an SVD sweep's members equal the single SVD solves."""
    y, d, R = (torch.tensor(x) for x in _problem(seed=2))
    kw = dict(n_u_max=3, **SCHED)
    a = sweep.evaluate_best_ic(y, d, R, "uniform_", "BIC", seed=4, **kw)
    b = sweep.evaluate_best_ic(y, d, R, "uniform_", "BIC", seed=4, **kw)
    assert a[2] == b[2] and a[3] == b[3]
    _, _, n, lst = sweep.evaluate_best_ic(y, d, R, "SVD", "AIC", **kw)
    for rank in range(1, 4):
        res = api.partial_reference_deconv(
            y, d, R, rank, init="SVD", n_iter1=SCHED["iter1"],
            n_iter2=SCHED["iter2"], tol=SCHED["tol"])
        assert lst[rank - 1] == compute_aic(res.cost, rank, N_CPG, N_CT,
                                            N_S)
    with pytest.raises(ValueError, match="--ic"):
        sweep.evaluate_best_ic(y, d, R, "SVD", "XYZ", **kw)


# ------------------------------------------------------- criteria, CCC, BCV
@pytest.mark.parametrize("cost", [12.5, 1e-3, -1e-9])
def test_criteria_match_jax(cost):
    for n_u in (1, 4):
        for n_ct in (0, 5):
            args = (cost, n_u, 1000, n_ct, 10)
            assert compute_aic(*args) == pytest.approx(j_aic(*args),
                                                       rel=1e-12)
            assert compute_bic(*args) == pytest.approx(j_bic(*args),
                                                       rel=1e-12)


def test_ccc_matches_jax():
    rng = np.random.default_rng(5)
    runs = [rng.dirichlet(np.ones(4), size=12).T for _ in range(5)]
    assert compute_ccc(runs) == pytest.approx(j_ccc(runs), rel=1e-12)


def test_bicross_validation_matches_jax_serial_bcv():
    """One rank with an SVD init (no draws): the JAX package's serial
    ``bicross_validation`` with its fold keys, the port's on the same
    train masks."""
    y, d, R = _problem(seed=6)
    key = jax.random.PRNGKey(2)
    masks = [np.asarray(jax.random.uniform(
        jax.random.split(jax.random.fold_in(key, f))[0], y.shape)
        < bcv.FRACTION) for f in range(3)]
    want = j_bcv.bicross_validation(
        jnp.asarray(y), jnp.asarray(d), 2, ref=jnp.asarray(R),
        init_option="SVD", iter1=20, iter2=5, tol=0.0, n_folds=3, key=key)
    yt, dt, Rt = (torch.tensor(x) for x in (y, d, R))
    from demethify_tpu_torch.solvers.init import init_partial

    def deconv(y_tr, d_tr, n_u, u0a0):
        return api.partial_reference_deconv(y_tr, d_tr, Rt, n_u,
                                            init_provided=u0a0, n_iter1=20,
                                            n_iter2=5, tol=0.0)

    got = bcv.bicross_validation(
        yt, dt, Rt, 2, [torch.tensor(m) for m in masks],
        lambda f, y_tr, d_tr: init_partial(None, "SVD", y_tr, d_tr, Rt, 2),
        deconv)
    assert got[0] == pytest.approx(float(want[0]), rel=1e-8)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=1e-8)


# ------------------------------------------------------------------- minka
@pytest.mark.parametrize("host", [True, False])
@pytest.mark.parametrize("with_ref", [True, False])
def test_minka_matches_jax_on_both_spectra(monkeypatch, host, with_ref):
    y, d, R = _problem(seed=7)
    if not host:
        # the device spectrum, as tests/test_selection.py forces it
        monkeypatch.setattr(minka, "_HOST_SVD_MAX_ROWS", 10)
        monkeypatch.setattr(j_minka, "_HOST_SVD_MAX_ROWS", 10)
    ref = R if with_ref else None
    rank, info = minka.select_rank_minka(
        torch.tensor(y), torch.tensor(d),
        None if ref is None else torch.tensor(ref))
    j_rank, j_info = j_minka.select_rank_minka(
        jnp.asarray(y), jnp.asarray(d),
        None if ref is None else jnp.asarray(ref))
    assert rank == j_rank
    np.testing.assert_allclose(info["cov_evals"], j_info["cov_evals"],
                               rtol=1e-9, atol=1e-13)
    np.testing.assert_allclose(list(info["log_liks"].values()),
                               list(j_info["log_liks"].values()),
                               rtol=1e-9)


def test_minka_log_lik_matches_jax():
    evals = np.sort(np.random.default_rng(8).uniform(0.1, 2, 10))[::-1]
    for rank in (1, 4, 9):
        assert minka.get_log_lik_partial(evals.copy(), rank, (20, 10)) == (
            pytest.approx(j_minka.get_log_lik_partial(evals.copy(), rank,
                                                      (20, 10)), rel=1e-12))
    with pytest.raises(ValueError):
        minka.get_log_lik_partial(evals, 10, (20, 10))


# ---------------------------------------------------- unsupervised row_mask
def test_unsupervised_row_mask_is_the_lower_rank_solve():
    """The padded masked solve (rank 2 of 4, the other u columns and
    alpha rows at zero) against the rank-2 solve, and against the JAX
    package's masked solve."""
    y, d, _ = _problem(seed=9)
    rng = np.random.default_rng(10)
    u0 = rng.uniform(size=(N_CPG, 2))
    a0 = rng.dirichlet(np.ones(2), size=N_S).T
    u_pad = np.concatenate([u0, np.zeros((N_CPG, 2))], 1)
    a_pad = np.concatenate([a0, np.zeros((2, N_S))], 0)
    mask = np.array([True, True, False, False])
    kw = dict(n_iter1=30, n_iter2=5, tol=0.0)
    t = torch.tensor
    u_m, a_m, info_m = unsupervised_solve(t(u_pad), t(a_pad), t(y), t(d), 4,
                                          row_mask=t(mask), **kw)
    u_2, a_2, info_2 = unsupervised_solve(t(u0), t(a0), t(y), t(d), 2, **kw)
    np.testing.assert_allclose(a_m[:2].numpy(), a_2.numpy(), atol=1e-10)
    assert (a_m[2:] == 0).all() and (u_m[:, 2:] == 0).all()
    np.testing.assert_allclose(u_m[:, :2].numpy(), u_2.numpy(), atol=1e-10)
    np.testing.assert_allclose(float(info_m["cost"]), float(info_2["cost"]),
                               rtol=1e-10)
    _, a_j, _ = j_unsup(jnp.asarray(u_pad), jnp.asarray(a_pad),
                        jnp.asarray(y), jnp.asarray(d), 4,
                        row_mask=jnp.asarray(mask), **kw)
    np.testing.assert_allclose(a_m.numpy(), np.asarray(a_j), atol=1e-10)
