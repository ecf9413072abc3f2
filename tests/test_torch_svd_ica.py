"""The SVD and ICA inits of the port on the CPU against the JAX package:
``ops/tall_svd.py``, ``ops/nndsvd.py``, ``ops/nnica.py``, the SVD/ICA
branches of the three modes' inits, the API's deterministic-init rule
and the bootstrap's two layouts with an SVD init.

Tolerances, float64 unless stated:
- singular values within 1e-12 relative; U and W within 1e-10 of the JAX
  function's up to column signs (the port's sign rule, ``tall_svd``),
  float32 within 1e-5 relative (s) and 2e-3 (U, W: the Gram's float32
  rounding);
- NNDSVD (flag 0; sign-independent) within 1e-10, float32 within 5e-5
  of the largest entry (the Gram squares the condition number);
- ``whiten`` within 1e-12 of the whitened rows' largest magnitude;
  float32 on a full-rank covariance (the dual form's) within 1e-4 of it.
  The primal form's float32 null space is rounding scaled by 1e4, and no
  tolerance holds there: both packages differ from the float64 result
  by half the whitened scale;
- the angle search within 1e-7: its golden section resolves the angle to
  about sqrt(eps), where the two losses it compares differ by rounding;
- the rotation search on the same whitened rows within 1e-9, float32
  1e-5; primal ICA within 1e-10 of the largest magnitude (profiles in
  [0, 1], H on the whitened scale), held on these seeds: a golden
  comparison decided by rounding would move it by up to the angle bound;
- the dual ICA within 1e-10 of the JAX functions composed on the port's
  basis (JAX's ``whiten`` and ``_rotation_search`` on the port's S = B'X,
  mapped back through the port's B); the basis within 1e-10 of JAX's up
  to column signs;
- the modes' SVD and ICA inits within 1e-10 (SVD float32: 5e-5).
- float32 ICA is decided by rounding: centring leaves the covariance
  with a null direction in both forms (n_cpg - n_s + 1 in the primal, one
  in the dual), whose clamped eigenvalue scales rounding by 1e4. So it is
  held through its parts (``whiten`` on a full-rank covariance, the
  rotation search on the same whitened rows) and, whole, to its supports
  (profiles in [0, 1], columns on the simplex or the purity).
- bootstrap intervals within 1e-8 (``tests/test_torch_bootstrap.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demethify_tpu.ops import nnica as j_ica
from demethify_tpu.ops import nndsvd as j_nndsvd
from demethify_tpu.ops import tall_svd as j_svd
from demethify_tpu.solvers import api as j_api
from demethify_tpu.solvers import init as j_init
from demethify_tpu.uncertainty.bootstrap import _percentiles as j_percentiles
from demethify_tpu_torch.ops import nnica, nndsvd, tall_svd
from demethify_tpu_torch.solvers import api, init
from demethify_tpu_torch.uncertainty.bootstrap import bootstrap_ci
from tests.test_torch_bootstrap import LEVEL, N_BOOT, _jax_replicates

DTYPES = {"float64": (np.float64, torch.float64),
          "float32": (np.float32, torch.float32)}


def _problem(n, n_s=6, n_ct=3, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    R = rng.uniform(size=(n, n_ct + 2))
    alpha = rng.dirichlet(np.ones(n_ct + 2), size=n_s).T
    d = rng.poisson(30, size=(n, n_s)).astype(np.float64) + 1
    y = np.clip(R @ alpha + 0.01 * rng.normal(size=(n, n_s)), 0, 1)
    return y.astype(dtype), d.astype(dtype), R[:, :n_ct].astype(dtype)


def _up_to_signs(got, want):
    """``got`` with each column's sign turned to agree with ``want``."""
    sign = np.where(np.sum(got * want, axis=0) < 0, -1.0, 1.0)
    return got * sign


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))


# ---------------------------------------------------------------- tall_svd
@pytest.mark.parametrize("name", DTYPES)
def test_tall_svd_against_jax(name):
    np_dt, _ = DTYPES[name]
    V = np.random.default_rng(1).uniform(size=(400, 6)).astype(np_dt)
    U, s, Wt = (x.numpy() for x in tall_svd.tall_svd(torch.tensor(V)))
    Uj, sj, Wtj = (np.asarray(x) for x in j_svd.tall_svd(jnp.asarray(V)))
    s_only = tall_svd.tall_svd_singular_values(torch.tensor(V)).numpy()
    s_j = np.asarray(j_svd.tall_svd_singular_values(jnp.asarray(V)))
    rel = 1e-12 if name == "float64" else 1e-5
    np.testing.assert_allclose(s_only, s_j, rtol=rel)
    np.testing.assert_allclose(s, sj, rtol=rel)
    vec = 1e-10 if name == "float64" else 2e-3
    _close(_up_to_signs(U, Uj), Uj, vec)
    _close(_up_to_signs(Wt.T, Wtj.T), Wtj.T, vec)
    # the sign rule: each column of W has its largest entry positive
    W = Wt.T
    lead = W[np.argmax(np.abs(W), axis=0), np.arange(W.shape[1])]
    assert (lead > 0).all()
    _close(U @ np.diag(s) @ Wt, V, 1e-12 if name == "float64" else 1e-5)


def test_tall_svd_sign_rule_is_the_ports_own():
    """Flipping a column of the eigenvectors does not survive: the rule
    turns it back, so the port's factors do not depend on the eigh."""
    V = torch.tensor(np.random.default_rng(2).uniform(size=(50, 4)))
    U, s, Wt = tall_svd.tall_svd(V)
    W = Wt.T
    flip = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=W.dtype)
    assert torch.equal(W * flip * tall_svd._sign_rule(W * flip), W)
    # a tie in magnitude takes the first index
    tie = torch.tensor([[-0.5, 0.5], [0.5, 0.5]], dtype=torch.float64)
    assert tall_svd._sign_rule(tie).tolist() == [-1.0, 1.0]


# ------------------------------------------------------------------ NNDSVD
@pytest.mark.parametrize("n", [400, 30])        # Gram-eigh and dense SVD
@pytest.mark.parametrize("name", DTYPES)
def test_nndsvd_flag0_against_jax(name, n):
    np_dt, _ = DTYPES[name]
    V = np.random.default_rng(3).uniform(size=(n, 6)).astype(np_dt)
    W, H = nndsvd.nndsvd_initialize(torch.tensor(V), rank=4)
    Wj, Hj = j_nndsvd.nndsvd_initialize(jnp.asarray(V), rank=4)
    tol = 1e-10 if name == "float64" else 5e-5
    _close(W.numpy(), Wj, tol)
    _close(H.numpy(), Hj, tol)


def test_nndsvd_flag2_fills_the_zeros():
    V = torch.tensor(np.random.default_rng(4).uniform(size=(300, 6)))
    W0, H0 = nndsvd.nndsvd_initialize(V, rank=5)
    W2, H2 = nndsvd.nndsvd_initialize(
        V, rank=5, flag=2, generator=torch.Generator().manual_seed(1))
    W2b, _ = nndsvd.nndsvd_initialize(
        V, rank=5, flag=2, generator=torch.Generator().manual_seed(1))
    avg = float(V.mean())
    for a0, a2 in ((W0, W2), (H0, H2)):
        zero = a0 == 0
        assert zero.any()
        assert torch.equal(a2[~zero], a0[~zero])
        assert ((a2[zero] > 0) & (a2[zero] <= avg / 100)).all()
    assert torch.equal(W2, W2b)
    with pytest.raises(ValueError, match="Generator"):
        nndsvd.nndsvd_initialize(V, rank=5, flag=2)
    with pytest.raises(ValueError, match="flag"):
        nndsvd.nndsvd_initialize(V, rank=5, flag=1)


def test_constrained_nndsvd_against_jax():
    y, d, R = _problem(400)
    W, H = nndsvd.constrained_nndsvd(torch.tensor(y), torch.tensor(R),
                                     torch.tensor(d), rank=2)
    Wj, Hj = j_nndsvd.constrained_nndsvd(jnp.asarray(y), jnp.asarray(R),
                                         jnp.asarray(d), rank=2)
    _close(W.numpy(), Wj, 1e-10)
    _close(H.numpy(), Hj, 1e-10)


def test_nndsvd_negative_input_raises():
    V = torch.rand(40, 4, dtype=torch.float64)
    V[3, 2] = -1e-3
    with pytest.raises(ValueError, match="negative"):
        nndsvd.nndsvd_initialize(V, rank=2)


# --------------------------------------------------------------------- ICA
@pytest.mark.parametrize("shape,name", [((300, 6), "float64"),
                                        ((4, 50), "float64"),
                                        ((4, 50), "float32")])
def test_whiten_against_jax(shape, name):
    np_dt, _ = DTYPES[name]
    X = np.random.default_rng(5).uniform(size=shape).astype(np_dt)
    got = nnica.whiten(torch.tensor(X)).numpy()
    want = np.asarray(j_ica.whiten(jnp.asarray(X)))
    _close(got, want, 1e-12 if name == "float64" else 1e-4)


def test_best_angle_against_jax():
    rng = np.random.default_rng(6)
    for _ in range(4):
        yi, yj = rng.normal(size=8), rng.normal(size=8)
        got = float(nnica._best_angle(torch.tensor(yi), torch.tensor(yj)))
        want = float(j_ica._best_angle(jnp.asarray(yi), jnp.asarray(yj)))
        assert abs(got - want) < 1e-7
        # both find the same minimum of the pair loss
        lj = float(nnica._pair_loss(torch.tensor(want), torch.tensor(yi),
                                    torch.tensor(yj)))
        lp = float(nnica._pair_loss(torch.tensor(got), torch.tensor(yi),
                                    torch.tensor(yj)))
        assert abs(lp - lj) <= 1e-12 * max(1.0, lj)


@pytest.mark.parametrize("name", DTYPES)
def test_rotation_search_against_jax(name):
    np_dt, _ = DTYPES[name]
    X = np.random.default_rng(7).uniform(size=(80, 6))
    Z = nnica.whiten(torch.tensor(X)).numpy().astype(np_dt)
    got = nnica._rotation_search(torch.tensor(Z), 0.1, 1000).numpy()
    want = np.asarray(j_ica._rotation_search(jnp.asarray(Z), 0.1, 1000))
    _close(got, want, 1e-9 if name == "float64" else 1e-5)
    # the torque argmax: the first maximum of triu(G, 1), row-major
    t, flat = nnica.torque(torch.tensor(Z))
    G = np.abs(np.triu(np.maximum(Z, 0) @ np.maximum(-Z, 0).T
                       - np.maximum(-Z, 0) @ np.maximum(Z, 0).T, 1))
    assert int(flat) == int(np.argmax(G))


def test_primal_ica_against_jax():
    y, d, R = _problem(300, seed=8)
    u, h = nnica.run_nn_ica(torch.tensor(y), 3)
    uj, hj = j_ica.run_nn_ica(jnp.asarray(y), 3)
    _close(u.numpy(), uj, 1e-10)
    _close(h.numpy(), hj, 1e-10)
    W, H = nnica.constrained_nn_ica(torch.tensor(y), torch.tensor(R),
                                    torch.tensor(d), rank=2)
    Wj, Hj = j_ica.constrained_nn_ica(jnp.asarray(y), jnp.asarray(R),
                                      jnp.asarray(d), rank=2)
    _close(W.numpy(), Wj, 1e-10)
    _close(H.numpy(), Hj, 1e-10)


def _composed_dual(X, rank):
    """The JAX package's dual NN-ICA on the port's basis: JAX's whiten
    and rotation search on S = B'X, mapped back through B."""
    B = tall_svd.tall_svd(torch.tensor(X))[0].numpy()
    Z = j_ica.whiten(jnp.asarray(B.T @ X))
    W = np.asarray(j_ica._rotation_search(Z, 0.1, 1000))
    H = np.maximum(W @ np.asarray(Z), 0.0)
    return np.clip(B @ W[:, :rank], 0.0, 1.0), H[:rank], B


def test_dual_ica_against_composed_jax():
    y, d, R = _problem(5000, seed=9)
    prof, h = nnica.run_nn_ica_dual(torch.tensor(y), 2)
    want_p, want_h, B = _composed_dual(y, 2)
    _close(prof.numpy(), want_p, 1e-10)
    _close(h.numpy(), want_h, 1e-10)
    Bj = np.asarray(j_svd.tall_svd(jnp.asarray(y))[0])
    _close(_up_to_signs(B, Bj), Bj, 1e-10)
    # the constrained form: the residual, then the same composition
    W, H = nnica.constrained_nn_ica(torch.tensor(y), torch.tensor(R),
                                    torch.tensor(d), rank=2, dual=True)
    res = np.maximum(y - R @ H[:3].numpy(), 1e-8)
    want_p, want_h, _ = _composed_dual(res, 2)
    _close(W[:, 3:].numpy(), want_p, 1e-10)
    _close(H[3:].numpy(), want_h, 1e-10)


# ------------------------------------------------------------------- inits
def _inits(mode, option, y, d, R, n_u, purity):
    t = torch.tensor
    j = jnp.asarray
    key = jax.random.PRNGKey(0)
    if mode == "partial":
        got = init.init_partial(torch.Generator(), option, t(y), t(d), t(R),
                                n_u)
        want = j_init.init_partial(key, option, j(y), j(d), j(R), n_u)
    elif mode == "purity":
        got = init.init_purity(torch.Generator(), option, t(y), t(d), t(R),
                               n_u, purity=t(purity))
        want = j_init.init_purity(key, option, j(y), j(d), j(R), n_u,
                                  j(purity))
    else:
        got = init.init_unsupervised(torch.Generator(), option, t(y), t(d),
                                     n_u)
        want = j_init.init_unsupervised(key, option, j(y), j(d), n_u)
    return [x.numpy() for x in got], [np.asarray(x) for x in want]


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("option", ["SVD", "ICA"])
@pytest.mark.parametrize("mode", ["partial", "purity", "unsupervised"])
def test_mode_inits_against_jax(mode, option, name):
    np_dt, _ = DTYPES[name]
    y, d, R = _problem(300, seed=10, dtype=np_dt)
    purity = np.linspace(0.3, 0.8, y.shape[1]).astype(np_dt)
    n_u = 3 if mode == "unsupervised" else 2
    (u, a), (uj, aj) = _inits(mode, option, y, d, R, n_u, purity)
    assert u.shape == uj.shape and a.shape == aj.shape
    assert ((u >= 0) & (u <= 1)).all() and (a >= 0).all()
    if option == "SVD" or name == "float64":
        tol = 1e-10 if name == "float64" else 5e-5
        _close(u, uj, tol)
        _close(a, aj, tol)
    if mode == "purity":
        n_ct = R.shape[1]
        np.testing.assert_allclose(a[:n_ct].sum(0), purity, atol=1e-5)
        # the reference's SVD quirk: the unknown block is not scaled by
        # 1 - purity; the ICA branch's is
        unknown = (np.ones_like(purity) if option == "SVD"
                   else 1.0 - purity)
        np.testing.assert_allclose(a[n_ct:].sum(0), unknown, atol=1e-5)
    else:
        np.testing.assert_allclose(a.sum(0), 1.0, atol=1e-5)


def test_bf16_storage_inits_factor_in_float32():
    """Under bf16 storage SVD and ICA factor the upcast data in float32
    and return float32 factors, as the JAX package's partial-reference
    init does (its unsupervised SVD/ICA inits raise there: its eigh
    takes no bf16); float32 tolerance 5e-5 of the largest entry."""
    y, d, R = _problem(300, seed=12, dtype=np.float32)
    t16 = [torch.tensor(x).to(torch.bfloat16) for x in (y, d, R)]
    for option in ("SVD", "ICA"):
        u, a = init.init_partial(None, option, *t16, 2)
        assert u.dtype == a.dtype == torch.float32
        uj, aj = j_init.init_partial(
            jax.random.PRNGKey(0), option,
            *(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
              for x in t16), 2)
        assert uj.dtype == aj.dtype == jnp.float32
        if option == "SVD":
            _close(u.numpy(), uj, 5e-5)
            _close(a.numpy(), aj, 5e-5)
        # the same factors as float32 storage of the upcast data
        u32, a32 = init.init_partial(None, option,
                                     *(x.float() for x in t16), 2)
        assert torch.equal(u, u32) and torch.equal(a, a32)
        uu, au = init.init_unsupervised(None, option, t16[0], t16[1], 3)
        uu32, au32 = init.init_unsupervised(None, option, t16[0].float(),
                                            t16[1].float(), 3)
        assert torch.equal(uu, uu32) and torch.equal(au, au32)


def test_mode_inits_fall_back_above_n_samples():
    """n_u > n_samples: SVD and ICA draw the uniform_ init instead."""
    y, d, R = (torch.tensor(x) for x in _problem(60, n_s=2))
    for option in ("SVD", "ICA"):
        got = init.init_partial(torch.Generator().manual_seed(3), option,
                                y, d, R, 3)
        want = init.init_partial(torch.Generator().manual_seed(3),
                                 "uniform_", y, d, R, 3)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("option", ["SVD", "ICA", "uniform_", "beta"])
@pytest.mark.parametrize("n_u,n_s", [(1, 6), (6, 6), (7, 6)])
def test_is_deterministic_as_jax(option, n_u, n_s):
    assert (init.is_deterministic(option, n_u, n_s)
            == j_api._is_deterministic(option, n_u, n_s, None))


def test_svd_init_runs_one_solve_whatever_the_restarts(small_problem):
    p = small_problem
    y, d, Rt = (torch.tensor(p[k]) for k in ("y", "d", "R_trunc"))
    kw = dict(init="SVD", n_iter1=6, n_iter2=5, tol=1e-9)
    one = api.partial_reference_deconv(y, d, Rt, p["n_u"], **kw)
    four = api.partial_reference_deconv(y, d, Rt, p["n_u"], n_restarts=4,
                                        **kw)
    assert torch.equal(one.proportions, four.proportions)
    u0, a0 = init.init_partial(None, "SVD", y, d, Rt, p["n_u"])
    given = api.partial_reference_deconv(y, d, Rt, p["n_u"],
                                         init_provided=(u0, a0), **kw)
    assert torch.equal(given.proportions, one.proportions)
    # above n_samples the fallback draws, and restarts count again
    y2, d2 = y[:, :1], d[:, :1]
    fall = api.partial_reference_deconv(y2, d2, Rt, 2, n_restarts=3,
                                        seed=5, **kw)
    rand = api.partial_reference_deconv(y2, d2, Rt, 2, n_restarts=3,
                                        seed=5, **dict(kw, init="uniform_"))
    assert torch.equal(fall.proportions, rand.proportions)


# --------------------------------------------------------------- bootstrap
@pytest.mark.parametrize("method", ["weights", "resample"])
def test_bootstrap_with_svd_init_matches_jax(small_problem, method):
    """weights: one SVD init of the full data shared by every replicate;
    resample: each replicate's own SVD init on its gathered rows; the
    JAX package's replicate solves from the JAX package's SVD inits."""
    p = small_problem
    y, d, Rt, n_u = p["y"], p["d"], p["R_trunc"], p["n_u"]
    indices = np.random.default_rng(11).integers(0, y.shape[0],
                                                 size=(N_BOOT, y.shape[0]))
    key = jax.random.PRNGKey(0)
    if method == "weights":
        shared = j_init.init_partial(key, "SVD", jnp.asarray(y),
                                     jnp.asarray(d), jnp.asarray(Rt), n_u)
        inits = [tuple(np.asarray(x) for x in shared)] * N_BOOT
    else:
        inits = [tuple(np.asarray(x) for x in j_init.init_partial(
            key, "SVD", jnp.asarray(y[i]), jnp.asarray(d[i]),
            jnp.asarray(Rt[i]), n_u)) for i in indices]
    props, us = _jax_replicates(p, "partial", method, indices, inits, None)
    got = bootstrap_ci(torch.tensor(y), torch.tensor(d), torch.tensor(Rt),
                       n_u, level=LEVEL, n_bootstrap=N_BOOT, method=method,
                       init_option="SVD", indices=indices, n_iter1=8,
                       n_iter2=5, tol=1e-9)
    for g, w in zip(got, [*j_percentiles(props, LEVEL),
                          *j_percentiles(us, LEVEL)]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-8)
