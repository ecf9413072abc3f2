"""The port's plain ops (demethify_tpu_torch.ops) against their
demethify_tpu.ops counterparts, in float64 on the CPU.

Tolerance: atol 1e-12 (the two packages sum in different orders; every
quantity here is O(1)-O(1e3) in magnitude), 1e-8 for the NNLS, whose
600-step FISTA and support polish amplify reassociation differences.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demethify_tpu.ops import cost as jcost
from demethify_tpu.ops import fista as jfista
from demethify_tpu.ops import gram as jgram
from demethify_tpu.ops import simplex as jsimplex
from demethify_tpu.ops.nnls import nnls_gram as j_nnls_gram
from demethify_tpu.ops.nnls import wls_intercept_batch as j_wls_batch
from demethify_tpu_torch.ops import cost, fista, gram, nnls, simplex

ATOL = 1e-12


def _t(x):
    return torch.tensor(np.asarray(x, dtype=np.float64))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def test_weighted_cost(small_problem):
    p = small_problem
    R = np.hstack([p["R_trunc"], p["u_true"]])
    want = jcost.weighted_cost(jnp.asarray(p["y"]), jnp.asarray(R),
                               jnp.asarray(p["alpha"]), jnp.asarray(p["d"]))
    got = cost.weighted_cost(_t(p["y"]), _t(R), _t(p["alpha"]), _t(p["d"]))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-13)


def test_weighted_cost_gram(small_problem):
    p = small_problem
    R = np.hstack([p["R_trunc"], p["u_true"]])
    G, b, ydy = jgram.sample_grams(jnp.asarray(R), jnp.asarray(p["d"]),
                                   jnp.asarray(p["y"]))
    want = jcost.weighted_cost_gram(G, b, ydy, jnp.asarray(p["alpha"]))
    got = cost.weighted_cost_gram(_t(G), _t(b), _t(ydy), _t(p["alpha"]))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)


@pytest.mark.parametrize("case", ["random", "ties", "one_row", "negative"])
def test_simplex_projection(case):
    rng = np.random.default_rng(3)
    if case == "random":
        v = rng.normal(size=(7, 40))
    elif case == "ties":
        # exact ties inside a column, and a column where the threshold
        # condition holds up to the last tied entry (last-index rho)
        v = np.array([[0.5, 0.2, 1.0, 0.3],
                      [0.5, 0.2, 1.0, 0.3],
                      [0.1, 0.2, 1.0, 0.3],
                      [0.5, 0.2, -1.0, 0.1]])
    elif case == "one_row":
        v = rng.normal(size=(1, 5))
    else:
        v = -np.abs(rng.normal(size=(5, 9))) - 3.0
    want = jsimplex.project_columns_to_simplex(jnp.asarray(v))
    got = simplex.project_columns_to_simplex(_t(v))
    _close(got, want)
    np.testing.assert_allclose(got.sum(0).numpy(), 1.0, atol=1e-12)
    assert (got >= 0).all()


def test_simplex_last_index_rho_matches_oracle():
    from tests.oracle import proj_simplex_cols

    v = np.array([[0.4, 0.25], [0.4, 0.25], [0.2, 0.25], [0.0, 0.25]])
    _close(simplex.project_columns_to_simplex(_t(v)), proj_simplex_cols(v))


def test_grams(small_problem):
    p = small_problem
    y, d, Rt, u = p["y"], p["d"], p["R_trunc"], p["u_true"]
    R = np.hstack([Rt, u])
    for got, want in zip(gram.sample_grams(_t(R), _t(d), _t(y)),
                         jgram.sample_grams(jnp.asarray(R), jnp.asarray(d),
                                            jnp.asarray(y))):
        _close(got, want, atol=1e-9)     # G entries are O(1e3)
    kb = jgram.known_block_grams(jnp.asarray(Rt), jnp.asarray(d),
                                 jnp.asarray(y))
    for got, want in zip(gram.known_block_grams(_t(Rt), _t(d), _t(y)), kb):
        _close(got, want, atol=1e-9)
    want = jgram.sample_grams_incremental(*kb[:2], jnp.asarray(Rt),
                                          jnp.asarray(u), jnp.asarray(d),
                                          jnp.asarray(y))
    got = gram.sample_grams_incremental(_t(kb[0]), _t(kb[1]), _t(Rt), _t(u),
                                        _t(d), _t(y))
    for g, w in zip(got, want):
        _close(g, w, atol=1e-9)
    a = p["alpha"]
    _close(gram.site_curvature(_t(d), _t(a[-2:])),
           jgram.site_curvature(jnp.asarray(d), jnp.asarray(a[-2:])),
           atol=1e-10)
    _close(gram.u_constant_term(_t(y), _t(d), _t(Rt), _t(a[:-2]),
                                _t(a[-2:])),
           jgram.u_constant_term(jnp.asarray(y), jnp.asarray(d),
                                 jnp.asarray(Rt), jnp.asarray(a[:-2]),
                                 jnp.asarray(a[-2:])), atol=1e-10)


def _u_inputs(p):
    y, d, Rt, n_u, alpha = (p["y"], p["d"], p["R_trunc"], p["n_u"],
                            p["alpha"])
    rng = np.random.default_rng(5)
    u = rng.uniform(size=(y.shape[0], n_u))
    l_w = np.linalg.norm(alpha[-n_u:]) ** 2 * d.max() ** 2
    return y, d, Rt, n_u, alpha, u, l_w


@pytest.mark.parametrize("form", ["gram", "direct"])
def test_fista_u(small_problem, form):
    y, d, Rt, n_u, alpha, u, l_w = _u_inputs(small_problem)
    if form == "gram":
        C = jgram.u_constant_term(jnp.asarray(y), jnp.asarray(d),
                                  jnp.asarray(Rt), jnp.asarray(alpha[:-n_u]),
                                  jnp.asarray(alpha[-n_u:]))
        M = jgram.site_curvature(jnp.asarray(d), jnp.asarray(alpha[-n_u:]))
        want = jfista.fista_u_gram(jnp.asarray(u), jnp.asarray(u),
                                   jnp.ones(()), jnp.asarray(l_w),
                                   jnp.asarray(l_w), C, M, 7)
        got = fista.fista_u_gram(_t(u), _t(u), _t(1.0), _t(l_w), _t(l_w),
                                 _t(C), _t(M), 7)
    else:
        want = jfista.fista_u_direct(
            jnp.asarray(u), jnp.asarray(u), jnp.ones(()), jnp.asarray(l_w),
            jnp.asarray(l_w), jnp.asarray(y), jnp.asarray(d),
            jnp.asarray(Rt), jnp.asarray(alpha[:-n_u]),
            jnp.asarray(alpha[-n_u:]), 7)
        got = fista.fista_u_direct(_t(u), _t(u), _t(1.0), _t(l_w), _t(l_w),
                                   _t(y), _t(d), _t(Rt), _t(alpha[:-n_u]),
                                   _t(alpha[-n_u:]), 7)
    for g, w in zip(got, want):
        _close(g, w)


def test_fista_alpha(small_problem):
    p = small_problem
    R = np.hstack([p["R_trunc"], p["u_true"]])
    G, b, _ = jgram.sample_grams(jnp.asarray(R), jnp.asarray(p["d"]),
                                 jnp.asarray(p["y"]))
    rng = np.random.default_rng(8)
    a0 = rng.dirichlet(np.ones(R.shape[1]), size=p["y"].shape[1]).T
    l_h = float(np.sum(R * R) * p["d"].max() ** 2)
    want = jfista.fista_alpha_gram(jnp.asarray(a0), jnp.asarray(a0),
                                   jnp.ones(()), jnp.asarray(l_h),
                                   jnp.asarray(l_h), G, b, 9)
    got = fista.fista_alpha_gram(_t(a0), _t(a0), _t(1.0), _t(l_h), _t(l_h),
                                 _t(G), _t(b), 9)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("n_u,n_s,n_iter2,expect", [
    (1, 10, 20, True), (30, 2, 1, False), (4, 1, 8, True)])
def test_use_gram_u(n_u, n_s, n_iter2, expect):
    assert fista.use_gram_u(n_u, n_s, n_iter2) == expect
    assert jfista.use_gram_u(n_u, n_s, n_iter2) == expect


def test_nnls_gram():
    rng = np.random.default_rng(11)
    A = rng.normal(size=(40, 6))
    G = A.T @ A
    cs = np.stack([A.T @ rng.normal(size=40) for _ in range(3)])
    want = np.stack([np.asarray(j_nnls_gram(jnp.asarray(G),
                                                jnp.asarray(c)))
                     for c in cs])
    got = nnls.nnls_gram(_t(np.broadcast_to(G, (3, 6, 6))), _t(cs))
    _close(got, want, atol=1e-8)


def test_wls_intercept_batch(small_problem):
    p = small_problem
    y, d, R = p["y"], p["d"], np.hstack([p["R_trunc"], p["u_true"]])
    want = j_wls_batch(jnp.asarray(d * y), jnp.asarray(d),
                                     jnp.asarray(R))
    got = nnls.wls_intercept_batch(_t(d * y), _t(d), _t(R))
    _close(got, want, atol=1e-8)
    np.testing.assert_allclose(got.sum(0).numpy(), 1.0, atol=1e-10)
