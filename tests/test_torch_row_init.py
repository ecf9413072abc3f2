"""The row-distributed set-up of the port's row-sharded runs on the CPU
(gloo, float64): the inits, the supervised WLS, the tall SVD and the
dual ICA's parts, the weights bootstrap's draws and inits, the sweeps'
inits and minka's spectrum, each computed from the rank's rows alone.

Each rank process (``tests/torch_row_ranks.py``) reads only its block of
the rows of each case file (memory-mapped ``.npy``), so a route passes
only if nothing needs the full data. Row counts (301, 4301, 3001) that
neither 2 nor 3 ranks divide, so padded rows take part.

- N ranks (2 and 3) against the port's one-rank run: the uniform_ and
  beta inits bit for bit (u rows and alpha: their draws are the one-rank
  draws); the 'uniform', SVD and ICA inits (primal at 301 rows, dual at
  4301) in the three modes and the supervised proportions and cost within
  1e-10 (the sums add the ranks' partials in another order); the solves
  from SVD, 'uniform' and ICA inits, the weights bootstrap's intervals
  ('uniform' and SVD inits) and the AIC-with-SVD, BCV, CCC and minka
  sweeps within 1e-8; every rank with the same bits of everything that
  is replicated.
- Against the JAX package's row-sharded functions on the conftest's
  8-device CPU mesh (``demethify_tpu.parallel.mesh.shard_dataset``, 4 row
  shards): the tall SVD's U up to column signs and the SVD inits (NNDSVD
  flag 0 does not depend on the signs) within 1e-8; the dual ICA through
  its parts (the basis up to column signs, then the JAX whitening and
  rotation search on the port's S = B'X mapped back through its B) and
  the primal ICA init within 1e-8; the supervised WLS within 1e-10.
- minka's branch rule: ranks that span processes take the Gram spectrum
  with its 2 sqrt(eps) s_max floor at any row count, as the JAX package
  does for an array that is not fully addressable: their log-evidences
  match the JAX ``tall_svd_singular_values`` plus the floor on the same
  residual, on a residual with a singular value under the floor, where
  the exact spectrum chooses another rank; the same ranks marked as one
  process's workers take the exact spectrum, as the one-rank run does.
- The CLI with ``--multihost`` (two processes) and ``--init SVD`` or
  ``ICA`` against the one-process CLI within 1e-8.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from demethify_tpu.ops import nnica as j_ica
from demethify_tpu.ops import tall_svd as j_svd
from demethify_tpu.ops.nnls import wls_intercept_batch as j_wls
from demethify_tpu.parallel import mesh as jmesh
from demethify_tpu.selection import minka as j_minka
from demethify_tpu.solvers import init as j_init
from demethify_tpu_torch.cli import main as torch_cli_main
from demethify_tpu_torch.parallel.distributed import LOCAL, run_ranks
from tests.test_torch_cli import _write_fixture
from tests.test_torch_distributed import _props
from tests.test_torch_svd_ica import _close, _up_to_signs
from tests.torch_row_ranks import INITS, N_U, SWEEPS, routes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 300
SIZES = {"small": 301, "big": 4301, "deficient": 3001}
RANKS = (2, 3)
BITS = [k for k in INITS if k[2] in ("uniform_", "beta")]
CLOSE = [k for k in INITS if k[2] not in ("uniform_", "beta")]
ROUTES = ["solve SVD", "solve uniform restarts", "solve purity ICA",
          "boot uniform", "boot SVD"] + [f"sweep {ic}" for ic, _ in SWEEPS]
# the minka case's perturbation: one singular value of about 3e-7, under
# the Gram's floor 2 sqrt(eps) s_max (5e-7 here) and above the exact
# spectrum's evidence cutoff (cov_evals >= 1e-15)
MINKA_EPS = 3e-7


def _problem(n, n_s=6, n_ct=3, n_u=2, seed=0, noise=0.01):
    rng = np.random.default_rng(seed)
    R = rng.uniform(size=(n, n_ct + n_u))
    alpha = rng.dirichlet(np.ones(n_ct + n_u), size=n_s).T
    d = (rng.poisson(30, size=(n, n_s)) + 1).astype(np.float64)
    y = R @ alpha
    if noise:
        y = np.clip(y + noise * rng.normal(size=(n, n_s)), 0, 1)
    return y, d, R[:, :n_ct], rng


def _deficient():
    """A residual of rank 4 plus a rank-one perturbation of MINKA_EPS."""
    y, d, ref, rng = _problem(SIZES["deficient"], n_s=8, seed=5, noise=0)
    a = rng.normal(size=y.shape[0])
    b = rng.normal(size=y.shape[1])
    y = y + MINKA_EPS * np.outer(a / np.linalg.norm(a), b / np.linalg.norm(b))
    return y, d, ref


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = tmp_path_factory.mktemp("row-init")
    arrays = {}
    for name, seed in (("small", 1), ("big", 2)):
        y, d, ref, _ = _problem(SIZES[name], seed=seed)
        arrays.update({f"{name}_y": y, f"{name}_d": d, f"{name}_ref": ref})
    arrays.update(zip(("deficient_y", "deficient_d", "deficient_ref"),
                      _deficient()))
    arrays["purity"] = np.linspace(0.4, 0.8, 6)
    for name, x in arrays.items():
        np.save(root / f"{name}.npy", x)
    return root, arrays


@pytest.fixture(scope="module")
def one(case):
    return routes(str(case[0]), LOCAL)


@pytest.fixture(scope="module")
def ranks(case):
    """{n_ranks: [results of rank 0, 1, ...]} of the rank processes."""
    root = case[0]
    out = {}
    for n in RANKS:
        run_dir = root / f"ranks{n}"
        run_dir.mkdir()
        codes = run_ranks(
            [[sys.executable, "-m", "tests.torch_row_ranks", str(root),
              str(run_dir), str(run_dir / "store"), str(n), str(r)]
             for r in range(n)], DEADLINE_S, cwd=REPO)
        assert codes == [0] * n, codes
        out[n] = [dict(np.load(run_dir / f"rank{r}.npz")) for r in range(n)]
    return out


def _joined(results, key):
    """A route's result over the ranks: u rows concatenated in rank
    order, a replicated array from rank 0."""
    if key.endswith("/u"):
        return np.concatenate([r[key] for r in results])
    return results[0][key]


def _keys(results, prefix):
    return sorted(k for k in results[0] if k.startswith(prefix + "/"))


def _init_key(k):
    return "init/" + "/".join(k)


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("key", BITS, ids=_init_key)
def test_random_inits_are_the_one_rank_draws(one, ranks, n, key):
    for k in _keys(ranks[n], _init_key(key)):
        np.testing.assert_array_equal(_joined(ranks[n], k), one[k])


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("key", CLOSE, ids=_init_key)
def test_inits_match_one_rank(one, ranks, n, key):
    keys = _keys(ranks[n], _init_key(key))
    assert len(keys) == 2
    for k in keys:
        _close(_joined(ranks[n], k), one[k], 1e-10)


@pytest.mark.parametrize("n", RANKS)
def test_supervised_matches_one_rank(one, ranks, n):
    _close(_joined(ranks[n], "supervised/alpha"), one["supervised/alpha"],
           1e-10)
    np.testing.assert_allclose(_joined(ranks[n], "supervised/cost"),
                               one["supervised/cost"], rtol=1e-10)


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("route", ROUTES)
def test_routes_match_one_rank(one, ranks, n, route):
    keys = _keys(ranks[n], route)
    assert keys
    for k in keys:
        _close(_joined(ranks[n], k), one[k], 1e-8)


@pytest.mark.parametrize("n", RANKS)
def test_every_rank_ends_with_the_same_bits(ranks, n):
    replicated = [k for k in ranks[n][0] if not k.endswith("/u")]
    assert len(replicated) > 40
    for k in replicated:
        for r in ranks[n][1:]:
            np.testing.assert_array_equal(r[k], ranks[n][0][k], err_msg=k)


@pytest.mark.parametrize("n", RANKS)
def test_minka_one_process_takes_the_exact_spectrum(one, ranks, n):
    got = _joined(ranks[n], "minka one process/log_liks")
    want = one["minka one process/log_liks"]
    assert (np.isfinite(got) == np.isfinite(want)).all()
    np.testing.assert_allclose(got[np.isfinite(got)],
                               want[np.isfinite(want)], rtol=1e-8)
    assert _joined(ranks[n], "minka one process/best") == one[
        "minka one process/best"]


# ------------------------------------------------------- the JAX package
def _mesh():
    return jmesh.make_mesh(jax.devices())


def _sharded_rows(m, x):
    n_shards = m.shape[jmesh.CPG_AXIS]
    x, _ = jmesh.pad_to_multiple(np.asarray(x), n_shards)
    spec = [jmesh.CPG_AXIS] + [None] * (x.ndim - 1)
    return jax.device_put(x, NamedSharding(m, P(*spec)))


def _jax_init(mode, option, y, d, ref, purity):
    key = jax.random.PRNGKey(0)
    if mode == "partial":
        return j_init.init_partial(key, option, y, d, ref, N_U)
    if mode == "purity":
        return j_init.init_purity(key, option, y, d, ref, N_U,
                                  jnp.asarray(purity))
    return j_init.init_unsupervised(key, option, y, d, N_U + 1)


@pytest.mark.parametrize("mode", ["partial", "purity", "unsupervised"])
@pytest.mark.parametrize("name", ["small", "big"])
def test_svd_init_against_jax_sharded(case, ranks, name, mode):
    _, arrays = case
    m = _mesh()
    n = SIZES[name]
    y, d, ref = jmesh.shard_dataset(
        m, *(arrays[f"{name}_{k}"] for k in ("y", "d", "ref")))
    uj, aj = (np.asarray(x) for x in _jax_init(mode, "SVD", y, d, ref,
                                               arrays["purity"]))
    got = ranks[3]
    _close(_joined(got, f"init/{name}/{mode}/SVD/u"), uj[:n], 1e-8)
    _close(_joined(got, f"init/{name}/{mode}/SVD/alpha"), aj, 1e-8)


def test_tall_svd_against_jax_sharded(case, ranks):
    _, arrays = case
    m = _mesh()
    Uj, sj, _ = (np.asarray(x) for x in j_svd.tall_svd(
        _sharded_rows(m, arrays["small_y"])))
    got = ranks[3]
    # the Gram squares the condition number: s to 1e-12 of s_max
    _close(_joined(got, "tall_svd/s") / sj[0], sj / sj[0], 1e-12)
    U = _joined(got, "tall_svd/u")
    _close(_up_to_signs(U, Uj[:SIZES["small"]]), Uj[:SIZES["small"]], 1e-8)


def test_dual_ica_parts_against_jax(case, ranks):
    _, arrays = case
    m = _mesh()
    n = SIZES["big"]
    got = ranks[3]
    B = _joined(got, "dual/B/u")
    Bj = np.asarray(j_svd.tall_svd(_sharded_rows(m, arrays["big_y"]))[0])[:n]
    _close(_up_to_signs(B, Bj), Bj, 1e-8)
    S = _joined(got, "dual/S")
    _close(S, B.T @ arrays["big_y"], 1e-10)
    Z = j_ica.whiten(jnp.asarray(S))
    W = np.asarray(j_ica._rotation_search(Z, 0.1, 1000))
    H = np.maximum(W @ np.asarray(Z), 0.0)
    _close(_joined(got, "dual/prof/u"), np.clip(B @ W[:, :2], 0.0, 1.0),
           1e-8)
    _close(_joined(got, "dual/H"), H[:2], 1e-8)


def test_primal_ica_init_against_jax(case, ranks):
    _, arrays = case
    m = _mesh()
    y, d, _ = jmesh.shard_dataset(m, arrays["small_y"], arrays["small_d"])
    uj, aj = (np.asarray(x) for x in _jax_init("unsupervised", "ICA", y, d,
                                               None, None))
    got = ranks[3]
    _close(_joined(got, "init/small/unsupervised/ICA/u"),
           uj[:SIZES["small"]], 1e-8)
    _close(_joined(got, "init/small/unsupervised/ICA/alpha"), aj, 1e-8)


def test_supervised_against_jax_sharded(case, ranks):
    _, arrays = case
    y, d, ref = jmesh.shard_dataset(
        _mesh(), *(arrays[f"small_{k}"] for k in ("y", "d", "ref")))
    want = np.asarray(j_wls(d * y, d, ref))
    for n in RANKS:
        _close(_joined(ranks[n], "supervised/alpha"), want, 1e-10)


def _jax_gram_log_liks(arrays):
    """minka's log-evidences by the JAX package's Gram branch: its
    ``tall_svd_singular_values`` of the row-sharded residual (the known
    block's WLS by its ``wls_intercept_batch``), floored at 2 sqrt(eps)
    s_max; and by the exact spectrum of the same residual."""
    y, d, ref = (arrays[f"deficient_{k}"] for k in ("y", "d", "ref"))
    H1 = np.asarray(j_wls(jnp.asarray(y),
                                               jnp.asarray(d),
                                               jnp.asarray(ref)))
    residual = y - ref @ H1
    s = np.asarray(j_svd.tall_svd_singular_values(
        _sharded_rows(_mesh(), residual)))
    s = np.where(s < 2.0 * np.sqrt(np.finfo(s.dtype).eps) * s.max(), 0.0, s)
    exact = np.linalg.svd(residual, compute_uv=False)
    n_f, n_s = y.shape

    def lls(svals):
        ev = svals ** 2 / n_s
        return np.array([j_minka.get_log_lik_partial(ev, r, (n_s, n_f))
                         for r in range(1, n_s)])
    return lls(s), lls(exact)


@pytest.mark.parametrize("n", RANKS)
def test_minka_across_processes_takes_the_jax_gram_rule(case, ranks, n):
    gram, exact = _jax_gram_log_liks(case[1])
    # the case is one where the rule matters: the exact spectrum keeps a
    # singular value that the Gram floor clears, and chooses another rank
    assert np.isfinite(exact).sum() == np.isfinite(gram).sum() + 1
    assert np.argmax(exact) != np.argmax(gram)
    got = _joined(ranks[n], "minka processes/log_liks")
    assert (np.isfinite(got) == np.isfinite(gram)).all()
    np.testing.assert_allclose(got[np.isfinite(got)],
                               gram[np.isfinite(gram)], rtol=1e-10)
    assert _joined(ranks[n], "minka processes/best") == np.argmax(gram) + 1


# --------------------------------------------------------------------- CLI
@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    return _write_fixture(str(tmp_path_factory.mktemp("cli")), seed=8,
                          n_cpg=401)


@pytest.mark.parametrize("with_ref,extra", [
    (True, ("--nbunknown", "1", "--init", "SVD", "--iterations", "60",
            "10")),
    (True, ("--nbunknown", "1", "--init", "ICA", "--iterations", "20", "40",
            "--purity", "30", "45", "60", "75")),
    (False, ("--nbunknown", "2", "--init", "SVD", "--iterations", "60",
             "10"))], ids=["partial-SVD", "purity-ICA", "unsupervised-SVD"])
def test_cli_multihost_deterministic_inits(tmp_path, fixture_files,
                                           with_ref, extra):
    samples, ref = fixture_files
    args = ["--methfreq", *samples, "--bedmethyl", "--noprint", "--dtype",
            "float64", "--device", "cpu",
            *(["--ref", ref] if with_ref else []), *extra]
    one, two = tmp_path / "one", tmp_path / "two"
    assert torch_cli_main(args + ["--outdir", str(one)]) == 0
    store = "file://" + str(tmp_path / "store")
    codes = run_ranks(
        [[sys.executable, "-m", "demethify_tpu_torch", *args, "--outdir",
          str(two), "--multihost", store, "2", str(r)] for r in range(2)],
        DEADLINE_S, cwd=REPO)
    assert codes == [0, 0], codes
    want, got = _props(one), _props(two)
    assert list(got.index) == list(want.index)
    np.testing.assert_allclose(got.values, want.values, rtol=0, atol=1e-8)
    prof = pd.read_csv(one / "methylation_profile_estimate.csv")
    parts = pd.concat([pd.read_csv(
        two / f"methylation_profile_estimate.part{r:04d}.csv", index_col=0)
        for r in range(2)])
    np.testing.assert_allclose(parts.values, prof.values, rtol=0, atol=1e-8)
