"""The port's row-sharded and multi-process runs on the CPU (gloo), against
the JAX package's sharded solvers and against the port's own one-process
runs.

- the six ``fused.*_sharded`` solvers (and the weighted multi solver of
  the row-sharded bootstrap) on 2 gloo ranks (``tests/torch_ranks.py``)
  against the same solvers on one rank, and the six against the JAX
  package's ``*_sharded`` solvers on the 8-device CPU mesh (4 row shards,
  Pallas in interpret mode), float64, the same injected inits, at 255
  rows, which divides neither 2 nor 4 (padded rows): u and alpha atol
  1e-9, cost and cost trace rtol 1e-9, the same iteration counts, and
  every rank ends with the same cost bits and counts;
- the CLI with ``--multihost`` as two processes against the port's
  one-process CLI on a seeded fixture: proportions within 1e-8 in all
  four modes, the profile part files reassembling into the one-process
  profile, ``--restart``, ``--confidence`` intervals within rtol 1e-10,
  ``--ic AIC`` choosing the same rank, and ``--savestate`` /
  ``--initstate`` across the two layouts;
- the row layout, the axis and the launcher's failure handling.

Every multi-process run joins at a ``FileStore`` under ``tmp_path`` and
runs with a deadline (``run_ranks`` kills what is left).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from demethify_tpu.parallel import mesh as jmesh
from demethify_tpu.solvers import fused as jfused
from demethify_tpu_torch.checkpoint import load_factors
from demethify_tpu_torch.cli import main as torch_cli_main
from demethify_tpu_torch.parallel import mesh
from demethify_tpu_torch.parallel.distributed import LOCAL, run_ranks
from tests.test_torch_cli import _write_fixture
from tests.torch_ranks import flatten, solve_all

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RANKS = 2
N_ROWS = 255                     # divides neither 2 ranks nor 4 shards
DEADLINE_S = 240
TOL = dict(u=1e-9, alpha=1e-9, cost=1e-9)
SOLVERS = ("partial", "unsupervised", "purity", "partial_multi",
           "unsupervised_multi", "purity_multi", "partial_weighted")


def _case(n=N_ROWS, n_s=4, n_ct=3, n_u=1, n_u_uns=2, n_b=3, seed=0):
    """A seeded problem and the injected inits of every solver."""
    rng = np.random.default_rng(seed)
    Rt = rng.uniform(size=(n, n_ct))
    ut = rng.uniform(size=(n, n_u))
    alpha = rng.dirichlet(np.ones(n_ct + n_u), size=n_s).T
    y = np.clip(np.hstack([Rt, ut]) @ alpha
                + 0.01 * rng.normal(size=(n, n_s)), 0, 1)
    d = (rng.poisson(50, size=(n, n_s)) + 1).astype(np.float64)

    def simplex(p, b=None):
        if b is None:
            return rng.dirichlet(np.ones(p), size=n_s).T
        return np.stack([rng.dirichlet(np.ones(p), size=n_s).T
                         for _ in range(b)])
    return dict(
        y=y, d=d, Rt=Rt, purity=np.full(n_s, 0.35), n_u=n_u,
        n_u_uns=n_u_uns, u0=rng.uniform(size=(n, n_u)),
        a0=simplex(n_ct + n_u), u0_uns=rng.uniform(size=(n, n_u_uns)),
        a0_uns=simplex(n_u_uns), u0_b=rng.uniform(size=(n_b, n, n_u)),
        a0_b=simplex(n_ct + n_u, n_b),
        u0_uns_b=rng.uniform(size=(n_b, n, n_u_uns)),
        a0_uns_b=simplex(n_u_uns, n_b),
        w_b=np.stack([np.bincount(rng.integers(0, n, n), minlength=n)
                      for _ in range(n_b)]).astype(np.float64),
        n_iter1=12, n_iter2=5, n_iter2_purity=10, tol=1e-9)


def _python(*args):
    return [sys.executable, *args]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """(case, one-rank results, [rank results]) of the solvers."""
    root = tmp_path_factory.mktemp("ranks")
    case = _case()
    np.savez(root / "case.npz", **case)
    codes = run_ranks(
        [_python("-m", "tests.torch_ranks", str(root / "case.npz"),
                 str(root), str(root / "store"), str(N_RANKS), str(r))
         for r in range(N_RANKS)], DEADLINE_S, cwd=REPO)
    assert codes == [0] * N_RANKS, codes
    ranks = [dict(np.load(root / f"rank{r}.npz")) for r in range(N_RANKS)]
    one = flatten(solve_all(case, LOCAL, mesh.row_block(N_ROWS, 1, 0)))
    return case, one, ranks


def _joined(ranks, key):
    """A solver's result assembled over the ranks: u rows concatenated in
    rank order, the replicated arrays from rank 0."""
    if key.endswith("/u"):
        return np.concatenate([r[key] for r in ranks], axis=-2)
    return ranks[0][key]


def _assert_same_solve(got, want, name):
    np.testing.assert_array_equal(got(f"{name}/n_iter"),
                                  want(f"{name}/n_iter"))
    np.testing.assert_allclose(got(f"{name}/u"), want(f"{name}/u"),
                               rtol=0, atol=TOL["u"])
    np.testing.assert_allclose(got(f"{name}/alpha"), want(f"{name}/alpha"),
                               rtol=0, atol=TOL["alpha"])
    np.testing.assert_allclose(got(f"{name}/cost"), want(f"{name}/cost"),
                               rtol=TOL["cost"])
    np.testing.assert_allclose(got(f"{name}/trace"), want(f"{name}/trace"),
                               rtol=TOL["cost"])


@pytest.mark.parametrize("name", SOLVERS)
def test_two_ranks_match_one_rank(sharded, name):
    _, one, ranks = sharded
    assert ranks[1]["start"] == -(-N_ROWS // N_RANKS)
    _assert_same_solve(lambda k: _joined(ranks, k), one.__getitem__, name)


@pytest.mark.parametrize("name", SOLVERS)
def test_every_rank_ends_with_the_same_bits(sharded, name):
    _, _, ranks = sharded
    for key in ("alpha", "cost", "n_iter", "trace"):
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[f"{name}/{key}"],
                                          ranks[0][f"{name}/{key}"])


def _jax_sharded(case, name):
    """The JAX package's sharded solver of ``name`` on the 8-device mesh
    (4 row shards; 255 rows padded to 256, u0 with a zero row) ->
    {key: numpy} on the data rows."""
    m = jmesh.make_mesh(jax.devices())
    n_shards = m.shape[jmesh.CPG_AXIS]
    y, d, Rt = jmesh.shard_dataset(m, case["y"], case["d"], case["Rt"])
    rep = NamedSharding(m, P())

    def rows(x, axis=0):
        x, _ = jmesh.pad_to_multiple(x, n_shards, axis=axis)
        spec = [None] * x.ndim
        spec[axis] = jmesh.CPG_AXIS
        return jax.device_put(x, NamedSharding(m, P(*spec)))

    kw = dict(n_iter1=int(case["n_iter1"]), n_iter2=int(case["n_iter2"]),
              tol=float(case["tol"]), record_trace=True)
    pkw = dict(kw, n_iter2=int(case["n_iter2_purity"]))
    n_u, n_uu = int(case["n_u"]), int(case["n_u_uns"])
    purity = jax.device_put(jnp.asarray(case["purity"]), rep)
    a = lambda k: jax.device_put(case[k], rep)           # noqa: E731
    call = {
        "partial": lambda: jfused.partial_ref_solve_fused_sharded(
            rows(case["u0"]), a("a0"), y, d, Rt, n_u, **kw),
        "unsupervised": lambda: jfused.unsupervised_solve_fused_sharded(
            rows(case["u0_uns"]), a("a0_uns"), y, d, n_uu, **kw),
        "purity": lambda: jfused.purity_solve_fused_sharded(
            rows(case["u0"]), a("a0"), y, d, Rt, purity, n_u, **pkw),
        "partial_multi": lambda: jfused.partial_ref_solve_fused_multi_sharded(
            rows(case["u0_b"], 1), a("a0_b"), y, d, Rt, n_u, **kw),
        "unsupervised_multi":
            lambda: jfused.unsupervised_solve_fused_multi_sharded(
                rows(case["u0_uns_b"], 1), a("a0_uns_b"), y, d, n_uu, **kw),
        "purity_multi": lambda: jfused.purity_solve_fused_multi_sharded(
            rows(case["u0_b"], 1), a("a0_b"), y, d, Rt, purity, n_u,
            **pkw),
        "partial_weighted":
            lambda: jfused.partial_ref_solve_fused_multi_sharded(
                rows(case["u0_b"], 1), a("a0_b"), y, d, Rt, n_u,
                row_weights_b=rows(case["w_b"], 1), **kw),
    }[name]
    u, alpha, info = call()
    u = np.asarray(u)
    return {f"{name}/u": u[..., :N_ROWS, :], f"{name}/alpha": np.asarray(alpha),
            f"{name}/cost": np.asarray(info["cost"]),
            f"{name}/n_iter": np.asarray(info["n_iter"]),
            f"{name}/trace": np.asarray(info["trace"])}


@pytest.mark.parametrize("name", SOLVERS)
def test_two_ranks_match_jax_sharded(sharded, name):
    case, _, ranks = sharded
    want = _jax_sharded(case, name)
    _assert_same_solve(lambda k: _joined(ranks, k), want.__getitem__, name)


# ------------------------------------------------------------------ layout

def test_row_blocks_cover_the_padded_rows():
    for n, k in ((255, 2), (10, 4), (3, 4), (8, 8), (1, 3)):
        blocks = [mesh.row_block(n, k, r) for r in range(k)]
        assert blocks[0].start == 0 and blocks[-1].stop == blocks[0].n_pad
        assert all(a.stop == b.start for a, b in zip(blocks, blocks[1:]))
        assert blocks[0].n_pad % k == 0 and blocks[0].n_pad - n < k
        assert sum(b.n_data for b in blocks) == n
        x = np.arange(n * 2.0).reshape(n, 2)
        got = np.concatenate([b.take(x) for b in blocks])
        np.testing.assert_array_equal(got, jmesh.pad_to_multiple(x, k)[0])
        xt = torch.as_tensor(x)
        assert torch.equal(torch.cat([b.take(xt) for b in blocks]),
                           torch.as_tensor(got))


def test_mesh_helpers_match_jax():
    x = np.ones((10, 3))
    for got in (mesh.pad_to_multiple(x, 4),
                mesh.pad_to_multiple(torch.as_tensor(x), 4)):
        assert got[0].shape == (12, 3) and got[1] == 10
        assert (np.asarray(got[0])[10:] == 0).all()
    assert [mesh.host_row_block(10, 3, h) for h in range(3)] == [
        (0, 4), (4, 7), (7, 10)]


def test_local_axis_is_the_identity():
    x, y = torch.arange(3.0), torch.ones(2, 2)
    assert LOCAL.size == 1 and LOCAL.rank == 0 and LOCAL.backend == "none"
    assert LOCAL.sum_(x) is x and LOCAL.max_(x) is x
    assert LOCAL.sums(x, y) == (x, y)
    assert LOCAL.all_gather_object({"a": 1}) == [{"a": 1}]
    assert LOCAL.broadcast_object(5) == 5


def test_a_failing_rank_stops_the_others():
    codes = run_ranks([_python("-c", "import sys; sys.exit(3)"),
                       _python("-c", "import time; time.sleep(120)")], 60)
    assert codes == [3, -9]


# --------------------------------------------------------------------- CLI

@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    return _write_fixture(str(tmp_path_factory.mktemp("cli")), seed=3,
                          n_cpg=401)


def _cli_args(samples, ref, *extra):
    return ["--methfreq", *samples, "--bedmethyl", "--noprint", "--dtype",
            "float64", "--device", "cpu",
            *([] if ref is None else ["--ref", ref]), *extra]


def _run_cli(tmp_path, tag, samples, ref, *extra, one_extra=(),
             two_extra=()):
    """The CLI in one process (in this one, with ``one_extra`` too) and as
    two --multihost processes (``two_extra``) -> (outdir of one, outdir
    of two)."""
    args = _cli_args(samples, ref, *extra)
    one, two = tmp_path / f"{tag}-one", tmp_path / f"{tag}-two"
    assert torch_cli_main(args + ["--outdir", str(one), *one_extra]) == 0
    store = "file://" + str(tmp_path / f"{tag}-store")
    codes = run_ranks(
        [_python("-m", "demethify_tpu_torch", *args, "--outdir", str(two),
                 *two_extra, "--multihost", store, str(N_RANKS), str(r))
         for r in range(N_RANKS)], DEADLINE_S, cwd=REPO)
    assert codes == [0] * N_RANKS, codes
    return one, two


def _props(path):
    return pd.read_csv(path / "celltypes_proportions.csv", index_col=0,
                       float_precision="round_trip")


def _assert_same_props(one, two):
    want, got = _props(one), _props(two)
    assert list(got.index) == list(want.index)
    assert list(got.columns) == list(want.columns)
    np.testing.assert_allclose(got.values, want.values, rtol=0, atol=1e-8)


def _parts(path):
    """The profile part files of a multi-process run, reassembled."""
    parts = [pd.read_csv(path / f"methylation_profile_estimate.part"
                         f"{r:04d}.csv", index_col=0)
             for r in range(N_RANKS)]
    return pd.concat(parts)


def _ci(path, name):
    df = pd.read_csv(path / name, index_col=0 if "celltypes" in name
                     else None)
    cells = np.array([[[float(v) for v in c.strip("()").split(",")]
                       for c in row] for row in df.values.astype(str)])
    return cells


def test_cli_partial_ref_restarts_confidence(tmp_path, fixture_files):
    one, two = _run_cli(tmp_path, "partial", *fixture_files, "--nbunknown",
                        "1", "--iterations", "200", "10", "--restart", "3",
                        "--confidence", "90", "7", "--trace")
    _assert_same_props(one, two)
    prof = pd.read_csv(one / "methylation_profile_estimate.csv")
    parts = _parts(two)
    assert list(parts.index) == list(range(len(prof)))
    assert list(parts.columns) == list(prof.columns)
    np.testing.assert_allclose(parts.values, prof.values, rtol=0, atol=1e-8)
    for name in ("confidence_interval_celltypes_proportions.csv",
                 "confidence_interval_methylation_estimate.csv"):
        np.testing.assert_allclose(_ci(two, name), _ci(one, name),
                                   rtol=1e-10, atol=0)
    np.testing.assert_allclose(
        pd.read_csv(two / "cost_trajectory.csv").values,
        pd.read_csv(one / "cost_trajectory.csv").values, rtol=1e-9)
    assert not (two / "methylation_profile_estimate.csv").exists()


@pytest.mark.parametrize("mode", ["purity", "unsupervised", "supervised"])
def test_cli_modes(tmp_path, fixture_files, mode):
    samples, ref = fixture_files
    extra = {"purity": ["--nbunknown", "1", "--iterations", "20", "50",
                        "--purity", "30", "45", "60", "75"],
             "unsupervised": ["--nbunknown", "2", "--iterations", "200",
                              "10", "--restart", "3"],
             "supervised": []}[mode]
    one, two = _run_cli(tmp_path, mode, samples,
                        None if mode == "unsupervised" else ref, *extra)
    _assert_same_props(one, two)
    if mode != "supervised":
        prof = pd.read_csv(one / "methylation_profile_estimate.csv")
        np.testing.assert_allclose(_parts(two).values, prof.values, rtol=0,
                                   atol=1e-8)


def test_cli_ic_sweep(tmp_path, fixture_files):
    one, two = _run_cli(tmp_path, "ic", *fixture_files, "--ic", "AIC",
                        "--icmax", "3", "--iterations", "100", "10")
    _assert_same_props(one, two)
    assert (open(one / "log.log").read().splitlines()[1]
            == open(two / "log.log").read().splitlines()[1])
    np.testing.assert_allclose(
        pd.read_csv(two / "methylation_profile_estimate.csv").values,
        pd.read_csv(one / "methylation_profile_estimate.csv").values,
        rtol=0, atol=1e-8)


def test_cli_checkpoints_cross_the_layouts(tmp_path, fixture_files):
    """--savestate from one process and from two hold the same factors
    (two: one u part a rank); --initstate of each in the other layout
    gives the same warm start."""
    samples, ref = fixture_files
    flags = ("--nbunknown", "1", "--iterations", "30", "10")
    c1, c2 = str(tmp_path / "ckpt-one"), str(tmp_path / "ckpt-two")
    one, _ = _run_cli(tmp_path, "save", samples, ref, *flags,
                      one_extra=("--savestate", c1),
                      two_extra=("--savestate", c2))
    s1, s2 = load_factors(c1), load_factors(c2)
    assert s1["n_rows"] == s2["n_rows"] == len(
        pd.read_csv(one / "methylation_profile_estimate.csv"))
    assert sorted(os.listdir(c2)) == [
        "alpha.npy", "cost.npy", "factors.json", "u.part0000.npy",
        "u.part0001.npy"]
    for key in ("u", "alpha", "cost"):
        np.testing.assert_allclose(s2[key], s1[key], rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(s1["alpha"], _props(one).values)
    one, two = _run_cli(tmp_path, "warm", samples, ref, *flags,
                        one_extra=("--initstate", c2),
                        two_extra=("--initstate", c1))
    _assert_same_props(one, two)


def test_cli_shard_on_the_cpu_is_the_one_device_run(tmp_path, fixture_files):
    args = _cli_args(*fixture_files, "--nbunknown", "1", "--iterations",
                     "50", "10")
    assert torch_cli_main(args + ["--outdir", str(tmp_path / "a")]) == 0
    assert torch_cli_main(args + ["--outdir", str(tmp_path / "b"),
                                  "--shard"]) == 0
    pd.testing.assert_frame_equal(_props(tmp_path / "b"),
                                  _props(tmp_path / "a"))


def test_cli_shard_workers_row_shard_the_weights_bootstrap(tmp_path,
                                                          fixture_files):
    """``--shard``'s workers (two, on the CPU here; one a card on a
    machine with several GPUs): the point estimate and the weights
    bootstrap row-sharded (K4's twin on each worker's rows), against the
    one-process run."""
    from demethify_tpu_torch.cli import _run_shard_workers

    args = _cli_args(*fixture_files, "--nbunknown", "1", "--iterations",
                     "100", "10", "--confidence", "90", "5", "--cimethod",
                     "weights")
    one, two = tmp_path / "one", tmp_path / "two"
    assert torch_cli_main(args + ["--outdir", str(one)]) == 0
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        assert _run_shard_workers(args + ["--outdir", str(two), "--shard"],
                                  N_RANKS) == 0
    finally:
        os.chdir(cwd)
    _assert_same_props(one, two)
    for name in ("confidence_interval_celltypes_proportions.csv",
                 "confidence_interval_methylation_estimate.csv"):
        np.testing.assert_allclose(_ci(two, name), _ci(one, name),
                                   rtol=1e-10, atol=0)
    prof = pd.read_csv(one / "methylation_profile_estimate.csv")
    np.testing.assert_allclose(_parts(two).values, prof.values, rtol=0,
                               atol=1e-8)
