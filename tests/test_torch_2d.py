"""The port's 2-D layout (``--multihost N ID --shard``: N processes of M
workers) on the CPU over gloo, with 2 processes x 2 workers, against the
one-process runs. There is no JAX package here to hold it to: its 2-D
layout needs a real multi-process mesh (``tests/test_distributed.py``
runs it), and the port's one-process runs are held to the JAX package
elsewhere (``tests/test_torch_cli.py``, ``test_torch_selection.py``,
``test_torch_bootstrap.py``).

- ``initialize_layout``: each worker's rank and size in the world, in
  ``rows`` (its process's workers) and in ``across`` (the workers of its
  local index);
- the routes through the API on every worker (the plain
  partial-reference solve row-sharded over the world; the AIC, CCC, BCV
  and minka sweeps over ``across`` with each solve row-sharded over
  ``rows``; the weights bootstrap the same way), on a row count that
  neither the 4 workers nor a process's 2 divide, so that padded rows
  take part (BCV's fold masks among them): every worker ends with the
  same bits, and they match the one-process run within 1e-8 (float64),
  with the same chosen rank;
- the CLI, two processes that each start two workers through the worker
  launcher (``cli._run_shard_workers``, as ``--shard`` starts one a card;
  its workers' options drop ``--multihost`` under any prefix), against
  the one-process CLI: the plain solve with the weights bootstrap
  (proportions and intervals within 1e-8, the profile part files of the
  four workers), ``--ic AIC --icmax 3`` (the same number of
  unknowns, proportions and profile within 1e-8) and the resample
  bootstrap (replicates over the workers, on full copies);
- a worker that fails stops the others, across the processes.
"""

import os
import sys
import time

import numpy as np
import pandas as pd
import pytest

from demethify_tpu_torch.cli import _worker_argv
from demethify_tpu_torch.cli import main as torch_cli_main
from demethify_tpu_torch.parallel.distributed import LOCAL, Layout, run_ranks
from tests.test_torch_cli import _write_fixture
from tests.torch_layout import routes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PROCS, N_LOCAL = 2, 2
DEADLINE_S = 240
LAUNCH = ("import sys; from demethify_tpu_torch.cli import "
          "_run_shard_workers; sys.exit(_run_shard_workers(sys.argv[2:], "
          "int(sys.argv[1])))")


def _case(n=203, n_s=4, n_ct=3, seed=0):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(size=(n, n_ct))
    u = rng.uniform(size=(n, 1))
    alpha = rng.dirichlet(np.ones(n_ct + 1), size=n_s).T
    y = np.clip(np.hstack([ref, u]) @ alpha
                + 0.01 * rng.normal(size=(n, n_s)), 0, 1)
    d = (rng.poisson(40, size=(n, n_s)) + 1).astype(np.float64)
    return dict(y=y, d=d, ref=ref)


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    """(one-process results, [results of world rank 0, 1, 2, 3])."""
    root = tmp_path_factory.mktemp("layout")
    case = _case()
    np.savez(root / "case.npz", **case)
    codes = run_ranks(
        [[sys.executable, "-m", "tests.torch_layout", str(root / "case.npz"),
          str(root), str(root / "store"), str(N_PROCS), str(p),
          str(N_LOCAL), str(i)]
         for p in range(N_PROCS) for i in range(N_LOCAL)], DEADLINE_S,
        cwd=REPO)
    assert codes == [0] * N_PROCS * N_LOCAL, codes
    got = [dict(np.load(root / f"worker{r}.npz"))
           for r in range(N_PROCS * N_LOCAL)]
    return routes(case, Layout(LOCAL, LOCAL, LOCAL)), got


def test_layout_groups(workers):
    _, got = workers
    for p in range(N_PROCS):
        for i in range(N_LOCAL):
            world = p * N_LOCAL + i
            np.testing.assert_array_equal(
                got[world]["layout"],
                [[world, N_PROCS * N_LOCAL], [i, N_LOCAL], [p, N_PROCS]])


ROUTES = ["solve", "ic", "ccc", "bcv", "minka", "boot"]


@pytest.mark.parametrize("route", ROUTES)
def test_every_worker_ends_with_the_same_bits(workers, route):
    _, got = workers
    keys = [k for k in got[0] if k.startswith(route + "/")]
    assert keys
    for k in keys:
        for w in got[1:]:
            assert w[k].tobytes() == got[0][k].tobytes(), k


@pytest.mark.parametrize("route", ROUTES)
def test_workers_match_one_process(workers, route):
    one, got = workers
    keys = [k for k in one if k.startswith(route + "/")]
    assert keys
    for k in keys:
        if k.endswith("/n_u"):
            assert int(got[0][k]) == int(one[k])
        else:
            np.testing.assert_allclose(got[0][k], one[k], rtol=1e-8,
                                       atol=1e-8, err_msg=k)


# --------------------------------------------------------------------- CLI

@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    return _write_fixture(str(tmp_path_factory.mktemp("cli2d")), seed=5,
                          n_cpg=301)


def _args(samples, ref, *extra):
    return ["--methfreq", *samples, "--bedmethyl", "--noprint", "--dtype",
            "float64", "--device", "cpu", "--ref", ref, *extra]


def _run_2d(tmp_path, tag, argv, multihost="--multihost"):
    """The CLI as N_PROCS processes that start N_LOCAL workers each, the
    workers joining at one store; ``multihost`` spells the option.
    Returns (exit codes, outdir)."""
    out = tmp_path / f"{tag}-2d"
    store = "file://" + str(tmp_path / f"{tag}-store")
    codes = run_ranks(
        [[sys.executable, "-c", LAUNCH, str(N_LOCAL), *argv, "--outdir",
          str(out), multihost, store, str(N_PROCS), str(p), "--shard"]
         for p in range(N_PROCS)], DEADLINE_S, cwd=REPO)
    return codes, out


def _props(path):
    return pd.read_csv(path / "celltypes_proportions.csv", index_col=0,
                       float_precision="round_trip")


def _ci(path, name):
    """A confidence-interval file's (lo, hi) cells as a float array."""
    df = pd.read_csv(path / name, index_col=0 if "celltypes" in name
                     else None)
    return np.array([[[float(v) for v in c.strip("()").split(",")]
                      for c in row] for row in df.values.astype(str)])


def _against_one(tmp_path, tag, samples, ref, *extra,
                 multihost="--multihost"):
    argv = _args(samples, ref, *extra)
    one = tmp_path / f"{tag}-one"
    assert torch_cli_main(argv + ["--outdir", str(one)]) == 0
    codes, two = _run_2d(tmp_path, tag, argv, multihost)
    assert codes == [0] * N_PROCS, codes
    want, got = _props(one), _props(two)
    assert list(got.index) == list(want.index)
    assert list(got.columns) == list(want.columns)
    np.testing.assert_allclose(got.values, want.values, rtol=0, atol=1e-8)
    return one, two


def test_cli_plain_solve_and_weights_bootstrap(tmp_path, fixture_files):
    one, two = _against_one(tmp_path, "weights", *fixture_files,
                            "--nbunknown", "1", "--iterations", "60", "10",
                            "--confidence", "90", "5", "--cimethod",
                            "weights")
    prof = pd.read_csv(one / "methylation_profile_estimate.csv")
    parts = pd.concat(
        [pd.read_csv(two / f"methylation_profile_estimate.part{r:04d}.csv",
                     index_col=0) for r in range(N_PROCS * N_LOCAL)])
    assert list(parts.index) == list(range(len(prof)))
    np.testing.assert_allclose(parts.values, prof.values, rtol=0, atol=1e-8)
    for name in ("confidence_interval_celltypes_proportions.csv",
                 "confidence_interval_methylation_estimate.csv"):
        np.testing.assert_allclose(_ci(two, name), _ci(one, name), rtol=0,
                                   atol=1e-8)


def test_cli_ic_sweep(tmp_path, fixture_files):
    one, two = _against_one(tmp_path, "ic", *fixture_files, "--ic", "AIC",
                            "--icmax", "3", "--iterations", "60", "10")
    assert (open(one / "log.log").read().splitlines()[1]
            == open(two / "log.log").read().splitlines()[1])
    np.testing.assert_allclose(
        pd.read_csv(two / "methylation_profile_estimate.csv").values,
        pd.read_csv(one / "methylation_profile_estimate.csv").values,
        rtol=0, atol=1e-8)


def test_cli_resample_bootstrap(tmp_path, fixture_files):
    one, two = _against_one(tmp_path, "resample", *fixture_files,
                            "--nbunknown", "1", "--iterations", "40", "10",
                            "--confidence", "90", "5", "--cimethod",
                            "resample", multihost="--multih")
    for name in ("confidence_interval_celltypes_proportions.csv",
                 "confidence_interval_methylation_estimate.csv"):
        np.testing.assert_allclose(_ci(two, name), _ci(one, name), rtol=0,
                                   atol=1e-8)


@pytest.mark.parametrize("spelling", ["--multihost", "--multih", "--mu"])
def test_workers_drop_multihost_under_any_prefix(spelling):
    argv = ["--methfreq", "a.bed", spelling, "h:1", "2", "1", "--shard",
            "--iterations", "5", "5", spelling, "h:2", "2", "0"]
    assert _worker_argv(argv) == ["--methfreq", "a.bed", "--iterations",
                                  "5", "5"]


def test_a_failing_worker_stops_the_others(tmp_path, fixture_files):
    """Process 1's workers fail at their input (a file that does not
    exist) after joining; process 0's workers, waiting in a collective,
    stop too, long before the deadline."""
    samples, ref = fixture_files
    argv = _args(samples, ref, "--nbunknown", "1", "--iterations", "20",
                 "5")
    out = tmp_path / "fail"
    store = "file://" + str(tmp_path / "fail-store")
    bad = [a if a != samples[0] else str(tmp_path / "missing.bed")
           for a in argv]
    t0 = time.monotonic()
    codes = run_ranks(
        [[sys.executable, "-c", LAUNCH, str(N_LOCAL), *(argv if p == 0
                                                        else bad),
          "--outdir", str(out), "--multihost", store, str(N_PROCS), str(p),
          "--shard"] for p in range(N_PROCS)], DEADLINE_S, cwd=REPO)
    assert all(c != 0 for c in codes), codes
    assert time.monotonic() - t0 < DEADLINE_S / 2
