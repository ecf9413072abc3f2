"""The port's CLI, writers and init on the CPU, against the JAX package's.

- supervised mode (deterministic WLS): proportions within 1e-10 of the
  JAX CLI's, identical headers and index labels;
- partial-reference mode: the random inits of the two packages differ
  (torch cannot draw jax.random's numbers), so the same files and shapes,
  columns on the simplex, and proportions RMSE < 0.1 against the JAX
  CLI's output;
- the writers produce the same text as the JAX package's pandas writers;
- init draws have the right shape and support, and the zero-guard holds.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from demethify_tpu.cli import main as jax_cli_main
from demethify_tpu.io import writers as jwriters
from demethify_tpu_torch.cli import main as torch_cli_main
from demethify_tpu_torch.io import readers, writers
from demethify_tpu_torch.solvers.init import init_partial, zero_guard

N_CPG, N_S, N_CT = 400, 4, 3


def _write_fixture(root, seed=0):
    """Simulated bedmethyl inputs: N_CT known cell types + 1 unknown."""
    rng = np.random.default_rng(seed)
    R = rng.uniform(size=(N_CPG, N_CT + 1))
    alpha = rng.dirichlet(np.ones(N_CT + 1), size=N_S).T
    cov = rng.poisson(40, size=(N_CPG, N_S)) + 1
    meth = np.clip(R @ alpha + 0.01 * rng.normal(size=(N_CPG, N_S)), 0, 1)
    ref = os.path.join(root, "ref.bed")
    with open(ref, "w") as f:
        f.write("chrom\tstart\tend\t" + "\t".join(
            f"ct{c}" for c in range(N_CT)) + "\n")
        for i in range(N_CPG):
            f.write(f"chr1\t{i}\t{i + 1}\t" + "\t".join(
                f"{v:.6f}" for v in R[i, :N_CT]) + "\n")
    samples = []
    for s in range(N_S):
        path = os.path.join(root, f"sample{s}.bed")
        with open(path, "w") as f:
            f.write("chrom\tstart\tend\tvalid_coverage\tcount_modified\t"
                    "percent_modified\n")
            for i in range(N_CPG):
                m = meth[i, s]
                f.write(f"chr1\t{i}\t{i + 1}\t{cov[i, s]}\t"
                        f"{int(round(m * cov[i, s]))}\t{100 * m:.4f}\n")
        samples.append(path)
    return samples, ref


@pytest.fixture
def fixture_files(tmp_path):
    return _write_fixture(str(tmp_path))


def _run_both(tmp_path, samples, ref, *extra):
    base = ["--methfreq", *samples, "--ref", ref, "--bedmethyl",
            "--noprint", "--dtype", "float64", *extra]
    out_j, out_t = tmp_path / "jax", tmp_path / "torch"
    assert jax_cli_main(base + ["--outdir", str(out_j),
                                "--platform", "cpu"]) == 0
    assert torch_cli_main(base + ["--outdir", str(out_t),
                                  "--device", "cpu"]) == 0
    return out_j, out_t


def _props(path):
    return pd.read_csv(path / "celltypes_proportions.csv", index_col=0)


def test_supervised_matches_jax(tmp_path, fixture_files):
    out_j, out_t = _run_both(tmp_path, *fixture_files)
    want, got = _props(out_j), _props(out_t)
    assert got.index.name == want.index.name == "Cell types"
    assert list(got.index) == list(want.index)
    assert list(got.columns) == list(want.columns)
    np.testing.assert_allclose(got.values, want.values, rtol=0, atol=1e-10)


def test_partial_ref_close_to_jax(tmp_path, fixture_files):
    out_j, out_t = _run_both(tmp_path, *fixture_files, "--nbunknown", "1",
                             "--iterations", "300", "10", "--trace")
    want, got = _props(out_j), _props(out_t)
    assert list(got.index) == list(want.index)
    assert list(got.columns) == list(want.columns)
    np.testing.assert_allclose(got.values.sum(axis=0), 1.0, atol=1e-10)
    assert (got.values >= 0).all()
    rmse = np.sqrt(np.mean((got.values - want.values) ** 2))
    assert rmse < 0.1
    for name in ("methylation_profile_estimate.csv", "cost_trajectory.csv",
                 "log.log"):
        assert os.path.exists(out_t / name), name
    prof_j = pd.read_csv(out_j / "methylation_profile_estimate.csv")
    prof_t = pd.read_csv(out_t / "methylation_profile_estimate.csv")
    assert list(prof_t.columns) == list(prof_j.columns)
    assert prof_t.shape == prof_j.shape == (N_CPG, 1)


@pytest.mark.parametrize("flag", [["--purity", "50", "50", "50", "50"],
                                  ["--ic", "AIC"], ["--savestate", "x"],
                                  ["--dtype", "bfloat16"], ["--no-ref"]])
def test_unported_flags_exit_with_roadmap_item(tmp_path, fixture_files,
                                               flag, capsys):
    samples, ref = fixture_files
    argv = ["--methfreq", *samples, "--bedmethyl", "--noprint",
            "--outdir", str(tmp_path / "o"), "--device", "cpu"]
    argv += [] if flag == ["--no-ref"] else ["--ref", ref, *flag]
    with pytest.raises(SystemExit) as exc:
        torch_cli_main(argv)
    assert "ROADMAP port queue item" in str(exc.value.code)


def test_readers_match_fixture(tmp_path, fixture_files):
    samples, ref = fixture_files
    ds = readers.load_dataset(samples, ref=ref, bedmethyl=True)
    assert ds.meth_f.shape == ds.counts.shape == (N_CPG, N_S)
    assert ds.ref.shape == (N_CPG, N_CT)
    assert ds.header == [f"ct{c}" for c in range(N_CT)]
    assert ds.sample_names == [f"sample{s}.bed" for s in range(N_S)]
    csv_path = tmp_path / "s.csv"
    csv_path.write_text("percent_modified,valid_coverage\n0.5,\nNA,20\n")
    meth, counts = readers.read_csv_samples([str(csv_path)], fillna=True)
    np.testing.assert_allclose(meth[:, 0], [0.5, 0.0])
    np.testing.assert_allclose(counts[:, 0], [0.0, 20.0])
    parsed = readers._parse_csv_module(str(csv_path), ["percent_modified",
                                                       "valid_coverage"], ",")
    assert np.isnan(parsed[1, 0]) and np.isnan(parsed[0, 1])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_writers_match_jax_text(tmp_path, dtype):
    rng = np.random.default_rng(4)
    props = rng.dirichlet(np.ones(3), size=2).T
    props[0, 0] = 1e-5
    u = rng.uniform(size=(7, 2)).astype(dtype)
    u[3, 1] = np.nan
    header, samples = ["A", "B,x", 'q"'], ["s1.bed", "s 2.bed"]
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jwriters.write_proportions(str(tmp_path / "j"), props, header, samples)
    writers.write_proportions(str(tmp_path / "t"), props, header, samples)
    jwriters.write_profile_estimate(str(tmp_path / "j"), u, ["u1", "u2"])
    writers.write_profile_estimate(str(tmp_path / "t"), u, ["u1", "u2"])
    for name in ("celltypes_proportions.csv",
                 "methylation_profile_estimate.csv"):
        assert ((tmp_path / "t" / name).read_text()
                == (tmp_path / "j" / name).read_text()), name


@pytest.mark.parametrize("init", ["uniform_", "beta", "uniform"])
def test_init_draws(small_problem, init):
    p = small_problem
    y, d, Rt = (torch.tensor(p[k]) for k in ("y", "d", "R_trunc"))
    g = torch.Generator().manual_seed(5)
    u, alpha = init_partial(g, init, y, d, Rt, p["n_u"])
    assert u.shape == (y.shape[0], p["n_u"])
    assert alpha.shape == (Rt.shape[1] + p["n_u"], y.shape[1])
    assert u.dtype == alpha.dtype == torch.float64
    assert ((u >= 0) & (u <= 1)).all()
    assert (alpha >= 0).all()
    if init == "uniform":
        # NNLS puts exact zeros in the first unknown row, so the
        # zero-guard may replace that row: sums are then at most 1
        assert (alpha.sum(0) <= 1.0 + 1e-9).all()
    else:
        np.testing.assert_allclose(alpha.sum(0).numpy(), 1.0, atol=1e-9)
    g2 = torch.Generator().manual_seed(5)
    u2, _ = init_partial(g2, init, y, d, Rt, p["n_u"])
    assert torch.equal(u, u2)                      # seeded: reproducible


def test_beta_init_is_arcsine():
    g = torch.Generator().manual_seed(0)
    y = torch.zeros((20000, 2), dtype=torch.float64)
    u, _ = init_partial(g, "beta", y, y, torch.zeros((20000, 1),
                                                     dtype=torch.float64), 1)
    # Beta(1/2, 1/2): mean 1/2, variance 1/8
    assert abs(float(u.mean()) - 0.5) < 0.01
    assert abs(float(u.var()) - 0.125) < 0.01


def test_zero_guard():
    alpha = torch.tensor([[0.6, 0.5], [0.4, 0.5], [0.0, 0.0]],
                         dtype=torch.float64)
    alpha[2, 1] = 0.0
    out = zero_guard(alpha, 1)
    np.testing.assert_allclose(out[2].numpy(), 1e-10)
    np.testing.assert_allclose(out[:2].numpy(), alpha[:2].numpy()
                               * (1 - 1e-10))
    untouched = torch.tensor([[0.7], [0.3]], dtype=torch.float64)
    assert torch.equal(zero_guard(untouched, 1), untouched)
    two = torch.tensor([[0.5], [0.0], [0.5]], dtype=torch.float64)
    out2 = zero_guard(two, 2)                      # first unknown row fixed
    np.testing.assert_allclose(out2[:, 0].numpy(),
                               [0.5 * (1 - 1e-10), 1e-10, 0.5])
