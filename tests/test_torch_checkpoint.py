"""The port's checkpoints (``--savestate`` / ``--initstate``,
``demethify_tpu_torch/checkpoint.py``) against the JAX CLI's orbax ones.

- a checkpoint written by the JAX CLI, read with orbax here (the JAX
  package's ``load_factors``) and saved in the port's format, warm-starts
  the port's CLI to the JAX CLI's own ``--initstate`` proportions within
  1e-8 (float64), in the partial-reference and purity modes;
- the refusals of ``--initstate`` (with ``--ic``, in the reference-based
  mode, and a checkpoint with more rows than the input) exit 1 with the
  JAX CLI's message; a checkpoint with fewer rows is padded with zero
  rows by both CLIs, which then agree;
- the format: round trip, row ranges, bf16 factors saved as float32, and
  a directory that holds no checkpoint.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from demethify_tpu.checkpoint import load_factors as jax_load_factors
from demethify_tpu.cli import main as jax_cli_main
from demethify_tpu_torch.checkpoint import load_factors, save_factors
from demethify_tpu_torch.cli import main as torch_cli_main
from tests.test_torch_cli import _write_fixture

N_CPG = 301
FLAGS = ("--nbunknown", "1", "--iterations", "40", "10")


def _args(samples, ref, outdir, *extra):
    return ["--methfreq", *samples, "--bedmethyl", "--noprint", "--dtype",
            "float64", "--ref", ref, "--outdir", str(outdir), *extra]


def _jax(samples, ref, outdir, *extra):
    return jax_cli_main(_args(samples, ref, outdir, "--platform", "cpu",
                              *extra))


def _torch(samples, ref, outdir, *extra):
    return torch_cli_main(_args(samples, ref, outdir, "--device", "cpu",
                                *extra))


def _convert(jax_path, port_path):
    """A JAX-CLI orbax checkpoint -> the port's format."""
    state = jax_load_factors(str(jax_path), as_numpy=True)
    save_factors(str(port_path), alpha=state["alpha"], cost=state["cost"],
                 u=state["u"])
    return state


def _props(path):
    return pd.read_csv(path / "celltypes_proportions.csv", index_col=0)


@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    return _write_fixture(str(tmp_path_factory.mktemp("ckpt")), seed=5,
                          n_cpg=N_CPG)


@pytest.mark.parametrize("mode", ["partial-ref", "purity"])
def test_warm_start_from_a_jax_checkpoint(tmp_path, fixture_files, mode):
    extra = FLAGS + (("--purity", "20", "40", "60", "80")
                     if mode == "purity" else ())
    jckpt, pckpt = tmp_path / "jax-ckpt", tmp_path / "port-ckpt"
    assert _jax(*fixture_files, tmp_path / "first", *extra,
                "--savestate", str(jckpt)) == 0
    state = _convert(jckpt, pckpt)
    got = load_factors(str(pckpt))
    for key in ("alpha", "cost", "u"):
        np.testing.assert_array_equal(got[key], state[key])
    assert got["n_rows"] == N_CPG
    assert _jax(*fixture_files, tmp_path / "jax", *extra, "--initstate",
                str(jckpt)) == 0
    assert _torch(*fixture_files, tmp_path / "torch", *extra, "--initstate",
                  str(pckpt)) == 0
    want, have = _props(tmp_path / "jax"), _props(tmp_path / "torch")
    assert list(have.index) == list(want.index)
    np.testing.assert_allclose(have.values, want.values, rtol=0, atol=1e-8)
    np.testing.assert_allclose(
        pd.read_csv(tmp_path / "torch" / "methylation_profile_estimate.csv"
                    ).values,
        pd.read_csv(tmp_path / "jax" / "methylation_profile_estimate.csv"
                    ).values, rtol=0, atol=1e-8)


def test_savestate_holds_the_run(tmp_path, fixture_files):
    ckpt = tmp_path / "ckpt"
    assert _torch(*fixture_files, tmp_path / "run", *FLAGS, "--savestate",
                  str(ckpt)) == 0
    state = load_factors(str(ckpt))
    props = pd.read_csv(tmp_path / "run" / "celltypes_proportions.csv",
                        index_col=0, float_precision="round_trip")
    prof = pd.read_csv(tmp_path / "run" / "methylation_profile_estimate.csv",
                       float_precision="round_trip")
    np.testing.assert_array_equal(state["alpha"], props.values)
    np.testing.assert_array_equal(state["u"], prof.values)
    assert state["cost"].shape == () and np.isfinite(state["cost"])


@pytest.mark.parametrize("refusal", ["ic", "supervised", "more rows"])
def test_refusals_match_the_jax_cli(tmp_path, fixture_files, capsys,
                                   refusal):
    ckpt = tmp_path / "ckpt"
    rows = N_CPG + 9 if refusal == "more rows" else N_CPG
    save_factors(str(ckpt), alpha=np.full((4, 4), 0.25), cost=np.float64(1),
                 u=np.full((rows, 1), 0.5))
    jckpt = tmp_path / "jckpt"
    if refusal == "more rows":
        from demethify_tpu.checkpoint import save_factors as jax_save
        jax_save(str(jckpt), alpha=np.full((4, 4), 0.25),
                 cost=np.float64(1), u=np.full((rows, 1), 0.5))
    extra = {"ic": ("--ic", "AIC", "--icmax", "2"), "supervised": (),
             "more rows": FLAGS}[refusal]
    messages = []
    for run, path in ((_jax, jckpt), (_torch, ckpt)):
        with pytest.raises(SystemExit) as e:
            run(*fixture_files, tmp_path / "out", *extra, "--initstate",
                str(path))
        assert e.value.code == 1
        messages.append(capsys.readouterr().err)
    assert messages[0] == messages[1]
    assert "--initstate" in messages[1]


def test_fewer_rows_are_padded_as_the_jax_cli_pads_them(tmp_path,
                                                       fixture_files):
    from demethify_tpu.checkpoint import save_factors as jax_save

    rng = np.random.default_rng(1)
    state = dict(alpha=rng.dirichlet(np.ones(4), size=4).T,
                 cost=np.float64(1.0), u=rng.uniform(size=(N_CPG - 50, 1)))
    jax_save(str(tmp_path / "jckpt"), **state)
    save_factors(str(tmp_path / "ckpt"), **state)
    assert _jax(*fixture_files, tmp_path / "jax", *FLAGS, "--initstate",
                str(tmp_path / "jckpt")) == 0
    assert _torch(*fixture_files, tmp_path / "torch", *FLAGS, "--initstate",
                  str(tmp_path / "ckpt")) == 0
    np.testing.assert_allclose(_props(tmp_path / "torch").values,
                               _props(tmp_path / "jax").values, rtol=0,
                               atol=1e-8)


def test_format_round_trip_and_row_ranges(tmp_path):
    rng = np.random.default_rng(2)
    u, alpha = rng.uniform(size=(10, 2)), rng.uniform(size=(3, 4))
    save_factors(str(tmp_path / "a"), alpha=torch.as_tensor(alpha),
                 cost=torch.tensor(2.5, dtype=torch.float64),
                 u=torch.as_tensor(u))
    got = load_factors(str(tmp_path / "a"))
    np.testing.assert_array_equal(got["u"], u)
    np.testing.assert_array_equal(got["alpha"], alpha)
    assert got["cost"] == 2.5 and got["n_rows"] == 10
    np.testing.assert_array_equal(
        load_factors(str(tmp_path / "a"), rows=(3, 7))["u"], u[3:7])
    assert load_factors(str(tmp_path / "a"), rows=(8, 14))["u"].shape == (
        2, 2)
    assert load_factors(str(tmp_path / "a"), rows=(12, 14))["u"].shape == (
        0, 2)
    # bf16 factors are saved as float32; no u in the reference-based mode
    save_factors(str(tmp_path / "a"), alpha=torch.ones(3, 4).bfloat16(),
                 cost=torch.tensor(1.0))
    got = load_factors(str(tmp_path / "a"))
    assert got["alpha"].dtype == np.float32 and got["n_rows"] is None
    assert "u" not in got
    with pytest.raises(FileNotFoundError):
        load_factors(str(tmp_path))
