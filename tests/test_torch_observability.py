"""The port's ``--profile`` and ``--debugnans`` on the CPU, against the
JAX package's, and the port's parser against the JAX CLI's.

- ``--profile DIR``: the CLI writes a Chrome-trace JSON (events of the
  solve) into DIR, and its CSVs are byte-identical to the same run
  without the flag;
- ``--debugnans``, finite runs: the same bytes with and without the flag
  in every mode, with restarts and with the weights bootstrap;
- ``--debugnans``, a NaN run: an init whose unknown alpha block is zero
  (the 0/0 collapse of the reference's U step, ROADMAP queue 3) makes
  the JAX solver's u non-finite, and JAX under ``jax.debug_nans(True)``
  raises FloatingPointError; so do the port's plain, kernel and
  multi-member solvers (the kernels' twins here) and the CLI warm-started
  from such a checkpoint, naming the solver, the iteration and the array;
- ``--debugnans`` and the cost trace: JAX raises at ``record_trace=True``
  on a run that stops early (its NaN padding), the port does not, and its
  trace equals the run without the flag (ROADMAP queue 3);
- the parser: every option of the JAX CLI is accepted by the port's
  (``--platform`` by ``--device``), and nothing is refused.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demethify_tpu.cli import build_parser as jax_parser
from demethify_tpu.solvers.partial_ref import (
    partial_ref_solve as jax_partial_ref_solve,
)
from demethify_tpu_torch import utils
from demethify_tpu_torch.checkpoint import save_factors
from demethify_tpu_torch.cli import build_parser, main as torch_cli_main
from demethify_tpu_torch.solvers import fused
from demethify_tpu_torch.solvers.api import partial_reference_deconv
from demethify_tpu_torch.solvers.partial_ref import partial_ref_solve
from demethify_tpu_torch.solvers.purity import purity_solve
from demethify_tpu_torch.solvers.unsupervised import unsupervised_solve
from tests.test_torch_cli import N_S, _write_fixture

CSVS = ("celltypes_proportions.csv", "methylation_profile_estimate.csv",
        "confidence_interval_celltypes_proportions.csv",
        "confidence_interval_methylation_estimate.csv",
        "cost_trajectory.csv")


@pytest.fixture(autouse=True)
def _switch_off():
    yield
    utils.enable_nan_debugging(False)


@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    return _write_fixture(str(tmp_path_factory.mktemp("obs")), seed=2,
                          n_cpg=150)


def _cli(samples, ref, out, *extra):
    argv = ["--methfreq", *samples, "--bedmethyl", "--noprint", "--dtype",
            "float64", "--device", "cpu", "--outdir", str(out),
            *([] if ref is None else ["--ref", ref]), *extra]
    assert torch_cli_main(argv) == 0


def _same_csvs(a, b):
    found = [n for n in CSVS if (a / n).exists()]
    assert found and "celltypes_proportions.csv" in found
    for name in found:
        assert (b / name).read_bytes() == (a / name).read_bytes(), name
    return found


def test_profile_writes_a_trace_and_the_same_csvs(tmp_path, fixture_files):
    flags = ("--nbunknown", "1", "--iterations", "40", "10", "--trace")
    _cli(*fixture_files, tmp_path / "plain", *flags)
    _cli(*fixture_files, tmp_path / "prof", *flags, "--profile",
         str(tmp_path / "trace"))
    _same_csvs(tmp_path / "plain", tmp_path / "prof")
    assert os.listdir(tmp_path / "trace") == ["trace.json"]
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)


MODES = {
    "supervised": (True, ()),
    "partial": (True, ("--nbunknown", "1", "--iterations", "60", "10")),
    "partial restarts": (True, ("--nbunknown", "1", "--iterations", "40",
                                "10", "--restart", "3")),
    "purity": (True, ("--nbunknown", "1", "--iterations", "10", "40",
                      "--purity", *(["40"] * N_S))),
    "unsupervised": (False, ("--nbunknown", "2", "--iterations", "60",
                             "10", "--restart", "2")),
    "weights bootstrap": (True, ("--nbunknown", "1", "--iterations", "40",
                                 "10", "--confidence", "90", "4",
                                 "--cimethod", "weights", "--trace")),
    "sweep": (True, ("--ic", "AIC", "--icmax", "2", "--iterations", "30",
                     "10")),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_debugnans_keeps_a_finite_run_bit_identical(tmp_path, fixture_files,
                                                    mode):
    with_ref, flags = MODES[mode]
    samples, ref = fixture_files
    ref = ref if with_ref else None
    _cli(samples, ref, tmp_path / "off", *flags)
    _cli(samples, ref, tmp_path / "on", *flags, "--debugnans")
    _same_csvs(tmp_path / "off", tmp_path / "on")


def _nan_case(n=120, n_s=4, n_ct=3, seed=0):
    """A problem and an init whose unknown alpha block is zero: l_w = 0,
    and the first U step divides 0 by 0."""
    rng = np.random.default_rng(seed)
    R = rng.uniform(size=(n, n_ct))
    a = rng.dirichlet(np.ones(n_ct + 1), size=n_s).T
    u = rng.uniform(size=(n, 1))
    y = np.clip(np.hstack([R, u]) @ a, 0, 1)
    d = np.full((n, n_s), 30.0)
    u0 = rng.uniform(size=(n, 1))
    a0 = np.vstack([rng.dirichlet(np.ones(n_ct), size=n_s).T,
                    np.zeros((1, n_s))])
    return y, d, R, u0, a0


def test_jax_raises_on_the_nan_input():
    y, d, R, u0, a0 = _nan_case()
    args = [jnp.asarray(x) for x in (u0, a0, y, d, R)]
    _, alpha, _ = jax_partial_ref_solve(*args, 1, n_iter1=5, n_iter2=5)
    assert not np.isfinite(np.asarray(alpha)).all()
    with jax.debug_nans(True):
        with pytest.raises(FloatingPointError):
            jax_partial_ref_solve(*args, 1, n_iter1=5, n_iter2=5)


def _port_solvers():
    t = torch.as_tensor
    y, d, R, u0, a0 = (t(x) for x in _nan_case())
    purity = torch.full((y.shape[1],), 0.6, dtype=y.dtype)
    kw = dict(n_iter1=5, n_iter2=5)
    return {
        "partial_ref_solve": lambda: partial_ref_solve(
            u0, a0, y, d, R, 1, **kw),
        "purity_solve": lambda: purity_solve(
            u0, a0, y, d, R, purity, 1, **kw),
        "unsupervised_solve": lambda: unsupervised_solve(
            u0, a0[-1:], y, d, 1, **kw),
        "partial_ref_solve_fused": lambda: fused.partial_ref_solve_fused(
            u0, a0, y, d, R, 1, **kw),
        "partial_ref_solve_fused_multi":
            lambda: fused.partial_ref_solve_fused_multi(
                torch.stack([u0, u0]), torch.stack([a0, a0]), y, d, R, 1,
                **kw),
        "partial_reference_deconv": lambda: partial_reference_deconv(
            y, d, R, 1, init_provided=(u0, a0), **kw),
    }


@pytest.mark.parametrize("solver", list(_port_solvers()))
def test_port_raises_on_the_nan_input(solver):
    call = _port_solvers()[solver]
    out = call()            # off: the solve ends, with a non-finite value
    u, alpha = (out.u, out.proportions) if hasattr(out, "u") else out[:2]
    assert not (torch.isfinite(u).all() and torch.isfinite(alpha).all())
    utils.enable_nan_debugging()
    with pytest.raises(FloatingPointError, match="--debugnans: .*non-finite"):
        call()


def test_cli_raises_on_the_nan_input(tmp_path, fixture_files):
    samples, ref = fixture_files
    n = sum(1 for _ in open(ref)) - 1
    rng = np.random.default_rng(4)
    alpha = np.vstack([rng.dirichlet(np.ones(3), size=N_S).T,
                       np.zeros((1, N_S))])
    save_factors(str(tmp_path / "ckpt"), alpha=alpha, cost=np.asarray(1.0),
                 u=rng.uniform(size=(n, 1)))
    flags = ("--nbunknown", "1", "--iterations", "5", "5", "--initstate",
             str(tmp_path / "ckpt"))
    _cli(samples, ref, tmp_path / "off", *flags)
    with pytest.raises(FloatingPointError,
                       match="partial_ref_solve: non-finite"):
        _cli(samples, ref, tmp_path / "on", *flags, "--debugnans")


def _early_stop_case():
    rng = np.random.default_rng(1)
    y, d, R, u0, _ = _nan_case(seed=1)
    a0 = rng.dirichlet(np.ones(4), size=y.shape[1]).T
    return y, d, R, u0, a0, dict(n_iter1=500, n_iter2=5, tol=1e-2)


def test_jax_raises_on_its_trace_padding():
    y, d, R, u0, a0, kw = _early_stop_case()
    args = [jnp.asarray(x) for x in (u0, a0, y, d, R)]
    with jax.debug_nans(True):
        _, _, info = jax_partial_ref_solve(*args, 1, **kw)
        assert 0 < int(info["n_iter"]) < kw["n_iter1"]
        with pytest.raises(FloatingPointError):
            jax_partial_ref_solve(*args, 1, record_trace=True, **kw)


@pytest.mark.parametrize("solver", ["plain", "fused"])
def test_port_does_not_raise_on_its_trace_padding(solver):
    y, d, R, u0, a0, kw = (torch.as_tensor(x) if isinstance(x, np.ndarray)
                           else x for x in _early_stop_case())
    solve = (partial_ref_solve if solver == "plain"
             else fused.partial_ref_solve_fused)
    _, alpha_off, off = solve(u0, a0, y, d, R, 1, record_trace=True, **kw)
    utils.enable_nan_debugging()
    _, alpha_on, on = solve(u0, a0, y, d, R, 1, record_trace=True, **kw)
    assert 0 < on["n_iter"] < kw["n_iter1"]
    assert torch.isnan(on["trace"]).any()
    assert on["trace"].numpy().tobytes() == off["trace"].numpy().tobytes()
    assert torch.equal(alpha_on, alpha_off)


def _options(parser):
    return {s for a in parser._actions for s in a.option_strings}


def test_the_port_accepts_every_option_of_the_jax_cli(tmp_path):
    jax_opts = _options(jax_parser()) - {"-h", "--help"}
    port_opts = _options(build_parser())
    assert jax_opts - port_opts == {"--platform"}
    assert "--device" in port_opts
    argv = ["--methfreq", "a.bed", "--outdir", str(tmp_path), "--ref",
            "r.bed", "--nbunknown", "1", "--plot", "--profile", "p",
            "--debugnans", "--multihost", "localhost:1", "2", "0",
            "--shard", "--savestate", "s", "--trace", "--reltol",
            "--cimethod", "weights", "--confidence", "95", "4",
            "--restart", "2", "--seed", "3", "--init", "SVD",
            "--termination", "1e-3", "--iterations", "5", "5",
            "--fillna", "--noprint", "--bedmethyl", "--dtype", "float64",
            "--device", "cpu"]
    args = build_parser().parse_args(argv)
    assert args.plot and args.profile == "p" and args.debugnans
    assert args.multihost == ["localhost:1", "2", "0"] and args.shard
    from demethify_tpu_torch import cli
    assert not hasattr(cli, "NOT_PORTED")
