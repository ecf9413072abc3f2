"""The port's figures (``--plot``) against the JAX package's, on the CPU.

- with matplotlib (this machine has it): the port's ``plot_proportions``
  on numpy arrays writes the same files as the JAX ``plot_proportions``
  on the same proportions, intervals and criterion values in pandas
  frames, with equal pixel arrays (``matplotlib.image.imread``): the
  stacked bar, the per-sample bars with and without whiskers, the IC
  curve; and the same palette;
- the CLI with ``--plot`` after an ``--ic`` run with ``--confidence``
  writes the three families; the bootstrap covers the known cell types
  only, and the port matches the intervals to the rows by name (the JAX
  CLI raises ValueError on the rows' count there);
- with matplotlib hidden (a ``sys.modules`` stub), ``--plot`` exits
  non-zero naming the package before any data is read (the input file
  does not exist).
"""

import os
import sys

import numpy as np
import pandas as pd
import pytest
from matplotlib.image import imread

from demethify_tpu.plotting import categorical_palette as jax_palette
from demethify_tpu.plotting import plot_proportions as jax_plot
from demethify_tpu_torch import plotting
from demethify_tpu_torch.cli import main as torch_cli_main
from tests.test_torch_cli import _write_fixture


def _case(n_ct=4, n_s=3, seed=0):
    rng = np.random.default_rng(seed)
    props = rng.dirichlet(np.ones(n_ct), size=n_s).T
    lo = np.clip(props - rng.uniform(0, 0.1, props.shape), 0, 1)
    hi = np.clip(props + rng.uniform(0, 0.1, props.shape), 0, 1)
    cells = [f"ct{i}" for i in range(n_ct - 1)] + ["unknown_cell_1"]
    samples = [f"sample{j}.bed" for j in range(n_s)]
    return props, lo, hi, cells, samples


def _jax_frames(props, lo, hi, cells, samples, with_ci):
    df = pd.DataFrame(props, index=cells, columns=samples)
    if not with_ci:
        return df, pd.DataFrame()
    ci = pd.DataFrame({s: [(float(lo[k, j]), float(hi[k, j]))
                           for k in range(len(cells))]
                       for j, s in enumerate(samples)}, index=cells)
    return df, ci


@pytest.mark.parametrize("with_ci,with_ic", [(True, True), (False, False)])
def test_same_files_and_pixels_as_jax(tmp_path, with_ci, with_ic):
    props, lo, hi, cells, samples = _case()
    list_ic = [5.0, 3.5, 4.25] if with_ic else None
    jax_plot(*_jax_frames(props, lo, hi, cells, samples, with_ci),
             str(tmp_path / "jax"), list_ic)
    plotting.plot_proportions(props, cells, samples, str(tmp_path / "port"),
                              (lo, hi) if with_ci else None, list_ic)
    want = sorted(os.listdir(tmp_path / "jax" / "plots"))
    assert sorted(os.listdir(tmp_path / "port" / "plots")) == want
    assert ("ic_plot.png" in want) == with_ic
    assert len(want) == 1 + len(samples) + int(with_ic)
    for name in want:
        a = imread(tmp_path / "jax" / "plots" / name)
        b = imread(tmp_path / "port" / "plots" / name)
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_same_palette_as_jax():
    for n in (1, 5, 30):
        assert plotting.categorical_palette(n) == jax_palette(n)


def test_cli_plot_after_a_sweep_with_intervals(tmp_path):
    samples, ref = _write_fixture(str(tmp_path), seed=6, n_cpg=120)
    argv = ["--methfreq", *samples, "--bedmethyl", "--noprint", "--dtype",
            "float64", "--device", "cpu", "--ref", ref, "--outdir",
            str(tmp_path / "out"), "--plot", "--ic", "AIC", "--icmax", "2",
            "--iterations", "20", "5", "--confidence", "90", "3"]
    assert torch_cli_main(argv) == 0
    names = sorted(os.listdir(tmp_path / "out" / "plots"))
    assert names == sorted(["ic_plot.png", "proportions_stackedbar.png"]
                           + [f"proportions_bar_{os.path.basename(s)[:-4]}"
                              ".png" for s in samples])


def test_plot_without_matplotlib_exits_before_reading(tmp_path, monkeypatch,
                                                      capsys):
    for name in [m for m in sys.modules if m == "matplotlib"
                 or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    missing = str(tmp_path / "missing.bed")
    with pytest.raises(SystemExit) as exc:
        torch_cli_main(["--methfreq", missing, "--ref", missing,
                        "--outdir", str(tmp_path / "o"), "--device", "cpu",
                        "--plot"])
    assert exc.value.code not in (0, None)
    assert "matplotlib" in str(exc.value.code)
    assert not (tmp_path / "o").exists()
