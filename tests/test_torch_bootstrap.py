"""The port's bootstrap confidence intervals on the CPU
(``demethify_tpu_torch/uncertainty/bootstrap.py``, the CI writers and
``--confidence`` / ``--cimethod`` of the CLI) against the JAX package.

torch cannot draw ``jax.random``'s numbers, so the intervals are compared
with the same injected resample draws and inits: the port's
``bootstrap_ci(indices=, inits=)`` against the JAX package's replicate
solves on the same draws (the weighted solvers with ``row_weights`` for
the weights layout, the solvers on the gathered rows for the resample
layout, the WLS for the supervised mode) and its ``_percentiles``.
Tolerance: float64, atol 1e-8 on every bound (the solvers' state bound of
tests/test_torch_restarts.py; the percentiles interpolate linearly between
replicate values). The CLI's intervals use each package's own draws, so
there the files, shapes, labels and the ordering lo <= hi are held, and
the writers' bytes are held exactly.
"""

import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from demethify_tpu.cli import main as jax_cli_main
from demethify_tpu.io import writers as jwriters
from demethify_tpu.ops.nnls import wls_intercept_batch as j_wls
from demethify_tpu.solvers.partial_ref import partial_ref_solve as j_partial
from demethify_tpu.solvers.purity import purity_solve as j_purity
from demethify_tpu.solvers.unsupervised import unsupervised_solve as j_unsup
from demethify_tpu.uncertainty.bootstrap import _percentiles as j_percentiles
from demethify_tpu.uncertainty.bootstrap import (
    resolve_method as j_resolve_method,
)
from demethify_tpu_torch.cli import main as torch_cli_main
from demethify_tpu_torch.io import writers
from demethify_tpu_torch.ops import cuda_multi
from demethify_tpu_torch.solvers import api
from demethify_tpu_torch.uncertainty import bootstrap
from demethify_tpu_torch.solvers.init import init_partial
from demethify_tpu_torch.uncertainty.bootstrap import bootstrap_ci

N_BOOT, LEVEL = 5, 90.0
KW = dict(n_iter1=8, n_iter2=5, tol=1e-9)


def _draws(p, mode, seed):
    """Injected resample indices and per-replicate inits (numpy)."""
    rng = np.random.default_rng(seed)
    y, Rt, n_u = p["y"], p["R_trunc"], p["n_u"]
    n, n_s = y.shape
    n_ct = 0 if mode == "unsupervised" else Rt.shape[1]
    indices = rng.integers(0, n, size=(N_BOOT, n))
    inits = []
    purity = rng.uniform(0.3, 0.7, size=n_s) if mode == "purity" else None
    for _ in range(N_BOOT):
        u0 = rng.uniform(size=(n, n_u))
        a0 = rng.dirichlet(np.ones(n_ct + n_u), size=n_s).T
        if purity is not None:
            a0[:n_ct] *= purity / a0[:n_ct].sum(0)
            a0[n_ct:] *= (1 - purity) / a0[n_ct:].sum(0)
        inits.append((u0, a0))
    return indices, inits, purity


def _jax_replicates(p, mode, method, indices, inits, purity):
    """The JAX package's replicate solves on the given draws:
    (props (B, p, n_s), u (B, n, n_u) or None)."""
    j = jnp.asarray
    y, d, Rt, n_u = p["y"], p["d"], p["R_trunc"], p["n_u"]
    n = y.shape[0]
    props, us = [], []
    for idx, (u0, a0) in zip(indices, inits):
        if method == "weights":
            w = j(np.bincount(idx, minlength=n).astype(np.float64))
            yb, db, rb = j(y), j(d), j(Rt)
            kw = dict(KW, row_weights=w)
        else:
            w = None
            yb, db, rb = j(y[idx]), j(d[idx]), j(Rt[idx])
            kw = KW
        if mode == "supervised":
            dw = db if w is None else db * w[:, None]
            props.append(np.asarray(j_wls(db * yb, dw, rb)))
            continue
        if mode == "unsupervised":
            u, a, _ = j_unsup(j(u0), j(a0), yb, db, n_u, **kw)
        elif mode == "purity":
            u, a, _ = j_purity(j(u0), j(a0), yb, db, rb, j(purity), n_u,
                               **kw)
        else:
            u, a, _ = j_partial(j(u0), j(a0), yb, db, rb, n_u, **kw)
        props.append(np.asarray(a))
        us.append(np.asarray(u))
    return np.stack(props), (np.stack(us) if us else None)


@pytest.mark.parametrize("method", ["weights", "resample"])
@pytest.mark.parametrize("mode", ["partial", "purity", "unsupervised",
                                  "supervised"])
def test_bootstrap_ci_matches_jax_replicates(small_problem, mode, method):
    p = small_problem
    indices, inits, purity = _draws(p, mode, seed=7)
    props, us = _jax_replicates(p, mode, method, indices, inits, purity)
    want = list(j_percentiles(props, LEVEL))
    if us is not None:
        want += list(j_percentiles(us, LEVEL))
    ref = None if mode == "unsupervised" else torch.tensor(p["R_trunc"])
    got = bootstrap_ci(torch.tensor(p["y"]), torch.tensor(p["d"]), ref,
                       0 if mode == "supervised" else p["n_u"],
                       level=LEVEL, n_bootstrap=N_BOOT, method=method,
                       purity=purity, indices=indices, inits=inits, **KW)
    if mode == "supervised":
        assert got[2] is None and got[3] is None
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-8)
    assert cuda_multi.u_phase_grams_multi.launches == 0


def test_chunking_does_not_change_the_intervals(small_problem, monkeypatch):
    """Replicates per multi-solver call 3 (chunks 3 + 3 + 1) or 8 (one
    call): the same draws by the same generators, the same intervals."""
    p = small_problem
    args = (torch.tensor(p["y"]), torch.tensor(p["d"]),
            torch.tensor(p["R_trunc"]), p["n_u"])
    kw = dict(level=LEVEL, n_bootstrap=7, method="weights", seed=3,
              init_option="uniform", **KW)
    monkeypatch.setattr(bootstrap, "CPU_MEMBERS", 3)
    small = bootstrap_ci(*args, **kw)
    monkeypatch.setattr(bootstrap, "CPU_MEMBERS", 8)
    whole = bootstrap_ci(*args, **kw)
    for a, b in zip(small, whole):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_weights_direct_form_runs_the_plain_weighted_solver(small_problem):
    """n_u^2 > 3 n_s (one sample, two unknowns): the weights layout runs
    the plain weighted solver per replicate on the CPU, as JAX does."""
    p = dict(small_problem)
    p["y"], p["d"] = p["y"][:, :1], p["d"][:, :1]
    indices, inits, _ = _draws(p, "partial", seed=9)
    props, us = _jax_replicates(p, "partial", "weights", indices, inits,
                                None)
    got = bootstrap_ci(torch.tensor(p["y"]), torch.tensor(p["d"]),
                       torch.tensor(p["R_trunc"]), p["n_u"], level=LEVEL,
                       n_bootstrap=N_BOOT, method="weights", indices=indices,
                       inits=inits, **KW)
    for g, w in zip(got, [*j_percentiles(props, LEVEL),
                          *j_percentiles(us, LEVEL)]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-8)


@pytest.mark.parametrize("method,init,n_elems", [
    ("auto", "uniform_", 1_999_999), ("auto", "uniform_", 2_000_000),
    ("auto", "SVD", 10_000_000), ("resample", "uniform_", 10 ** 8),
    ("weights", "beta", 10)])
def test_resolve_method_as_jax(method, init, n_elems):
    assert (bootstrap.resolve_method(method, init, n_elems)
            == j_resolve_method(method, init, n_elems))


def test_replicate_generators_keyed_by_global_index():
    """Replicate r's draws do not depend on how many replicates run, and
    differ from the restart generators' draws."""
    a = [torch.rand(3, generator=bootstrap.replicate_generator(4, r, "cpu"))
         for r in range(3)]
    b = torch.rand(3, generator=bootstrap.replicate_generator(4, 2, "cpu"))
    assert torch.equal(a[2], b) and not torch.equal(a[0], a[1])
    restart = torch.rand(3, generator=api.restart_generators(4, 3, "cpu")[2])
    assert not torch.equal(restart, b)


def test_svd_ica_in_the_weights_layout_name_item_4(small_problem):
    """Item 4 is ported: the weights layout gives every replicate the one
    SVD (ICA) init of the full data."""
    p = small_problem
    y, d, Rt = (torch.tensor(p[k]) for k in ("y", "d", "R_trunc"))
    indices, _, _ = _draws(p, "partial", seed=5)
    for option in ("SVD", "ICA"):
        shared = init_partial(None, option, y, d, Rt, p["n_u"])
        kw = dict(level=LEVEL, n_bootstrap=N_BOOT, method="weights",
                  indices=indices, **KW)
        got = bootstrap_ci(y, d, Rt, p["n_u"], init_option=option, **kw)
        want = bootstrap_ci(y, d, Rt, p["n_u"], inits=[shared] * N_BOOT,
                            **kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="n_u > 0"):
        bootstrap_ci(torch.tensor(p["y"]), torch.tensor(p["d"]), None, 0,
                     level=LEVEL, n_bootstrap=2)


# ------------------------------------------------------------ writers, CLI
def test_ci_writers_match_jax_bytes(tmp_path):
    rng = np.random.default_rng(5)
    lo = rng.uniform(size=(3, 2))
    lo[0, 0], lo[1, 1] = 1e-5, 0.0
    hi = lo + rng.uniform(size=lo.shape)
    ulo = rng.uniform(size=(9, 2)).astype(np.float32)
    uhi = ulo + 0.1
    names, samples = ["A", "B,x", 'q"'], ["s1.bed", "s 2.bed"]
    for tag, mod in (("j", jwriters), ("t", writers)):
        (tmp_path / tag).mkdir()
        mod.write_ci_proportions(str(tmp_path / tag), lo, hi, names, samples)
        mod.write_ci_profile(str(tmp_path / tag), ulo, uhi, ["u1", "u2"])
    for name in ("confidence_interval_celltypes_proportions.csv",
                 "confidence_interval_methylation_estimate.csv"):
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name


def _write_fixture(root, n=300, n_s=4, n_ct=3, seed=0):
    rng = np.random.default_rng(seed)
    R = rng.uniform(size=(n, n_ct + 1))
    alpha = rng.dirichlet(np.ones(n_ct + 1), size=n_s).T
    cov = rng.poisson(40, size=(n, n_s)) + 1
    meth = np.clip(R @ alpha + 0.01 * rng.normal(size=(n, n_s)), 0, 1)
    ref = os.path.join(root, "ref.bed")
    with open(ref, "w") as f:
        f.write("chrom\tstart\tend\t" + "\t".join(
            f"ct{c}" for c in range(n_ct)) + "\n")
        for i in range(n):
            f.write(f"chr1\t{i}\t{i + 1}\t" + "\t".join(
                f"{v:.6f}" for v in R[i, :n_ct]) + "\n")
    samples = []
    for s in range(n_s):
        path = os.path.join(root, f"sample{s}.bed")
        with open(path, "w") as f:
            f.write("chrom\tstart\tend\tvalid_coverage\tcount_modified\t"
                    "percent_modified\n")
            for i in range(n):
                m = meth[i, s]
                f.write(f"chr1\t{i}\t{i + 1}\t{cov[i, s]}\t"
                        f"{int(round(m * cov[i, s]))}\t{100 * m:.4f}\n")
        samples.append(path)
    return samples, ref


def _ci(path, index=True):
    df = pd.read_csv(path, index_col=0 if index else None)
    pairs = np.array([[[float(x) for x in c.strip("()").split(",")]
                       for c in row] for row in df.values])
    return df, pairs[..., 0], pairs[..., 1]


@pytest.mark.parametrize("cimethod", ["resample", "weights"])
@pytest.mark.parametrize("mode", ["supervised", "partial", "unsupervised"])
def test_cli_confidence_files_as_jax(tmp_path, mode, cimethod):
    samples, ref = _write_fixture(str(tmp_path))
    extra = {"supervised": ["--ref", ref],
             "partial": ["--ref", ref, "--nbunknown", "1"],
             "unsupervised": ["--nbunknown", "2"]}[mode]
    base = ["--methfreq", *samples, "--bedmethyl", "--noprint", "--dtype",
            "float64", "--confidence", "90", "4", "--cimethod", cimethod,
            "--iterations", "20", "5", *extra]
    out_j, out_t = tmp_path / "jax", tmp_path / "torch"
    assert jax_cli_main(base + ["--outdir", str(out_j), "--platform",
                                "cpu"]) == 0
    assert torch_cli_main(base + ["--outdir", str(out_t), "--device",
                                  "cpu"]) == 0
    name = "confidence_interval_celltypes_proportions.csv"
    df_j, lo_j, _ = _ci(out_j / name)
    df_t, lo_t, hi_t = _ci(out_t / name)
    assert df_t.index.name == df_j.index.name == "Cell Type"
    assert list(df_t.index) == list(df_j.index)
    assert list(df_t.columns) == list(df_j.columns)
    assert lo_t.shape == lo_j.shape and (lo_t <= hi_t).all()
    assert lo_t.min() >= 0 and hi_t.max() <= 1 + 1e-9
    prof = "confidence_interval_methylation_estimate.csv"
    assert os.path.exists(out_t / prof) == os.path.exists(out_j / prof) == (
        mode != "supervised")
    if mode != "supervised":
        pj, ulo_j, _ = _ci(out_j / prof, index=False)
        pt, ulo_t, uhi_t = _ci(out_t / prof, index=False)
        assert list(pt.columns) == list(pj.columns)
        assert ulo_t.shape == ulo_j.shape and (ulo_t <= uhi_t).all()
    # the point estimate still follows the intervals
    assert os.path.exists(out_t / "celltypes_proportions.csv")


def test_cli_confidence_without_ref_or_unknowns_fails_as_jax(
        tmp_path, capsys):
    samples, _ = _write_fixture(str(tmp_path), n=50)
    argv = ["--methfreq", *samples, "--bedmethyl", "--noprint",
            "--confidence", "95", "4"]
    with pytest.raises(SystemExit) as exc_j:
        jax_cli_main(argv + ["--outdir", str(tmp_path / "j"), "--platform",
                             "cpu"])
    err_j = capsys.readouterr().err
    with pytest.raises(SystemExit) as exc_t:
        torch_cli_main(argv + ["--outdir", str(tmp_path / "t"), "--device",
                               "cpu"])
    err_t = capsys.readouterr().err
    assert exc_t.value.code == exc_j.value.code == 1
    assert err_t == err_j and "--confidence without --ref" in err_t
