"""The port's host tools on the CPU against the JAX package's: the BED
intersection (``demethify-tpu-torch-intersect``), feature selection
(``demethify-tpu-torch-select``) and the simulator
(``demethify-tpu-torch-simulate``), and the pandas-free table text they
share (``io/table.py``).

- **Byte-identical files** with the JAX tools' on the JAX package's own
  fixtures (``tests/test_preprocessing.py``) and on seeded inputs written
  by pandas itself: an int column, a float column with a NaN in a
  dropped row (so pandas reads the whole column as float64 and prints
  ``1.0``), a string chromosome column, duplicate header names, an empty
  join, ``--subsample``, ``--randomknown``, ``--select``, ``--unknown``,
  a zero coverage (0/0 percent, an empty field).
- **The table text**: the port's float parser gives pandas' parse bit for
  bit (pandas' default parser is not the correctly rounded one), and a
  table read and written back is pandas' text.
- **Feature selection on the device path**, run through ``force_device``
  on the CPU in float32, held to the JAX device path in float32 (the JAX
  CLI runs it with x64 off; here the values are given to it in float32,
  which is what ``jnp.asarray`` makes of them then) and to the
  host's float64 scores, within float32 rounding (1e-5 of the largest
  variance score, 1e-4 of the largest SVD score: the SVD goes through
  the float32 Gram matrix); the rows kept are the same wherever the
  score gap exceeds that rounding.
"""

import io
import os

import numpy as np
import pandas as pd
import pytest

from demethify_tpu.preprocessing import feature_selection as jfs
from demethify_tpu.preprocessing import intersect as jint
from demethify_tpu import simulate as jsim
from demethify_tpu_torch.io.table import parse_float, read_table, write_table
from demethify_tpu_torch.preprocessing import feature_selection as tfs
from demethify_tpu_torch.preprocessing import intersect as tint
from demethify_tpu_torch import simulate as tsim


def _write_bed(path, rows, extra_cols):
    df = pd.DataFrame(rows, columns=["chrom", "start", "end"])
    for name, vals in extra_cols.items():
        df[name] = vals
    df.to_csv(path, sep="\t", index=False)
    return str(path)


def _same_files(a, b):
    assert [os.path.basename(p) for p in a] == [os.path.basename(p)
                                                 for p in b]
    for x, y in zip(a, b):
        assert open(y, "rb").read() == open(x, "rb").read(), y


# ------------------------------------------------------------ table text

def test_float_parser_matches_pandas():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(size=20000),
                        rng.normal(size=5000) * 1e10,
                        10 ** rng.uniform(-30, 30, 5000),
                        [0.0, -0.0, 1e16, 1e-5, 5e-324, 1e-320,
                         1.7976931348623157e308, 2.2250738585072014e-308,
                         123456789012345678901.0]])
    texts = [repr(v) for v in x.tolist()] + [
        "1", "-2", "+3.5", "007.50", ".5", "5.", "1e5", "1E-5", "-0",
        "0.000000000000000000012345678901234567", "12345678901234567890",
        " 2.5", "inf", "-Infinity"]
    want = pd.read_csv(io.StringIO("v\n" + "\n".join(texts) + "\n"))[
        "v"].to_numpy()
    got = np.array([parse_float(t) for t in texts])
    assert got.view(np.int64).tolist() == want.view(np.int64).tolist()
    for bad in ("", "e5", "1e", "1.2.3", "abc", "1e400", "-"):
        assert parse_float(bad) is None, bad


def test_table_round_trip_is_pandas_text(tmp_path):
    rng = np.random.default_rng(1)
    n = 300
    f = rng.uniform(size=n)
    f[7] = np.nan
    ints_nan = rng.integers(0, 9, n).astype(float)
    ints_nan[3] = np.nan
    df = pd.DataFrame({
        "chrom": [f"chr{i % 3}" for i in range(n)],
        "start": np.arange(n), "v": f, "w": ints_nan,
        "flag": [bool(i % 2) for i in range(n)],
        "s": ["a" if i % 5 else "" for i in range(n)],
        "big": rng.normal(size=n) * 1e12})
    df.columns = ["chrom", "start", "v", "v", "flag", "s", "big"]
    src = tmp_path / "in.tsv"
    df.to_csv(src, sep="\t", index=False)
    back = pd.read_csv(src, sep="\t")
    t = read_table(str(src))
    assert t.names == list(back.columns)
    write_table(str(tmp_path / "port.tsv"), t.names, t.columns)
    back.to_csv(tmp_path / "pandas.tsv", sep="\t", index=False)
    assert ((tmp_path / "port.tsv").read_bytes()
            == (tmp_path / "pandas.tsv").read_bytes())
    kept = t.dropna()
    write_table(str(tmp_path / "port_drop.tsv"), kept.names, kept.columns)
    back.dropna().to_csv(tmp_path / "pandas_drop.tsv", sep="\t",
                         index=False)
    assert ((tmp_path / "port_drop.tsv").read_bytes()
            == (tmp_path / "pandas_drop.tsv").read_bytes())
    one = pd.DataFrame({"x": [1.5, np.nan]})
    one.to_csv(tmp_path / "one.tsv", sep="\t", index=False)
    write_table(str(tmp_path / "one_port.tsv"), ["x"],
                [np.array([1.5, np.nan])])
    assert ((tmp_path / "one_port.tsv").read_bytes()
            == (tmp_path / "one.tsv").read_bytes())


# ----------------------------------------------------------- intersect

def _intersect_both(tmp_path, paths):
    want = jint.intersect_bed_files(paths, str(tmp_path / "jax"))
    got = tint.intersect_bed_files(paths, str(tmp_path / "port"))
    _same_files(want, got)
    return got


def test_intersect_jax_fixtures(tmp_path):
    a = _write_bed(tmp_path / "a.bed",
                   [("chr1", 0, 1), ("chr1", 5, 6), ("chr2", 0, 1)],
                   {"va": [1, 2, 3]})
    b = _write_bed(tmp_path / "b.bed",
                   [("chr1", 5, 6), ("chr2", 0, 1), ("chr3", 9, 10)],
                   {"vb": [10, 20, 30]})
    outs = _intersect_both(tmp_path, [a, b])
    assert pd.read_csv(outs[0], sep="\t")["va"].tolist() == [2, 3]
    paths = []
    for name, vals in [("c", [1, 2]), ("d", [3, 4]), ("e", [5, 6])]:
        paths.append(_write_bed(tmp_path / f"{name}.bed",
                                [("chr1", 0, 1), ("chr1", 9, 10)],
                                {f"v{name}": vals}))
    _intersect_both(tmp_path / "chain", paths)
    with pytest.raises(ValueError):
        tint.intersect_bed_files([a], str(tmp_path))


def test_intersect_overlap_semantics(tmp_path):
    """[10, 20) overlaps [15, 25) only (half-open intervals)."""
    a = _write_bed(tmp_path / "a.bed", [("chr1", 10, 20)], {"x": [1]})
    b = _write_bed(tmp_path / "b.bed",
                   [("chr1", 0, 10), ("chr1", 15, 25), ("chr1", 20, 30)],
                   {"y": [1, 2, 3]})
    outs = _intersect_both(tmp_path, [a, b])
    assert pd.read_csv(outs[1], sep="\t")["start"].tolist() == [15]


def _seeded_beds(root, seed, n=400):
    """A reference with duplicate header names and a NaN, and samples with
    overlapping, nested and missing intervals on three chromosomes."""
    rng = np.random.default_rng(seed)
    paths = []
    for k in range(3):
        m = n - 37 * k
        chrom = rng.choice(["chr1", "chr2", "chrX"], m)
        start = rng.integers(0, 2000, m)
        end = start + rng.integers(1, 6, m)
        df = pd.DataFrame({"chrom": chrom, "start": start, "end": end})
        if k == 0:
            vals = rng.uniform(size=(m, 3))
            vals[5, 1] = np.nan
            for j, name in enumerate(["ct", "ct", "other"]):
                df[f"c{j}"] = vals[:, j]
            df.columns = ["chrom", "start", "end", "ct", "ct", "other"]
        else:
            cov = rng.poisson(20, m)
            df["valid_coverage"] = cov
            df["count_modified"] = rng.binomial(cov, 0.4)
            df["percent_modified"] = df["count_modified"] / cov * 100
        path = os.path.join(root, f"bed{k}.bed")
        df.to_csv(path, sep="\t", index=False)
        paths.append(path)
    return paths


@pytest.mark.parametrize("seed", [0, 1])
def test_intersect_seeded_beds(tmp_path, seed):
    paths = _seeded_beds(str(tmp_path), seed)
    outs = _intersect_both(tmp_path, paths)
    assert pd.read_csv(outs[0], sep="\t").shape[0] > 0


def test_intersect_empty_join(tmp_path):
    a = _write_bed(tmp_path / "a.bed", [("chr1", 0, 1)], {"v": [1.5]})
    b = _write_bed(tmp_path / "b.bed", [("chr2", 0, 1)], {"w": [2]})
    c = _write_bed(tmp_path / "c.bed", [("chr1", 0, 1)], {"z": [3]})
    outs = _intersect_both(tmp_path, [a, b, c])
    assert open(outs[0]).read() == "chrom\tstart\tend\tv\n"


def test_intersect_cli(tmp_path):
    paths = _seeded_beds(str(tmp_path), 2, n=120)
    assert tint.main(["--bed", *paths, "--out",
                      str(tmp_path / "cli")]) == 0
    jint.main(["--bed", *paths, "--out", str(tmp_path / "jcli")])
    for p in paths:
        name = os.path.basename(p)[:-4] + "_intersect.bed"
        assert ((tmp_path / "cli" / name).read_bytes()
                == (tmp_path / "jcli" / name).read_bytes())


# ------------------------------------------------------ feature selection

def _ref_bed(path, seed, n=500, n_ct=6, nan_int=True):
    """A reference with an int column that holds a NaN in a row that
    dropna drops (so it is float64 throughout), and tied rows."""
    rng = np.random.default_rng(seed)
    vals = rng.uniform(size=(n, n_ct))
    vals[10] = vals[11]                       # a tie
    df = pd.DataFrame({"chrom": [f"chr{1 + i % 4}" for i in range(n)],
                       "start": np.arange(n) * 10,
                       "end": np.arange(n) * 10 + 1})
    for j in range(n_ct):
        df[f"ct{j}"] = vals[:, j]
    if nan_int:
        col = rng.integers(0, 2, n).astype(float)
        col[17] = np.nan
        df["ct_int"] = col
        df.loc[3, "ct1"] = np.nan
    df.to_csv(path, sep="\t", index=False)
    return str(path)


@pytest.mark.parametrize("method", ["var", "svd"])
@pytest.mark.parametrize("n", [25, 600])
def test_select_matches_jax(tmp_path, method, n):
    bed = _ref_bed(tmp_path / "ref.bed", 3)
    want = jfs.feature_select(bed, n, str(tmp_path / "jax"), method)
    got = tfs.feature_select(bed, n, str(tmp_path / "port"), method, "cpu")
    _same_files([want], [got])


def test_select_cli(tmp_path):
    bed = _ref_bed(tmp_path / "ref.bed", 4)
    assert tfs.main(["--bed", bed, "--n", "40", "--out",
                     str(tmp_path / "p"), "--method", "var", "--device",
                     "cpu"]) == 0
    jfs.main(["--bed", bed, "--n", "40", "--out", str(tmp_path / "j"),
              "--method", "var"])
    assert ((tmp_path / "p" / "ref_select_ref.bed").read_bytes()
            == (tmp_path / "j" / "ref_select_ref.bed").read_bytes())
    with pytest.raises(ValueError):
        tfs.scores(np.ones((3, 2)), 1, "nope")


@pytest.mark.parametrize("method", ["var", "svd"])
def test_select_device_path_in_float32(method):
    rng = np.random.default_rng(5)
    values = rng.uniform(size=(3000, 6))
    n = 300
    got = tfs.scores(values, n, method, force_device=True, device="cpu")
    want = np.asarray(jfs._scores(values.astype(np.float32), n, method,
                                  force_device=True))
    assert got.dtype == np.float32 and want.dtype == np.float32
    host = tfs.scores(values, n, method)
    assert host.dtype == np.float64
    # float32 rounding: the variance's sums, and for the SVD the float32
    # Gram matrix's eigenvectors (its condition number is the square of
    # the data's)
    tol = {"var": 1e-5, "svd": 1e-4}[method] * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_allclose(got, host, rtol=0, atol=tol)
    # the rows kept agree wherever the score gap at the cut exceeds the
    # rounding
    order = np.sort(host)[::-1]
    if order[n - 1] - order[n] > tol:
        assert set(tfs.rank_rows(got, n, method)) == set(
            tfs.rank_rows(host, n, method))


# ------------------------------------------------------------- simulate

SIM_CASES = {
    "default": dict(nb_samples=3, nb_known=4),
    "unknown": dict(nb_samples=3, nb_known=4,
                    unknown_portion=[0.2, 0.4, 0.6]),
    "subsample": dict(nb_samples=2, nb_known=3, subsample=150, seed=4),
    "randomknown": dict(nb_samples=2, nb_known=4, random_known=True,
                        unknown_portion=[0.3, 0.1], seed=9),
    "select": dict(nb_samples=2, select_cell_types=["ct5", "ct0", "ct2"]),
    "zero depth": dict(nb_samples=2, nb_known=3, read_depth=0.3, seed=2),
}


@pytest.mark.parametrize("case", list(SIM_CASES))
def test_simulate_matches_jax(tmp_path, case):
    bed = _ref_bed(tmp_path / "ref.bed", 6, n=300, n_ct=7)
    kw = SIM_CASES[case]
    want = jsim.generate_dataset(bed, str(tmp_path / "jax"), **kw)
    got = tsim.generate_dataset(bed, str(tmp_path / "port"), **kw)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))
    for name in os.listdir(tmp_path / "jax"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    assert [os.path.basename(p) for p in got["samples"]] == [
        os.path.basename(p) for p in want["samples"]]
    if case == "zero depth":
        assert "\t\n" in open(got["samples"][0]).read()


def test_simulate_cli(tmp_path):
    bed = _ref_bed(tmp_path / "ref.bed", 8, n=200, n_ct=6)
    flags = ["--ref", bed, "--samples", "2", "--known", "3", "--unknown",
             "0.25", "0.5", "--subsample", "90", "--seed", "11"]
    assert tsim.main(flags + ["--outdir", str(tmp_path / "p")]) == 0
    jsim.main(flags + ["--outdir", str(tmp_path / "j")])
    for name in os.listdir(tmp_path / "j"):
        assert ((tmp_path / "p" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name
