"""The port imports torch and never jax: every module of
demethify_tpu_torch is imported in a fresh interpreter, which must end
with no jax module loaded. Nor does it reach a file of the JAX package:
no path or import in its sources leads into ``demethify_tpu/`` (the
check ``chip_smoke.py`` also makes on the card)."""

import os
import pkgutil
import shutil
import subprocess
import sys

import demethify_tpu_torch
from demethify_tpu_torch.io import fastbed
from demethify_tpu_torch.isolation import jax_package_references

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _all_modules():
    names = ["demethify_tpu_torch"]
    for info in pkgutil.walk_packages(demethify_tpu_torch.__path__,
                                      "demethify_tpu_torch."):
        if not info.name.endswith("__main__"):
            names.append(info.name)
    return names


def test_every_module_imports_without_jax():
    names = _all_modules()
    for mod in ("solvers.fused", "solvers.purity", "solvers.unsupervised",
                "ops.frank_wolfe", "ops.cuda_small", "ops.cuda_kernels",
                "ops.cuda_multi", "isolation", "ops.tall_svd", "ops.nndsvd",
                "ops.nnica", "selection.criteria", "selection.ccc",
                "selection.minka", "selection.bcv", "selection.sweep",
                "checkpoint", "parallel.mesh", "parallel.distributed",
                "plotting", "simulate", "io.table",
                "preprocessing.intersect",
                "preprocessing.feature_selection"):
        assert f"demethify_tpu_torch.{mod}" in names
    code = ("import importlib, sys\n"
            f"for n in {names!r}:\n"
            "    importlib.import_module(n)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'demethify_tpu'\n"
            "             or m.startswith('demethify_tpu.'))\n"
            "print(len(sys.modules))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_reach_no_file_of_the_jax_package(tmp_path):
    assert jax_package_references(REPO) == []
    # the scan sees code, not counterpart notes: a path built from the JAX
    # package's directory name is found, a docstring or comment is not
    pkg = tmp_path / "demethify_tpu_torch"
    (pkg / "csrc").mkdir(parents=True)
    (pkg / "a.py").write_text(
        '"""Counterpart of ``demethify_tpu/io/x.py``."""\n'
        "import os  # as demethify_tpu/io does\n"
        "SRC = os.path.join(ROOT, 'demethify_tpu', 'io',\n"
        "                   '_fastbed.cpp')\n")
    (pkg / "b.py").write_text("from demethify_tpu.ops import gram\n")
    (pkg / "csrc" / "k.cu").write_text(
        "// replaces demethify_tpu/ops/pallas_kernels.py\n"
        "/* demethify_tpu.ops */\n"
        '#include "demethify_tpu/x.h"\n')
    assert sorted(jax_package_references(str(tmp_path))) == [
        (os.path.join("demethify_tpu_torch", "a.py"), 3),
        (os.path.join("demethify_tpu_torch", "b.py"), 1),
        (os.path.join("demethify_tpu_torch", "csrc", "k.cu"), 3)]


def test_fastbed_builds_the_ports_own_source(tmp_path, monkeypatch):
    """The native parser compiles the port's copy of the C++ source."""
    assert os.path.dirname(fastbed.SRC) == os.path.dirname(fastbed.__file__)
    with open(fastbed.SRC, "rb") as mine, open(os.path.join(
            REPO, "demethify_tpu", "io", "_fastbed.cpp"), "rb") as theirs:
        assert mine.read() == theirs.read()
    if shutil.which("g++") is None:
        return
    path = tmp_path / "t.tsv"
    path.write_text("a\tb\n1.5\t2\n\t4\n")
    out = fastbed.parse_columns(str(path), ["b", "a"])
    assert out.shape == (2, 2) and out[0].tolist() == [2.0, 1.5]
    assert out[1, 0] == 4.0 and out[1, 1] != out[1, 1]           # NaN
