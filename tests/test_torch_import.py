"""The port imports torch and never jax: every module of
demethify_tpu_torch is imported in a fresh interpreter, which must end
with no jax module loaded."""

import os
import pkgutil
import subprocess
import sys

import demethify_tpu_torch

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
                "ops.frank_wolfe", "ops.cuda_small", "ops.cuda_kernels"):
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
