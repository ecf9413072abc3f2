"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain
C interface, loaded with ``ctypes``; no PyTorch headers are included, so
the build takes seconds. The library lands in ``build/demethify_tpu_torch/``
beside the package (or under the temporary directory when that is not
writable), named by a hash of the sources and flags, and is built at
first use. Nothing is fetched: the only inputs are the repository's
sources and the CUDA toolkit.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


def build_dir() -> str:
    """``build/demethify_tpu_torch`` next to the package, else a
    directory under the temporary directory."""
    base = os.path.join(os.path.dirname(PKG_DIR), "build",
                        "demethify_tpu_torch")
    try:
        os.makedirs(base, exist_ok=True)
        if os.access(base, os.W_OK):
            return base
    except OSError:
        pass
    base = os.path.join(tempfile.gettempdir(), "demethify_tpu_torch_build")
    os.makedirs(base, exist_ok=True)
    return base


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH); "
                       "the CUDA kernels cannot be built")


class KernelLibrary:
    """The loaded library plus what its build printed."""

    def __init__(self, lib: ctypes.CDLL, path: str, seconds: float,
                 log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = seconds
        self.build_log = log


_LIBRARY: Optional[KernelLibrary] = None
_VOID = ctypes.c_void_p
_INT = ctypes.c_int


def _declare(lib: ctypes.CDLL) -> None:
    for dt in ("f32", "f64"):
        fn = getattr(lib, f"dm_u_phase_grams_{dt}")
        fn.argtypes = [_VOID] * 8 + [ctypes.c_longlong] + [_INT] * 4 + [_VOID]
        fn.restype = _INT
        fn = getattr(lib, f"dm_alpha_phase_full_{dt}")
        fn.argtypes = [_VOID] * 9 + [_INT] * 4 + [_VOID]
        fn.restype = _INT
    lib.dm_u_phase_grams_smem.argtypes = [_INT] * 4
    lib.dm_u_phase_grams_smem.restype = ctypes.c_longlong
    lib.dm_u_phase_grams_blocks.argtypes = [ctypes.c_longlong]
    lib.dm_u_phase_grams_blocks.restype = _INT


def load() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library. Raises
    RuntimeError if nvcc is missing or the build fails."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(src, "rb") as f:
            digest.update(f.read())
    out = os.path.join(build_dir(),
                       f"libdm_kernels_{digest.hexdigest()[:16]}.so")
    t0 = time.perf_counter()
    log = ""
    if not os.path.exists(out):
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources],
                              capture_output=True, text=True, timeout=600)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(out)
    _declare(lib)
    _LIBRARY = KernelLibrary(lib, out, time.perf_counter() - t0, log)
    return _LIBRARY


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} "
                           f"(cudaError_t)")
