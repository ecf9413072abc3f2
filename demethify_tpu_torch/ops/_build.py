"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` into an object file, all sources at
once in parallel processes, and links them into one shared library with
a plain C interface, loaded with ``ctypes``; no PyTorch headers are
included, so the build takes seconds. The library lands in
``build/demethify_tpu_torch/``
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
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


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
    """The loaded library plus what its build printed and each source's
    compile seconds (empty when the library was already built)."""

    def __init__(self, lib: ctypes.CDLL, path: str, seconds: float,
                 log: str, source_seconds=None):
        self.lib = lib
        self.path = path
        self.build_seconds = seconds
        self.build_log = log
        self.source_seconds = source_seconds or {}


_LIBRARY: Optional[KernelLibrary] = None
_VOID = ctypes.c_void_p
_INT = ctypes.c_int


_LL = ctypes.c_longlong


def _declare(lib: ctypes.CDLL) -> None:
    # K1 and K4 in each layout ("" resident, "_wide", "_global")
    for layout in ("", "_wide", "_global"):
        k1 = f"dm_u_phase_grams{layout}"
        k4 = f"dm_u_phase_grams_multi{layout}"
        for dt in ("f32", "f64", "bf16"):
            fn = getattr(lib, f"{k1}_{dt}")
            # bf16 data with a float32 state adds the bf16_compute flag
            fn.argtypes = ([_VOID] * 10 + [_LL] + [_INT] * (7 if dt == "bf16"
                                                            else 6) + [_VOID])
            fn.restype = _INT
            # the multi-member kernel: pointers with their member strides
            fn = getattr(lib, f"{k4}_{dt}")
            fn.argtypes = ([_VOID] * 3 + [_LL, _VOID, _LL] + [_VOID] * 2
                           + [_LL] + [_VOID, _INT] + [_VOID] * 5 + [_LL]
                           + [_INT] * 6 + [_VOID])
            fn.restype = _INT
        getattr(lib, f"{k1}_smem").argtypes = [_INT] * 6
        getattr(lib, f"{k1}_smem").restype = _LL
        getattr(lib, f"{k4}_smem").argtypes = [_INT] * 5
        getattr(lib, f"{k4}_smem").restype = _LL
    lib.dm_u_phase_grams_blocks.argtypes = [_LL]
    lib.dm_u_phase_grams_blocks.restype = _INT
    lib.dm_global_plan.argtypes = [_INT] * 7 + [_VOID]
    lib.dm_global_plan.restype = _INT
    lib.dm_state_rows.argtypes = [_INT] * 3
    lib.dm_state_rows.restype = _INT
    lib.dm_state_in_device.argtypes = [_INT] * 4
    lib.dm_state_in_device.restype = _INT
    lib.dm_gram_tile_plan.argtypes = [_INT] * 4 + [_VOID]
    lib.dm_gram_tile_plan.restype = _INT
    lib.dm_k4_member_plan.argtypes = [_INT] * 7 + [_VOID]
    lib.dm_k4_member_plan.restype = _INT
    lib.dm_k4_gram_plan.argtypes = [_INT] * 5 + [_VOID]
    lib.dm_k4_gram_plan.restype = _INT
    for dt in ("f32", "f64"):
        fn = getattr(lib, f"dm_momentum_table_{dt}")
        fn.argtypes = [_VOID, _INT, _INT, _VOID, _INT, _INT, _VOID]
        fn.restype = _INT
        fn = getattr(lib, f"dm_alpha_phase_full_{dt}")
        fn.argtypes = [_VOID] * 13 + [_INT] * 6 + [_VOID]
        fn.restype = _INT
        fn = getattr(lib, f"dm_fw_phase_full_{dt}")
        fn.argtypes = [_VOID] * 11 + [_INT] * 6 + [_VOID]
        fn.restype = _INT
        fn = getattr(lib, f"dm_alpha_phase_full_multi_{dt}")
        fn.argtypes = ([_VOID, _LL] * 6 + [_VOID] * 2 + [_LL, _VOID, _LL]
                       + [_VOID, _LL] + [_VOID] * 3 + [_INT] * 7 + [_VOID])
        fn.restype = _INT
        fn = getattr(lib, f"dm_fw_phase_full_multi_{dt}")
        fn.argtypes = ([_VOID, _LL] * 6 + [_VOID] * 2 + [_LL] + [_VOID] * 3
                       + [_INT] * 7 + [_VOID])
        fn.restype = _INT
    lib.dm_row_bucket.argtypes = [_INT]
    lib.dm_row_bucket.restype = _INT
    lib.dm_two_row_stride.argtypes = [_INT]
    lib.dm_two_row_stride.restype = _INT
    lib.dm_glue_smem.argtypes = [_INT] * 3
    lib.dm_glue_smem.restype = _LL
    for kernel in ("alpha", "fw"):
        fn = getattr(lib, f"dm_{kernel}_column_work")
        fn.argtypes = [_INT] * 3
        fn.restype = _LL
        fn = getattr(lib, f"dm_{kernel}_column_capacity")
        fn.argtypes = [_INT, _INT, _VOID]
        fn.restype = _INT
    lib.dm_fw_column_plan.argtypes = [_INT, _INT, _VOID]
    lib.dm_fw_column_plan.restype = _LL
    lib.dm_fw_column_groups.argtypes = [_INT] * 3
    lib.dm_fw_column_groups.restype = _INT
    lib.dm_alpha_column_plan.argtypes = [_INT, _INT, _VOID]
    lib.dm_alpha_column_plan.restype = _LL
    lib.dm_alpha_column_groups.argtypes = [_INT] * 3
    lib.dm_alpha_column_groups.restype = _INT
    # the single-phase kernels: K7, K8, K9, K10
    lib.dm_u_phase_smem.argtypes = [_INT] * 2
    lib.dm_u_phase_smem.restype = _LL
    for dt in ("f32", "f64", "bf16"):
        fn = getattr(lib, f"dm_u_phase_{dt}")
        fn.argtypes = [_VOID] * 12 + [_LL] + [_INT] * 5 + [_VOID]
        fn.restype = _INT
        fn = getattr(lib, f"dm_grams_{dt}")
        fn.argtypes = [_VOID] * 7 + [_LL] * 2 + [_INT] * 9 + [_VOID]
        fn.restype = _INT
    lib.dm_grams_smem.argtypes = [_INT] * 7
    lib.dm_grams_smem.restype = _LL
    for dt in ("f32", "f64"):
        fn = getattr(lib, f"dm_alpha_phase_{dt}")
        fn.argtypes = [_VOID] * 9 + [_INT] * 3 + [_VOID]
        fn.restype = _INT
        fn = getattr(lib, f"dm_fw_phase_{dt}")
        fn.argtypes = [_VOID] * 8 + [_INT] * 4 + [_VOID]
        fn.restype = _INT
    for name in ("dm_alpha_phase_plan", "dm_fw_phase_plan"):
        getattr(lib, name).argtypes = [_INT, _INT, _VOID]
        getattr(lib, name).restype = _LL


def _compile(out: str):
    """One nvcc process per source, all started together, then one link.
    Returns what the compilers printed (ptxas register and spill lines)
    and each source's compile seconds (its object's mtime less the
    start)."""
    nvcc = _nvcc()
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    objs = [f"{out}.{os.path.basename(src)}.{os.getpid()}.o"
            for src in sources]
    t0 = time.time()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs, failed = [], []
    try:
        for src, proc in zip(sources, procs):
            text, _ = proc.communicate(timeout=600)
            logs.append(text)
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)} (exit "
                              f"{proc.returncode})")
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                               + "".join(logs))
        seconds = {os.path.basename(src): round(os.path.getmtime(obj) - t0, 1)
                   for src, obj in zip(sources, objs)}
        tmp = f"{out}.{os.getpid()}.tmp"
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True, timeout=600)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {link.returncode}):"
                               f"\n{''.join(logs)}")
        os.replace(tmp, out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return "".join(logs), seconds


def load() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library. Raises
    RuntimeError if nvcc is missing or the build fails."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu*"))):
        with open(src, "rb") as f:
            digest.update(f.read())
    out = os.path.join(build_dir(),
                       f"libdm_kernels_{digest.hexdigest()[:16]}.so")
    t0 = time.perf_counter()
    log, seconds = "", {}
    if not os.path.exists(out):
        log, seconds = _compile(out)
    lib = ctypes.CDLL(out)
    _declare(lib)
    _LIBRARY = KernelLibrary(lib, out, time.perf_counter() - t0, log,
                             seconds)
    return _LIBRARY


def check(err: int, name: str, case: str = "") -> None:
    """Raises RuntimeError naming the kernel, the CUDA error and, where
    given, the launch's ``case`` (its shape, dtypes and plan) unless
    ``err`` is 0."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err} "
                           f"(cudaError_t)" + (f" at {case}" if case else ""))
