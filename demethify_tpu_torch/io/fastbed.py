"""ctypes binding for the native TSV/CSV column parser.

The C++ source stays single: this module compiles the JAX package's
``demethify_tpu/io/_fastbed.cpp`` by path (no Python import of that
package) into the port's build directory. ``available()`` is False when
g++ or the source is missing, and the readers then parse with the
``csv`` module instead.
"""

import ctypes
import hashlib
import os
import subprocess
from typing import List, Optional, Sequence

import numpy as np

from demethify_tpu_torch.ops._build import PKG_DIR, build_dir

SRC = os.path.join(os.path.dirname(PKG_DIR), "demethify_tpu", "io",
                   "_fastbed.cpp")


class _Native:
    """The loaded parser library, or the reason it is unavailable."""

    def __init__(self):
        self.lib: Optional[ctypes.CDLL] = None
        self.tried = False

    def load(self) -> Optional[ctypes.CDLL]:
        if self.tried:
            return self.lib
        self.tried = True
        if not os.path.exists(SRC):
            return None
        with open(SRC, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        so_path = os.path.join(build_dir(), f"_fastbed_{digest}.so")
        if not os.path.exists(so_path):
            tmp = f"{so_path}.{os.getpid()}.tmp"
            try:
                subprocess.run(["g++", "-O3", "-shared", "-fPIC", SRC,
                                "-o", tmp], check=True, capture_output=True,
                               timeout=120)
                os.replace(tmp, so_path)
            except (subprocess.SubprocessError, OSError):
                return None
        try:
            lib = ctypes.CDLL(so_path)
        except OSError:
            return None
        lib.fastbed_count_rows.argtypes = [ctypes.c_char_p]
        lib.fastbed_count_rows.restype = ctypes.c_long
        lib.fastbed_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_char,
            ctypes.POINTER(ctypes.c_long), ctypes.c_long,
            ctypes.POINTER(ctypes.c_double), ctypes.c_long,
        ]
        lib.fastbed_parse.restype = ctypes.c_long
        self.lib = lib
        return lib


_NATIVE = _Native()


def available() -> bool:
    return _NATIVE.load() is not None


def read_header(path: str, delim: str) -> List[str]:
    with open(path, "r") as f:
        return f.readline().rstrip("\r\n").split(delim)


def parse_columns(path: str, columns: Sequence[str],
                  delim: str = "\t") -> np.ndarray:
    """The named numeric columns of a delimited file with a header, as a
    float64 (n_rows, len(columns)) array; missing fields are NaN. Raises
    RuntimeError when the native parser is unavailable."""
    lib = _NATIVE.load()
    if lib is None:
        raise RuntimeError("fastbed native parser unavailable")
    header = read_header(path, delim)
    try:
        idx = [header.index(c) for c in columns]
    except ValueError as e:
        raise KeyError(f"column not found in {path}: {e}") from e
    path_b = path.encode()
    n_rows = lib.fastbed_count_rows(path_b)
    if n_rows < 0:
        raise RuntimeError(f"fastbed: cannot read {path}")
    out = np.empty((n_rows, len(idx)), dtype=np.float64)
    idx_arr = (ctypes.c_long * len(idx))(*idx)
    got = lib.fastbed_parse(
        path_b, delim.encode()[0], idx_arr, len(idx),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n_rows)
    if got < 0:
        raise RuntimeError(f"fastbed: parse failed for {path}")
    return out[:got]
