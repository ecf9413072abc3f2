"""Factor-state checkpoints (``--savestate`` / ``--initstate``).

Counterpart of ``demethify_tpu/checkpoint.py``, which saves the same keys
(``alpha``, ``cost`` and, outside the reference-based mode, ``u``;
``demethify_tpu/cli.py:543-548``) with orbax. orbax imports jax, so the
port writes a format of its own: a directory of numpy ``.npy`` files and
a manifest, ``factors.json``, written last.

- ``alpha.npy`` (p, n_s) and ``cost.npy`` (0-d): written by rank 0;
- ``u.partNNNN.npy``: rank NNNN's data rows of u (no padding), rows
  [start, stop) of the n_rows global rows, as the manifest lists them.
  A one-process run writes one part with every row.

So a checkpoint written by N ranks restores onto any row layout:
``load_factors(rows=(start, stop))`` reads only the parts that overlap
the rows asked for. bfloat16 factors are saved as float32 (numpy has no
bf16); the solvers keep u and alpha in float32 under bf16 storage anyway.
A checkpoint of the JAX package converts with ``save_factors`` on the
arrays that its ``load_factors(path, as_numpy=True)`` returns.
"""

import glob
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from demethify_tpu_torch.parallel.distributed import LOCAL, Axis

FORMAT = "demethify-tpu-torch factors"
MANIFEST = "factors.json"


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def _save(path: str, array: np.ndarray):
    tmp = path + ".tmp.npy"
    np.save(tmp, array)
    os.replace(tmp, path)


def save_factors(path: str, *, alpha, cost, u=None, row_start: int = 0,
                 n_rows: Optional[int] = None, axis: Axis = LOCAL) -> str:
    """Save (alpha, cost[, u]) at the directory ``path`` (made if missing;
    an earlier checkpoint there is replaced). Every rank of ``axis`` calls
    it at once with the replicated alpha and cost and its own rows of u:
    the rows [row_start, row_start + len(u)) of ``n_rows`` (default: u's
    rows, one process). Returns the absolute path."""
    path = os.path.abspath(path)
    if axis.rank == 0:
        os.makedirs(path, exist_ok=True)
        stale = [os.path.join(path, MANIFEST)] + glob.glob(
            os.path.join(path, "u.part*.npy"))
        for f in stale:
            if os.path.exists(f):
                os.remove(f)
    axis.barrier()
    part = None
    if u is not None:
        u = _numpy(u)
        part = {"file": f"u.part{axis.rank:04d}.npy", "start": int(row_start),
                "stop": int(row_start) + u.shape[0]}
        _save(os.path.join(path, part["file"]), u)
    parts = [p for p in axis.all_gather_object(part) if p is not None]
    if axis.rank == 0:
        _save(os.path.join(path, "alpha.npy"), _numpy(alpha))
        _save(os.path.join(path, "cost.npy"), _numpy(cost))
        manifest = {"format": FORMAT, "version": 1,
                    "n_rows": (None if u is None else
                               int(n_rows if n_rows is not None
                                   else u.shape[0])),
                    "u_parts": parts}
        tmp = os.path.join(path, MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, os.path.join(path, MANIFEST))
    axis.barrier()
    return path


def load_factors(path: str, rows: Optional[Tuple[int, int]] = None) -> dict:
    """{"alpha", "cost", "n_rows"[, "u"]} as numpy arrays (n_rows None
    without u). ``rows`` = (start, stop) reads only those global rows of u
    (rows past n_rows are left out, so u may come back shorter); None
    reads all of them."""
    path = os.path.abspath(path)
    manifest_path = os.path.join(path, MANIFEST)
    if not os.path.exists(manifest_path):
        raise FileNotFoundError(f"no {MANIFEST} in {path}: not a checkpoint "
                                f"of this package (or an unfinished one)")
    with open(manifest_path) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise ValueError(f"{manifest_path} is not a {FORMAT!r} manifest")
    out = {"alpha": np.load(os.path.join(path, "alpha.npy")),
           "cost": np.load(os.path.join(path, "cost.npy")),
           "n_rows": manifest["n_rows"]}
    if manifest["n_rows"] is None:
        return out
    lo, hi = (0, manifest["n_rows"]) if rows is None else rows
    hi = min(hi, manifest["n_rows"])
    blocks = []
    for part in sorted(manifest["u_parts"], key=lambda p: p["start"]):
        a, b = max(lo, part["start"]), min(hi, part["stop"])
        if a < b:
            u = np.load(os.path.join(path, part["file"]), mmap_mode="r")
            blocks.append(np.array(u[a - part["start"]:b - part["start"]]))
    n_u = np.load(os.path.join(path, manifest["u_parts"][0]["file"]),
                  mmap_mode="r").shape[1]
    out["u"] = (np.concatenate(blocks) if blocks else
                np.zeros((0, n_u), out["alpha"].dtype))
    return out
