"""One worker of the port's 2-D layout on the CPU (gloo), for
``tests/test_torch_2d.py``:

    python -m tests.torch_layout CASE.npz OUT_DIR STORE N_PROCS PROC_ID \
        N_LOCAL LOCAL_ID

joins N_PROCS x N_LOCAL workers at the ``file://`` STORE
(``initialize_layout``), runs the 2-D routes on the case (the plain
partial-reference solve row-sharded over the world; the AIC, CCC, BCV
and minka sweeps over ``across``, each solve row-sharded over ``rows``;
the weights bootstrap the same way) and writes
OUT_DIR/worker<world rank>.npz with their results and the worker's
layout. Imports torch and the port, never jax.
"""

import os
import sys

import numpy as np
import torch

from demethify_tpu_torch.parallel.distributed import (
    Shard,
    initialize_layout,
    shard_dataset_global,
    shutdown,
)
from demethify_tpu_torch.selection.sweep import evaluate_best_ic
from demethify_tpu_torch.solvers.api import partial_reference_deconv
from demethify_tpu_torch.uncertainty.bootstrap import bootstrap_ci

SOLVE = dict(n_iter1=40, n_iter2=10, tol=1e-10)
# the sweep's criteria and the name of each one's results
IC_ROUTES = {"AIC": "ic", "CCC": "ccc", "BCV": "bcv", "minka": "minka"}


def routes(case, layout):
    """{name: numpy array} of the routes on this worker (``layout`` of
    LOCAL axes: the one-process run): the plain solve, the sweep by each
    of ``IC_ROUTES``, the weights bootstrap."""
    y, d, ref = (case[k] for k in ("y", "d", "ref"))
    out = {}

    def shard_on(axis):
        block, *yd = shard_dataset_global(y, d, ref, axis, torch.as_tensor)
        return yd, Shard(axis, block) if axis.size > 1 else None

    (yw, dw, rw), sw = shard_on(layout.world)
    res = partial_reference_deconv(yw, dw, rw, 1, seed=3, shard=sw, **SOLVE)
    out["solve/alpha"] = res.proportions.numpy()
    out["solve/cost"] = np.asarray(res.cost)
    (yr, dr, rr), sr = shard_on(layout.rows)
    for ic, name in IC_ROUTES.items():
        u, alpha, n_u, list_ic = evaluate_best_ic(
            yr, dr, rr, "uniform_", ic, seed=5, iter1=30, iter2=10,
            tol=1e-10, n_restarts=3, n_u_max=3, axis=layout.across,
            shard=sr)
        out[f"{name}/alpha"] = alpha.numpy()
        out[f"{name}/list"] = np.asarray(list_ic)
        out[f"{name}/n_u"] = np.asarray(n_u)
    lo_p, hi_p, lo_u, hi_u = bootstrap_ci(
        yr, dr, rr, 1, level=90, n_bootstrap=5, n_iter1=30, n_iter2=10,
        tol=1e-10, seed=7, method="weights", axis=layout.across, shard=sr)
    out.update({"boot/lo_p": lo_p, "boot/hi_p": hi_p, "boot/lo_u": lo_u,
                "boot/hi_u": hi_u})
    return out


def main(case_path, out_dir, store, n_procs, proc_id, n_local, local_id):
    case = dict(np.load(case_path))
    layout, _ = initialize_layout(f"file://{store}", n_procs, proc_id,
                                  n_local, local_id, "cpu")
    out = routes(case, layout)
    out["layout"] = np.array([[a.rank, a.size] for a in (
        layout.world, layout.rows, layout.across)])
    np.savez(os.path.join(out_dir, f"worker{layout.world.rank}.npz"), **out)
    shutdown(layout.world)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], sys.argv[3], *map(int, sys.argv[4:8]))
