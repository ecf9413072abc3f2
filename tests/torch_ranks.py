"""One rank of the port's row-sharded kernel solvers on the CPU (the
kernels' twins), for ``tests/test_torch_distributed.py``:

    python -m tests.torch_ranks CASE.npz OUT_DIR STORE N_RANKS RANK

joins N_RANKS ranks over gloo at the ``file://`` STORE, solves the case's
problems on its block of the rows with every ``fused.*_sharded`` solver
and writes OUT_DIR/rankRANK.npz: per solver its data rows of u, alpha,
cost, n_iter and the cost trace. Imports torch and the port, never jax.
"""

import os
import sys

import numpy as np
import torch

from demethify_tpu_torch.parallel.distributed import (
    initialize_layout,
    shutdown,
)
from demethify_tpu_torch.parallel.mesh import row_block
from demethify_tpu_torch.solvers import fused


def solve_all(case, axis, block):
    """{solver name: (u rows, alpha, info)} of every sharded solver on
    this rank's block (``axis`` LOCAL and the whole block: the one-rank
    solve)."""
    t = torch.as_tensor
    rows = lambda x: t(block.take(x, axis=x.ndim - 2))   # noqa: E731
    y, d, Rt = rows(case["y"]), rows(case["d"]), rows(case["Rt"])
    purity = t(case["purity"])
    kw = dict(n_iter1=int(case["n_iter1"]), n_iter2=int(case["n_iter2"]),
              tol=float(case["tol"]), record_trace=True)
    pkw = dict(kw, n_iter2=int(case["n_iter2_purity"]))
    out = {
        "partial": fused.partial_ref_solve_fused_sharded(
            rows(case["u0"]), t(case["a0"]), y, d, Rt, int(case["n_u"]),
            axis, **kw),
        "unsupervised": fused.unsupervised_solve_fused_sharded(
            rows(case["u0_uns"]), t(case["a0_uns"]), y, d,
            int(case["n_u_uns"]), axis, **kw),
        "purity": fused.purity_solve_fused_sharded(
            rows(case["u0"]), t(case["a0"]), y, d, Rt, purity,
            int(case["n_u"]), axis, **pkw),
        "partial_multi": fused.partial_ref_solve_fused_multi_sharded(
            rows(case["u0_b"]), t(case["a0_b"]), y, d, Rt,
            int(case["n_u"]), axis, **kw),
        "unsupervised_multi": fused.unsupervised_solve_fused_multi_sharded(
            rows(case["u0_uns_b"]), t(case["a0_uns_b"]), y, d,
            int(case["n_u_uns"]), axis, **kw),
        "purity_multi": fused.purity_solve_fused_multi_sharded(
            rows(case["u0_b"]), t(case["a0_b"]), y, d, Rt, purity,
            int(case["n_u"]), axis, **pkw),
        "partial_weighted": fused.partial_ref_solve_fused_multi_sharded(
            rows(case["u0_b"]), t(case["a0_b"]), y, d, Rt,
            int(case["n_u"]), axis,
            row_weights_b=t(block.take(case["w_b"], axis=1)), **kw),
    }
    return {k: (u[..., :block.n_data, :], a, info)
            for k, (u, a, info) in out.items()}


def flatten(results) -> dict:
    """{solver name: (u, alpha, info)} -> one flat dict of numpy arrays."""
    flat = {}
    for name, (u, alpha, info) in results.items():
        flat[f"{name}/u"] = u.numpy()
        flat[f"{name}/alpha"] = alpha.numpy()
        flat[f"{name}/cost"] = info["cost"].numpy()
        flat[f"{name}/n_iter"] = np.asarray(info["n_iter"])
        flat[f"{name}/trace"] = info["trace"].numpy()
    return flat


def main(case_path, out_dir, store, n_ranks, rank):
    case = dict(np.load(case_path))
    axis = initialize_layout(f"file://{store}", n_ranks, rank,
                             device_name="cpu")[0].world
    block = row_block(case["y"].shape[0], n_ranks, rank)
    flat = flatten(solve_all(case, axis, block))
    flat["start"] = np.asarray(block.start)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **flat)
    shutdown(axis)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4]),
         int(sys.argv[5]))
