"""One rank of the port's row-distributed set-up on the CPU (gloo), for
``tests/test_torch_row_init.py``:

    python -m tests.torch_row_ranks CASE_DIR OUT_DIR STORE N_RANKS RANK

joins N_RANKS ranks over gloo at the ``file://`` STORE, reads ONLY its
block of the rows of each case array (``CASE_DIR/<name>.npy``, memory-
mapped), runs every route of ``routes`` on them and writes
OUT_DIR/rankRANK.npz: this rank's data rows of each u, and the
replicated results (alpha, H, singular values, intervals, criteria). The
ranks span processes (``--multihost``); minka also runs under an axis of
the same ranks marked as one process's workers (``--shard`` alone), to
hold both sides of its branch rule. Imports torch and the port, never
jax.
"""

import os
import sys

import numpy as np
import torch

from demethify_tpu_torch.ops import nnica, tall_svd
from demethify_tpu_torch.parallel.distributed import (
    Axis,
    Shard,
    initialize_layout,
    shutdown,
)
from demethify_tpu_torch.parallel.mesh import row_block
from demethify_tpu_torch.selection.minka import select_rank_minka
from demethify_tpu_torch.selection.sweep import evaluate_best_ic
from demethify_tpu_torch.solvers import api, init
from demethify_tpu_torch.uncertainty.bootstrap import bootstrap_ci

# (case, mode, option): the inits held N ranks against one. "small" has
# ICA_DUAL_THRESHOLD rows or fewer (the primal ICA), "big" more (the dual)
INITS = [(case, mode, option)
         for case, options in (("small", ("uniform_", "beta", "uniform",
                                          "SVD", "ICA")),
                               ("big", ("SVD", "ICA")))
         for mode in ("partial", "purity", "unsupervised")
         for option in options]
SWEEPS = (("AIC", "SVD"), ("BCV", "uniform_"), ("CCC", "uniform_"),
          ("minka", "uniform_"))
SOLVE = dict(n_iter1=25, n_iter2=10, tol=1e-12)
N_U = 2


def load_rows(case_dir, name, block):
    """This rank's block of the rows of ``case_dir/name.npy`` (padded with
    zeros), read through a memory map: the other rows are never read."""
    whole = np.load(os.path.join(case_dir, f"{name}.npy"), mmap_mode="r")
    rows = np.array(whole[block.start:min(block.stop, whole.shape[0])])
    pad = (block.stop - block.start) - rows.shape[0]
    if pad:
        rows = np.concatenate([rows, np.zeros((pad, *rows.shape[1:]),
                                              rows.dtype)])
    return torch.as_tensor(rows)


def n_rows(case_dir, name):
    return np.load(os.path.join(case_dir, f"{name}.npy"),
                   mmap_mode="r").shape[0]


def routes(case_dir, axis):
    """{key: numpy} of every route on this rank's rows (``axis`` LOCAL:
    one rank holding every row, the reference). u-like keys end in
    '/u' (this rank's data rows); the rest are replicated."""
    shards, data = {}, {}
    for case in ("small", "big", "deficient"):
        block = row_block(n_rows(case_dir, f"{case}_y"), axis.size,
                          axis.rank)
        shards[case] = Shard(axis, block) if axis.size > 1 else None
        data[case] = [load_rows(case_dir, f"{case}_{k}", block)
                      for k in ("y", "d", "ref")]
    purity = torch.as_tensor(np.load(os.path.join(case_dir, "purity.npy")))
    out = {}

    def rows(case, u):
        n = (u.shape[0] if shards[case] is None
             else shards[case].block.n_data)
        return u[:n].numpy()

    for case, mode, option in INITS:
        y, d, ref = data[case]
        sh = shards[case]
        g = torch.Generator().manual_seed(11)
        if mode == "partial":
            u, a = init.init_partial(g, option, y, d, ref, N_U, shard=sh)
        elif mode == "purity":
            u, a = init.init_purity(g, option, y, d, ref, N_U,
                                    purity=purity, shard=sh)
        else:
            u, a = init.init_unsupervised(g, option, y, d, N_U + 1,
                                          shard=sh)
        out[f"init/{case}/{mode}/{option}/u"] = rows(case, u)
        out[f"init/{case}/{mode}/{option}/alpha"] = a.numpy()

    y, d, ref = data["small"]
    sh = shards["small"]
    res = api.supervised_deconv(y, d, ref, axis=axis)
    out["supervised/alpha"] = res.proportions.numpy()
    out["supervised/cost"] = np.asarray(res.cost)
    U, s, Wt = tall_svd.tall_svd(y, axis)
    out["tall_svd/u"], out["tall_svd/s"] = rows("small", U), s.numpy()
    yb = data["big"][0]
    B = tall_svd.tall_svd(yb, axis)[0]
    out["dual/B/u"] = rows("big", B)
    out["dual/S"] = axis.sum_(B.T @ yb).numpy()
    prof, H = nnica.run_nn_ica_dual(yb, 2, shard=shards["big"])
    out["dual/prof/u"], out["dual/H"] = rows("big", prof), H.numpy()
    for name, call in (
            ("solve SVD", lambda: api.partial_reference_deconv(
                y, d, ref, N_U, init="SVD", shard=sh, **SOLVE)),
            ("solve uniform restarts", lambda: api.partial_reference_deconv(
                y, d, ref, N_U, init="uniform", n_restarts=2, shard=sh,
                **SOLVE)),
            ("solve purity ICA", lambda: api.purity_deconv(
                y, d, ref, N_U, purity, init="ICA", shard=sh, **SOLVE))):
        res = call()
        out[f"{name}/u"] = rows("small", res.u)
        out[f"{name}/alpha"] = res.proportions.numpy()
        out[f"{name}/cost"] = np.asarray(res.cost)
    for option in ("uniform", "SVD"):
        lo_p, hi_p, lo_u, hi_u = bootstrap_ci(
            y, d, ref, N_U, level=90, n_bootstrap=5, init_option=option,
            seed=13, method="weights", shard=sh, **SOLVE)
        out[f"boot {option}/props"] = np.stack([lo_p, hi_p])
        out[f"boot {option}/profiles"] = np.stack([lo_u, hi_u])[
            :, :n_rows(case_dir, "small_y")]
    for ic, option in SWEEPS:
        u, alpha, best, list_ic = evaluate_best_ic(
            y, d, ref, option, ic, seed=17, iter1=SOLVE["n_iter1"],
            iter2=SOLVE["n_iter2"], tol=SOLVE["tol"], n_restarts=3,
            n_u_max=3, shard=sh)
        out[f"sweep {ic}/u"] = rows("small", u)
        out[f"sweep {ic}/alpha"] = alpha.numpy()
        out[f"sweep {ic}/best"] = np.asarray(best)
        out[f"sweep {ic}/list"] = np.asarray(list_ic)
    yd, dd, rd = data["deficient"]
    for rule, ax in (("processes", axis),
                     ("one process", Axis(axis.group, axis.device_group,
                                          one_process=True))):
        sh_d = (None if shards["deficient"] is None else
                Shard(ax, shards["deficient"].block))
        best, info = select_rank_minka(yd, dd, rd, shard=sh_d)
        out[f"minka {rule}/best"] = np.asarray(best)
        out[f"minka {rule}/log_liks"] = np.asarray(
            list(info["log_liks"].values()))
    return out


def main(case_dir, out_dir, store, n_ranks, rank):
    axis = initialize_layout(f"file://{store}", n_ranks, rank,
                             device_name="cpu")[0].world
    out = routes(case_dir, axis)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    shutdown(axis)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4]),
         int(sys.argv[5]))
