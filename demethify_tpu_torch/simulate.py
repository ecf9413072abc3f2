"""In-silico bulk-methylation mixtures from a reference BED
(``demethify-tpu-torch-simulate``).

Counterpart of ``demethify_tpu/simulate.py`` (reference
``test/gen_bedmethyl.py:5-89``): Dirichlet cell-type proportions,
Poisson read coverage, Beta-perturbed reference profiles and Binomial
methylated counts, drawn from an explicit ``numpy.random.Generator`` in
the JAX tool's order, so that the same seed gives the same files. It
writes modkit-style sample BEDs, the known cell types' reference and the
ground truth (``proportions_sim.csv``, and ``meth_profile_sim.csv`` with
an unknown component). numpy, without pandas: the tables are read and
written by ``io/table.py`` in pandas' text. Two points of that text:

- ``--subsample n`` keeps the rows that pandas' ``DataFrame.sample(n,
  random_state=seed)`` keeps: ``np.random.RandomState(seed).choice(rows,
  n, replace=False)``, in that order;
- ``percent_modified`` is 0/0 where the coverage is zero, written as an
  empty field (pandas' NaN).
"""

import argparse
import os
from typing import List, Optional, Sequence

import numpy as np

from demethify_tpu_torch.io.table import read_table, write_table


def _perturb_reference(R_full: np.ndarray, rng: np.random.Generator,
                       disp: float, eps: float) -> np.ndarray:
    """Beta-jitter the reference profiles (per-site biological noise)."""
    R = R_full + ((R_full == 0) * eps) - ((R_full == 1) * eps)
    return rng.beta(disp * R, disp * (1 - R))


def gen_param_u(R_full: np.ndarray, read_depth: float, trunc: int,
                unknown_portion: np.ndarray, nb_samples: int,
                rng: Optional[np.random.Generator] = None,
                disp: float = 1.0):
    """A mixture with an unknown component: the first ``trunc`` cell types
    are known, the rest make one unknown profile with per-sample mass
    ``unknown_portion``. Returns (meth_counts, coverage,
    proportions_truth, unknown_profile)."""
    rng = rng or np.random.default_rng()
    nb_cpg, nb_celltypes = R_full.shape
    unknown_portion = np.reshape(np.asarray(unknown_portion),
                                 (1, nb_samples))

    alpha_known = rng.dirichlet(np.ones(trunc), nb_samples).T
    alpha_unknown = rng.dirichlet(np.ones(nb_celltypes - trunc), 1).T
    alpha_sim = np.concatenate([alpha_known * (1 - unknown_portion),
                                alpha_unknown * unknown_portion])

    d_x = rng.poisson(read_depth, (nb_cpg, nb_samples))
    R_jit = _perturb_reference(R_full, rng, disp, 1e-10)
    beta_sim = R_jit @ alpha_sim
    x = rng.binomial(d_x, np.clip(beta_sim, 0.0, 1.0))
    m_u = R_jit[:, trunc:] @ alpha_unknown

    truth = np.concatenate([alpha_known * (1 - unknown_portion),
                            unknown_portion])
    return x, d_x, truth, m_u


def gen_param(R_full: np.ndarray, read_depth: float, nb_samples: int,
              rng: Optional[np.random.Generator] = None,
              disp: float = 1.0):
    """A fully known mixture. Returns (meth_counts, coverage,
    proportions)."""
    rng = rng or np.random.default_rng()
    nb_cpg, nb_celltypes = R_full.shape

    alpha_sim = rng.dirichlet(np.ones(nb_celltypes), nb_samples).T
    d_x = rng.poisson(read_depth, (nb_cpg, nb_samples))
    R_jit = _perturb_reference(R_full, rng, disp, 1e-16)
    beta_sim = R_jit @ alpha_sim
    x = rng.binomial(d_x, np.clip(beta_sim, 0.0, 1.0))
    return x, d_x, alpha_sim


def generate_dataset(ref_bed: str, outdir: str, *,
                     nb_samples: int = 10,
                     read_depth: float = 50,
                     nb_known: int = 5,
                     select_cell_types: Optional[Sequence[str]] = None,
                     unknown_portion: Optional[Sequence[float]] = None,
                     subsample: Optional[int] = None,
                     seed: int = 0,
                     disp: float = 1.0,
                     random_known: bool = False) -> dict:
    """Write the sample BEDs, the known cell types' reference and the
    truth files under ``outdir``. The known cell types are the named ones
    (``select_cell_types``), the first ``nb_known`` columns (default), or
    ``random_known``: ``nb_known`` drawn without replacement. Returns
    {"samples": paths, "ref": path, "proportions": path}."""
    rng = np.random.default_rng(seed)
    ref = read_table(ref_bed).dropna()
    if subsample:
        ref = ref.take(np.random.RandomState(seed).choice(
            ref.n_rows, subsample, replace=False))
    pos = ref.select(0, 3)
    columns = ref.names[3:]
    by_name = dict(zip(columns, ref.columns[3:]))

    if select_cell_types:
        known = list(select_cell_types)
    elif random_known:
        known = list(rng.choice(np.array(columns, dtype=object), nb_known,
                                replace=False))
    else:
        known = list(columns)[:nb_known]
    order = known + [c for c in columns if c not in known]
    values = np.stack([np.asarray(by_name[c], dtype=np.float64)
                       for c in order], axis=1)

    os.makedirs(outdir, exist_ok=True)

    if unknown_portion is not None:
        meth_counts, counts, truth, meth_u = gen_param_u(
            values, read_depth, len(known),
            np.asarray(unknown_portion, np.float64), nb_samples, rng, disp)
        index_name = known + ["unknown_cell_1"]
        write_table(os.path.join(outdir, "meth_profile_sim.csv"),
                    ["unknown_cell_1"], [meth_u[:, 0]])
    else:
        meth_counts, counts, truth = gen_param(
            values, read_depth, nb_samples, rng, disp)
        index_name = list(order)

    write_table(os.path.join(outdir, "proportions_sim.csv"),
                [f"sample{i+1}" for i in range(nb_samples)], list(truth.T),
                index=index_name)

    sample_paths: List[str] = []
    for i in range(nb_samples):
        coverage = counts[:, i]
        modified = meth_counts[:, i]
        with np.errstate(divide="ignore", invalid="ignore"):
            percent = (modified / coverage) * 100
        path = os.path.join(outdir, f"sample{i+1}.bed")
        write_table(path, pos.names + ["valid_coverage", "count_modified",
                                       "percent_modified"],
                    pos.columns + [coverage, modified, percent])
        sample_paths.append(path)

    ref_path = os.path.join(outdir, "ref_matrix.bed")
    write_table(ref_path, pos.names + known,
                pos.columns + [by_name[c] for c in known])

    return {"samples": sample_paths, "ref": ref_path,
            "proportions": os.path.join(outdir, "proportions_sim.csv")}


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="demethify-tpu-torch-simulate",
        description="Generate an in-silico bulk methylation mixture "
                    "dataset from a reference BED.")
    parser.add_argument('--ref', required=True,
                        help='Reference BED (chrom start end celltypes...)')
    parser.add_argument('--outdir', required=True)
    parser.add_argument('--samples', type=int, default=10)
    parser.add_argument('--depth', type=float, default=50)
    parser.add_argument('--known', type=int, default=5)
    parser.add_argument('--unknown', nargs='+', type=float, default=None,
                        help='Per-sample unknown portions (enables the '
                             'unknown-component model)')
    parser.add_argument('--subsample', type=int, default=None)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--select', nargs='+', default=None,
                        help='Known cell types by name (reference '
                             'gen_u="select" mode)')
    parser.add_argument('--randomknown', action='store_true',
                        help='Pick the known cell types at random '
                             '(reference gen_u="random" mode)')
    args = parser.parse_args(argv)
    generate_dataset(args.ref, args.outdir, nb_samples=args.samples,
                     read_depth=args.depth, nb_known=args.known,
                     select_cell_types=args.select,
                     unknown_portion=args.unknown,
                     subsample=args.subsample, seed=args.seed,
                     random_known=args.randomknown)
    return 0


if __name__ == "__main__":
    main()
