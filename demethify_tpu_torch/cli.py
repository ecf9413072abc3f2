"""Command-line interface of the port, flag-compatible with
``demethify_tpu/cli.py`` for its four modes: reference-based (``--ref``
without ``--nbunknown``), partial-reference (``--ref --nbunknown k``),
purity-constrained (``--ref --nbunknown k --purity p_1 ... p_n``) and
unsupervised (``--nbunknown k`` without ``--ref``).

``--device {cuda,cpu}`` (default cuda; a missing GPU is an error, never a
silent fallback) replaces the JAX CLI's ``--platform``. ``--dtype
{float32,float64,bfloat16}`` is the JAX CLI's: bfloat16 loads the data
in float32, moves it to the device and stores Y, D and R there in bf16,
with a float32 solver state (the termination warning then speaks of
float32, as the JAX CLI's does). ``--confidence LEVEL B`` (bootstrap
confidence intervals, before the point estimate, as the reference runs
them) and ``--cimethod {auto,resample,weights}`` run through
``uncertainty/bootstrap.py``. ``--init`` takes uniform, uniform_, beta,
SVD or ICA. ``--ic NAME [n_restarts]`` (AIC, BIC, CCC, BCV or minka;
5 restarts or folds by default) chooses the number of unknowns from 1 to
``--icmax`` (default 25) through ``selection/sweep.py``; it refuses
``--nbunknown``, as the JAX CLI does. Flags of modes and features that
later slices port exit with an error naming the ROADMAP port-queue item.

Reproduced conventions: ``nargs=1`` flags arrive as 1-lists and are
unwrapped; the default iterations are (10000, 20), or (100, 500) with
``--purity``; purity values are percentages in [0, 100], one per sample,
flipped to the known-block mass 1 - p/100; the termination resolution
warning is printed unless ``--reltol``.
"""

import argparse
import os
import sys
from time import time

import numpy as np

LOGO = r"""
    ____                      __  __    _ ____        __
   / __ \___  ____ ___  ___  / /_/ /_  (_) __/_  __  / /_____  __  __
  / / / / _ \/ __ `__ \/ _ \/ __/ __ \/ / /_/ / / / / __/ __ \/ / / /
 / /_/ /  __/ / / / / /  __/ /_/ / / / / __/ /_/ / / /_/ /_/ / /_/ /
/_____/\___/_/ /_/ /_/\___/\__/_/ /_/_/_/  \__, /  \__/ .___/\__,_/
                                          /____/     /_/
"""

# flag -> the ROADMAP port-queue item that ports it
NOT_PORTED = {
    "shard": "item 8 (torch.distributed)",
    "multihost": "item 8 (torch.distributed)",
    "savestate": "item 5 (checkpoints)",
    "initstate": "item 5 (checkpoints)",
    "profile": "item 11 (observability: --profile, --debugnans, --plot)",
    "debugnans": "item 11 (observability: --profile, --debugnans, --plot)",
    "plot": "item 11 (observability: --profile, --debugnans, --plot)",
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="demethify-tpu-torch",
        description="DeMethify - Partial reference-based Methylation "
                    "Deconvolution (PyTorch / CUDA port)")
    parser.add_argument('--methfreq', nargs='+', type=str, required=True,
                        help='Methylation frequency file path (values '
                             'between 0 and 1)')
    parser.add_argument('--ref', nargs='?', type=str,
                        help='Methylation reference matrix file path')
    parser.add_argument('--iterations', nargs=2, type=int,
                        help='Numbers of iterations for outer and inner '
                             'loops (default 10000, 20; 100, 500 with '
                             '--purity)')
    parser.add_argument('--nbunknown', nargs=1, type=int,
                        help='Number of unknown cell types to estimate')
    parser.add_argument('--termination', nargs=1, type=float, default=1e-2,
                        help='Termination condition for cost function '
                             '(default = 1e-2)')
    parser.add_argument('--init', nargs='?', default='uniform_',
                        help='Initialisation option: uniform, uniform_ '
                             '(default), beta, SVD or ICA')
    parser.add_argument('--outdir', nargs='?', required=True,
                        help='Output directory')
    parser.add_argument('--fillna', action='store_true',
                        help='Replace every NA by 0 in the given data')
    parser.add_argument('--restart', nargs=1, type=int,
                        help='Number of random restarts among which to '
                             'select the one with the lowest cost')
    parser.add_argument('--seed', nargs=1, type=int, default=1,
                        help='Seed for random number generation')
    parser.add_argument('--noprint', action='store_true',
                        help="Doesn't show the logo.")
    parser.add_argument('--bedmethyl', action='store_true',
                        help='Inputs are bedmethyl files, modkit style')
    parser.add_argument('--device', choices=['cuda', 'cpu'],
                        default='cuda',
                        help='Run on the GPU with the CUDA kernels (cuda, '
                             'default) or with plain PyTorch on the CPU')
    parser.add_argument('--dtype', choices=['float32', 'float64',
                                            'bfloat16'],
                        default='float32', help='Compute dtype on device')
    parser.add_argument('--reltol', action='store_true',
                        help='Interpret --termination as a fraction of the '
                             'initial cost')
    parser.add_argument('--trace', action='store_true',
                        help='Record and write the solver cost trajectory '
                             'to <outdir>/cost_trajectory.csv')
    parser.add_argument('--purity', nargs='+', type=float,
                        help='Purity of each sample in percent (one value '
                             'per sample): the known cell types make up '
                             '1 - p/100 of it')
    parser.add_argument('--confidence', nargs=2, type=int,
                        help='Outputs bootstrap confidence intervals, takes '
                             'confidence level and bootstrap iterations '
                             'number as input, example : --confidence 95 '
                             '1000')
    parser.add_argument('--cimethod', choices=['auto', 'resample',
                                               'weights'],
                        default='auto',
                        help='Bootstrap layout: "resample" gathers '
                             'replicate copies of (Y, D, R); "weights" '
                             'solves the equivalent row-multiplicity '
                             'problem with no copies (on the GPU all '
                             'replicates of a chunk share one pass over the '
                             'data); "auto" takes weights from 2M data '
                             'elements on')
    parser.add_argument('--ic', nargs='+',
                        help='Select the number of unknown cell types by '
                             'minimising a criterion (AIC, BIC, CCC, BCV, '
                             'minka), optionally followed by the number of '
                             'restarts or folds (default 5)')
    parser.add_argument('--icmax', nargs=1, type=int, default=[25],
                        help='Upper end of the --ic sweep range '
                             '(default 25)')
    # accepted so that a JAX-CLI command line fails with a clear message
    parser.add_argument('--plot', action='store_true', help='Not ported yet')
    parser.add_argument('--shard', action='store_true',
                        help='Not ported yet')
    parser.add_argument('--multihost', nargs=3, help='Not ported yet')
    parser.add_argument('--savestate', type=str, help='Not ported yet')
    parser.add_argument('--initstate', type=str, help='Not ported yet')
    parser.add_argument('--profile', type=str, help='Not ported yet')
    parser.add_argument('--debugnans', action='store_true',
                        help='Not ported yet')
    return parser


def _refuse_unported(args) -> None:
    for flag, item in NOT_PORTED.items():
        if getattr(args, flag):
            sys.exit(f"Error: --{flag} is not ported to PyTorch yet "
                     f"(ROADMAP port queue {item}).")


def flip_purity(percent, n_samples: int):
    """Purity percentages -> the known-block mass 1 - p/100 per sample,
    validated as the JAX CLI does (``demethify_tpu/cli.py:226-242``)."""
    purity_arr = np.array(percent, dtype=np.float64)
    if np.any((purity_arr < 0) | (purity_arr > 100)):
        sys.stderr.write("Error: Invalid value for purity, not within "
                         "[0,100] bounds.")
        sys.exit(1)
    if np.any((purity_arr >= 0) & (purity_arr <= 1)):
        print("Purity is between 0 and 1, are you sure that it's a "
              "percentage?")
    purity = 1.0 - (purity_arr / 100.0)
    if len(purity) != n_samples:
        sys.stderr.write(
            f"Error: --purity needs one value per sample ({n_samples} "
            f"samples, {len(purity)} purity values given).\n")
        sys.exit(1)
    return purity


def main(argv=None):
    args = build_parser().parse_args(argv)
    _refuse_unported(args)

    import torch

    from demethify_tpu_torch.device import (
        resolve_device,
        resolve_dtype,
        state_dtype,
    )
    from demethify_tpu_torch.io.readers import load_dataset
    from demethify_tpu_torch.io.writers import (
        write_ci_profile,
        write_ci_proportions,
        write_log,
        write_profile_estimate,
        write_proportions,
    )
    from demethify_tpu_torch.solvers.api import (
        partial_reference_deconv,
        purity_deconv,
        supervised_deconv,
        unsupervised_deconv,
    )
    from demethify_tpu_torch.selection.sweep import evaluate_best_ic
    from demethify_tpu_torch.state import purity_from_numpy
    from demethify_tpu_torch.uncertainty.bootstrap import bootstrap_ci
    from demethify_tpu_torch.utils import (
        SolveStats,
        termination_resolution_warning,
        write_cost_trace,
    )

    device = resolve_device(args.device)
    dtype = resolve_dtype(args.dtype)
    restart = 1 if args.restart is None else args.restart[0]
    if not args.iterations:
        args.iterations = [100, 500] if args.purity else [10000, 20]
    purity = (flip_purity(args.purity, len(args.methfreq)) if args.purity
              else None)
    termination = (args.termination[0] if isinstance(args.termination, list)
                   else args.termination)
    seed = args.seed[0] if isinstance(args.seed, list) else args.seed
    ic_name, nb_r = None, 5
    if args.ic:
        if args.nbunknown:
            sys.exit("Error: --ic cannot be used with --nbunknown.")
        ic_name = args.ic[0]
        if len(args.ic) > 1:
            nb_r = int(args.ic[1])

    if not args.noprint:
        print(LOGO)
    outdir = os.path.join(os.getcwd(), args.outdir)
    if not os.path.exists(outdir):
        print(f'Creating directory {outdir} to store results')
        os.makedirs(outdir, exist_ok=True)
    n_u = 0 if args.nbunknown is None else args.nbunknown[0]
    if args.confidence and not args.ref and n_u == 0:
        sys.stderr.write("Error: --confidence without --ref needs "
                         "--nbunknown (unsupervised bootstrap).\n")
        sys.exit(1)
    if n_u < 0 or (n_u == 0 and not args.ref and not ic_name):
        sys.exit(f'Invalid number of unknown value! : "{n_u}" ')

    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    ds = load_dataset(args.methfreq, ref=args.ref, bedmethyl=args.bedmethyl,
                      fillna=args.fillna, dtype=np_dtype)
    if not args.reltol:
        cost_scale = float(np.einsum("is,is,is->", ds.counts, ds.meth_f,
                                     ds.meth_f, dtype=np.float64))
        msg = termination_resolution_warning(termination, cost_scale,
                                             state_dtype(dtype))
        if msg:
            print(msg)

    def on_device(x):
        """numpy -> the device, then cast there to the storage dtype"""
        return torch.as_tensor(x).to(device).to(dtype)

    y, d = on_device(ds.meth_f), on_device(ds.counts)
    ref_mat = None if ds.ref is None else on_device(ds.ref)
    header = list(ds.header)

    time_start = time()
    purity_t = (None if purity is None else
                purity_from_numpy(purity, device=device, dtype=y.dtype))
    # bootstrap CIs first, like the reference (demethify.py:151-152)
    if args.confidence:
        level, n_boot = args.confidence
        lo_p, hi_p, lo_u, hi_u = bootstrap_ci(
            y, d, ref_mat, n_u, level=level, n_bootstrap=n_boot,
            init_option=args.init, n_iter1=args.iterations[0],
            n_iter2=args.iterations[1], tol=termination, purity=purity_t,
            seed=seed, method=args.cimethod, tol_relative=args.reltol)
        unknown_header = [f"unknown_cell_{i+1}" for i in range(n_u)]
        write_ci_proportions(outdir, lo_p, hi_p, header + unknown_header,
                             ds.sample_names)
        if n_u > 0:
            write_ci_profile(outdir, lo_u, hi_u, unknown_header)

    stats = SolveStats(y.shape[0], y.shape[1])
    res, ic_n_u = None, None
    kw = dict(init=args.init, seed=seed, n_restarts=restart,
              n_iter1=args.iterations[0], n_iter2=args.iterations[1],
              tol=termination, tol_relative=args.reltol,
              record_trace=args.trace)
    if ic_name:
        u_best, proportions, ic_n_u, _ = evaluate_best_ic(
            y, d, ref_mat, args.init, ic_name, seed=seed,
            iter1=args.iterations[0], iter2=args.iterations[1],
            tol=termination, tol_relative=args.reltol, n_restarts=nb_r,
            n_u_max=args.icmax[0])
        unknown_header = [f"unknown_cell_{i+1}" for i in range(ic_n_u)]
        header = (unknown_header if ref_mat is None
                  else header + unknown_header)
        write_profile_estimate(outdir, u_best.cpu().numpy(), unknown_header)
    elif n_u > 0:
        if ref_mat is None:
            res = unsupervised_deconv(y, d, n_u, **kw)
        elif purity is not None:
            res = purity_deconv(y, d, ref_mat, n_u, purity_t, **kw)
        else:
            res = partial_reference_deconv(y, d, ref_mat, n_u, **kw)
        unknown_header = [f"unknown_cell_{i+1}" for i in range(n_u)]
        header = (unknown_header if ref_mat is None
                  else header + unknown_header)
        write_profile_estimate(outdir, res.u.cpu().numpy(), unknown_header)
    else:
        res = supervised_deconv(y, d, ref_mat)
    time_tot = time() - time_start
    if res is not None:
        stats.finish(res.n_iter)
        proportions = res.proportions
        if args.trace and res.trace is not None and res.trace.numel():
            write_cost_trace(outdir, res.trace)

    props_np = proportions.cpu().numpy().astype(np.float64)
    write_proportions(outdir, props_np, header, ds.sample_names)
    print("All demethified! Results in " + outdir)
    write_log(outdir, time_tot, ic_name, ic_n_u)
    if res is not None and stats.elapsed:
        with open(os.path.join(outdir, 'log.log'), 'a') as f:
            f.write('\n' + stats.summary() + '\n')
    return 0


if __name__ == "__main__":
    sys.exit(main())
