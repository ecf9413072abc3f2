"""Command-line interface of the port: the reference-based mode (``--ref``
without ``--nbunknown``) and the partial-reference mode (``--ref
--nbunknown k``), flag-compatible with ``demethify_tpu/cli.py`` for
these modes.

``--device {cuda,cpu}`` (default cuda; a missing GPU is an error, never a
silent fallback) and ``--dtype {float32,float64}`` replace the JAX CLI's
``--platform`` and ``--dtype``. Flags of modes and features that later
slices port exit with an error naming the ROADMAP port-queue item.

Reproduced conventions: ``nargs=1`` flags arrive as 1-lists and are
unwrapped; the default iterations are (10000, 20); the termination
resolution warning is printed unless ``--reltol``.
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
    "purity": "item 2 (K3 and purity mode)",
    "ic": "item 6 (model selection)",
    "icmax": "item 6 (model selection)",
    "confidence": "item 7 (bootstrap CIs)",
    "cimethod": "item 7 (bootstrap CIs)",
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
                             'loops (default 10000, 20)')
    parser.add_argument('--nbunknown', nargs=1, type=int,
                        help='Number of unknown cell types to estimate')
    parser.add_argument('--termination', nargs=1, type=float, default=1e-2,
                        help='Termination condition for cost function '
                             '(default = 1e-2)')
    parser.add_argument('--init', nargs='?', default='uniform_',
                        help='Initialisation option: uniform, uniform_ '
                             '(default) or beta')
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
    # accepted so that a JAX-CLI command line fails with a clear message
    parser.add_argument('--purity', nargs='+', type=float,
                        help='Not ported yet')
    parser.add_argument('--ic', nargs='+', help='Not ported yet')
    parser.add_argument('--icmax', nargs=1, type=int, help='Not ported yet')
    parser.add_argument('--confidence', nargs=2, type=int,
                        help='Not ported yet')
    parser.add_argument('--cimethod', help='Not ported yet')
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
    if not args.ref:
        sys.exit("Error: running without --ref (unsupervised mode) is not "
                 "ported to PyTorch yet (ROADMAP port queue item 1).")
    if args.dtype == "bfloat16":
        sys.exit("Error: --dtype bfloat16 is not ported to PyTorch yet "
                 "(ROADMAP port queue item 9).")


def main(argv=None):
    args = build_parser().parse_args(argv)
    _refuse_unported(args)

    import torch

    from demethify_tpu_torch.device import resolve_device, resolve_dtype
    from demethify_tpu_torch.io.readers import load_dataset
    from demethify_tpu_torch.io.writers import (
        write_log,
        write_profile_estimate,
        write_proportions,
    )
    from demethify_tpu_torch.solvers.api import (
        partial_reference_deconv,
        supervised_deconv,
    )
    from demethify_tpu_torch.utils import (
        SolveStats,
        termination_resolution_warning,
        write_cost_trace,
    )

    device = resolve_device(args.device)
    dtype = resolve_dtype(args.dtype)
    restart = 1 if args.restart is None else args.restart[0]
    if not args.iterations:
        args.iterations = [10000, 20]
    termination = (args.termination[0] if isinstance(args.termination, list)
                   else args.termination)
    seed = args.seed[0] if isinstance(args.seed, list) else args.seed

    if not args.noprint:
        print(LOGO)
    outdir = os.path.join(os.getcwd(), args.outdir)
    if not os.path.exists(outdir):
        print(f'Creating directory {outdir} to store results')
        os.makedirs(outdir, exist_ok=True)
    n_u = 0 if args.nbunknown is None else args.nbunknown[0]
    if n_u < 0:
        sys.exit(f'Invalid number of unknown value! : "{n_u}" ')

    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    ds = load_dataset(args.methfreq, ref=args.ref, bedmethyl=args.bedmethyl,
                      fillna=args.fillna, dtype=np_dtype)
    if not args.reltol:
        cost_scale = float(np.einsum("is,is,is->", ds.counts, ds.meth_f,
                                     ds.meth_f, dtype=np.float64))
        msg = termination_resolution_warning(termination, cost_scale, dtype)
        if msg:
            print(msg)
    y = torch.as_tensor(ds.meth_f).to(device)
    d = torch.as_tensor(ds.counts).to(device)
    ref_mat = torch.as_tensor(ds.ref).to(device)
    header = list(ds.header)

    time_start = time()
    stats = SolveStats(y.shape[0], y.shape[1])
    if n_u > 0:
        res = partial_reference_deconv(
            y, d, ref_mat, n_u, init=args.init, seed=seed,
            n_restarts=restart, n_iter1=args.iterations[0],
            n_iter2=args.iterations[1], tol=termination,
            tol_relative=args.reltol, record_trace=args.trace)
        unknown_header = [f"unknown_cell_{i+1}" for i in range(n_u)]
        header += unknown_header
        write_profile_estimate(outdir, res.u.cpu().numpy(), unknown_header)
    else:
        res = supervised_deconv(y, d, ref_mat)
    time_tot = time() - time_start
    stats.finish(res.n_iter)
    if args.trace and res.trace is not None and res.trace.numel():
        write_cost_trace(outdir, res.trace)

    props_np = res.proportions.cpu().numpy().astype(np.float64)
    write_proportions(outdir, props_np, header, ds.sample_names)
    print("All demethified! Results in " + outdir)
    write_log(outdir, time_tot)
    if stats.elapsed:
        with open(os.path.join(outdir, 'log.log'), 'a') as f:
            f.write('\n' + stats.summary() + '\n')
    return 0


if __name__ == "__main__":
    sys.exit(main())
