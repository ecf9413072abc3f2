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
``--nbunknown``, as the JAX CLI does. ``--profile DIR`` writes a
``torch.profiler`` Chrome trace of the solve (``utils.device_profile``,
around the block the JAX CLI profiles); ``--debugnans`` turns on the
port's NaN checks (``utils.enable_nan_debugging``); ``--plot`` writes the
figures (``plotting.py``) and checks for matplotlib before it reads any
data.

Multi-process layouts (``parallel/distributed.py``): ``--multihost ADDR N
ID`` shards the plain solve's rows over the N processes and partitions
the bootstrap's replicates and the sweep's model ranks over them, each
on the full data; ``--shard`` starts a worker per GPU (one process and
one card: the single-device run) and row-shards every solve over them;
both together are the 2-D layout: N processes of M workers (a card
each), the plain solve's rows over all N M workers, the sweep's ranks
and the weights bootstrap's replicates over the processes, each solve
row-sharded over its process's workers, the resample bootstrap's
replicates over all workers on full copies of the data. A row-sharded
solve's set-up (its inits, the reference-based WLS, the weights
bootstrap's draws, the sweep's inits and minka's spectrum) runs on each
worker's rows, with the sums over the workers: no card holds rows other
than its own. Only the replicate-partitioned bootstrap and the
rank-partitioned sweep hold the full data on each process's card
(``full()``), as the JAX CLI's do.

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

# how long a --shard run waits for its workers
SHARD_TIMEOUT_S = 7 * 24 * 3600


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
    parser.add_argument('--shard', action='store_true',
                        help='Row-shard the CpG axis over all local GPUs: '
                             'one worker process per card, the Gram sums '
                             'over the cards by NCCL (one card, or --device '
                             'cpu: the single-device run)')
    parser.add_argument('--multihost', nargs=3, default=None,
                        metavar=('COORD', 'NPROC', 'PID'),
                        help='Join a multi-process run: the rendezvous '
                             'address (host:port, or a file:// path on a '
                             'shared filesystem), the process count and '
                             'this process id. Every process runs the same '
                             'command; the CpG rows are sharded over all of '
                             'them, process 0 writes the small outputs and '
                             'each process its methylation_profile_estimate'
                             '.partNNNN.csv')
    parser.add_argument('--savestate', type=str, default=None,
                        help='Save the converged factor state (U, alpha, '
                             'cost) to this directory (checkpoint.py)')
    parser.add_argument('--initstate', type=str, default=None,
                        help='Warm-start the solver from a --savestate '
                             'checkpoint instead of --init')
    parser.add_argument('--plot', action='store_true',
                        help='Plot cell type proportions estimates for each '
                             'sample, eventually with confidence intervals '
                             '(needs matplotlib)')
    parser.add_argument('--profile', type=str, default=None,
                        help='Write a torch.profiler trace of the solve '
                             '(CPU and GPU kernels, Chrome-trace JSON) to '
                             'this directory')
    parser.add_argument('--debugnans', action='store_true',
                        help='Raise FloatingPointError at the first outer '
                             'iteration whose u, alpha or cost is not '
                             'finite, and at a non-finite init, supervised '
                             'solve, bootstrap replicate or criterion')
    # a --shard run's worker: the rendezvous address, the process count,
    # this process's id, its worker count and this worker's index
    parser.add_argument('--shard-worker', nargs=5, default=None,
                        help=argparse.SUPPRESS)
    return parser


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


def _worker_argv(argv):
    """argv less ``--shard`` and every ``--multihost ADDR N ID``, that
    option under any prefix argparse takes for it (``--mu`` on: ``--m``
    is ambiguous with ``--methfreq``, and any prefix of ``--shard`` with
    ``--shard-worker``): the workers' own options."""
    out, i = [], 0
    while i < len(argv):
        if argv[i] == "--shard":
            i += 1
        elif len(argv[i]) >= 4 and "--multihost".startswith(argv[i]):
            i += 4
        else:
            out.append(argv[i])
            i += 1
    return out


def _run_shard_workers(argv, n_workers: int) -> int:
    """``--shard`` over ``n_workers`` workers, one a card (LOCAL_RANK),
    each this command as a ``--shard-worker``. Alone they join at a file
    store in a fresh temporary directory; with ``--multihost ADDR N ID``
    the N processes' workers join one world at ADDR (the 2-D layout).
    Returns 0 when every worker does, else the first failing worker's
    code (the others are then stopped)."""
    import tempfile

    from demethify_tpu_torch.parallel.distributed import run_ranks

    args = build_parser().parse_args(argv)
    worker_argv = _worker_argv(argv)
    with tempfile.TemporaryDirectory(prefix="demethify-shard-") as tmp:
        address, n_procs, proc_id = (
            args.multihost or ("file://" + os.path.join(tmp, "store"), 1, 0))
        commands = [[sys.executable, "-m", "demethify_tpu_torch",
                     *worker_argv, "--shard-worker", address, str(n_procs),
                     str(proc_id), str(n_workers), str(i)]
                    for i in range(n_workers)]
        envs = [dict(os.environ, LOCAL_RANK=str(i))
                for i in range(n_workers)]
        codes = run_ranks(commands, SHARD_TIMEOUT_S, envs)
    bad = [c for c in codes if c != 0]
    return bad[0] if bad else 0


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if args.plot:
        from demethify_tpu_torch.plotting import require
        require()
    if args.initstate and (args.ic or (args.ref and not args.nbunknown)):
        sys.stderr.write(
            "Error: --initstate warm-starts the iterative solvers; it "
            "cannot be used with --ic or the reference-based "
            "(no --nbunknown) mode.\n")
        sys.exit(1)

    import torch

    from demethify_tpu_torch.utils import enable_nan_debugging

    enable_nan_debugging(args.debugnans)
    if (args.shard and args.device == "cuda" and torch.cuda.is_available()
            and torch.cuda.device_count() > 1):
        return _run_shard_workers(argv, torch.cuda.device_count())

    from demethify_tpu_torch.parallel.distributed import (
        initialize_layout,
        shutdown,
    )

    if args.shard_worker:
        address, *ids = args.shard_worker
        n_procs, proc_id, n_local, local_id = map(int, ids)
    elif args.multihost:
        address = args.multihost[0]
        n_procs, proc_id = int(args.multihost[1]), int(args.multihost[2])
        n_local, local_id = 1, 0
    else:
        address, n_procs, proc_id, n_local, local_id = None, 1, 0, 1, 0
    layout, device = initialize_layout(address, n_procs, proc_id, n_local,
                                       local_id, args.device)
    try:
        return _run(args, layout, device)
    finally:
        shutdown(layout.world)


def _run(args, layout, device):
    """The run of one worker (rank ``layout.world.rank`` of
    ``layout.world.size``) on ``device``."""
    import torch

    from demethify_tpu_torch.device import resolve_dtype, state_dtype
    from demethify_tpu_torch.io.readers import load_dataset
    from demethify_tpu_torch.io.writers import (
        write_ci_profile,
        write_ci_proportions,
        write_log,
        write_profile_estimate,
        write_proportions,
    )
    from demethify_tpu_torch.parallel.distributed import (
        Shard,
        addressable_row_block,
        shard_dataset_global,
    )
    from demethify_tpu_torch.parallel.mesh import row_block
    from demethify_tpu_torch.solvers.api import (
        partial_reference_deconv,
        purity_deconv,
        supervised_deconv,
        unsupervised_deconv,
    )
    from demethify_tpu_torch.selection.sweep import evaluate_best_ic
    from demethify_tpu_torch.state import purity_from_numpy, restore_factors
    from demethify_tpu_torch.uncertainty.bootstrap import (
        bootstrap_ci,
        resolve_method,
        row_sharded,
    )
    from demethify_tpu_torch.utils import (
        SolveStats,
        device_profile,
        termination_resolution_warning,
        write_cost_trace,
    )

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

    axis, rows, across = layout.world, layout.rows, layout.across
    writer = axis.rank == 0
    if not args.noprint and writer:
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
    if not args.reltol and writer:
        cost_scale = float(np.einsum("is,is,is->", ds.counts, ds.meth_f,
                                     ds.meth_f, dtype=np.float64))
        msg = termination_resolution_warning(termination, cost_scale,
                                             state_dtype(dtype))
        if msg:
            print(msg)

    def on_device(x):
        """numpy -> the device, then cast there to the storage dtype"""
        return None if x is None else torch.as_tensor(x).to(device).to(dtype)

    sharded = axis.size > 1
    shard = None
    if sharded:
        block, y, d, ref_mat = shard_dataset_global(
            ds.meth_f, ds.counts, ds.ref, axis, on_device)
        shard = Shard(axis, block)
    else:
        block = row_block(ds.meth_f.shape[0], 1, 0)
        y, d, ref_mat = (on_device(x) for x in (ds.meth_f, ds.counts,
                                                ds.ref))
    full_data = {}

    def full():
        """The full (y, d, ref) on this worker's device: the process-local
        arrays of the replicate-partitioned bootstrap and the
        rank-partitioned sweep, as the JAX CLI has them (this process's
        own arrays when nothing is sharded)."""
        if not sharded:
            return y, d, ref_mat
        if not full_data:
            full_data["yd"] = tuple(on_device(x) for x in
                                    (ds.meth_f, ds.counts, ds.ref))
        return full_data["yd"]

    row_data = {}

    def row_shard():
        """(y, d, ref, Shard) of this worker's rows over ``rows`` (its
        process's workers): the 2-D layout's sweep and weights bootstrap.
        The plain solve's shard when ``rows`` is the world."""
        if rows is axis:
            return y, d, ref_mat, shard
        if not row_data:
            blk, *yd = shard_dataset_global(ds.meth_f, ds.counts, ds.ref,
                                            rows, on_device)
            row_data["yd"] = (*yd, Shard(rows, blk))
        return row_data["yd"]

    header = list(ds.header)
    n_s = ds.meth_f.shape[1]

    time_start = time()
    purity_t = (None if purity is None else
                purity_from_numpy(purity, device=device, dtype=y.dtype))
    # bootstrap CIs first, like the reference (demethify.py:151-152)
    ci = None
    if args.confidence:
        level, n_boot = args.confidence
        method = resolve_method(args.cimethod, args.init, ds.meth_f.size)
        ci_kw = dict(level=level, n_bootstrap=n_boot, init_option=args.init,
                     n_iter1=args.iterations[0], n_iter2=args.iterations[1],
                     tol=termination, purity=purity_t, seed=seed,
                     method=method, tol_relative=args.reltol)
        if (rows.size > 1
                and row_sharded(method, n_u, n_s, ref_mat is not None)):
            # --shard: the weights layout row-sharded over the process's
            # workers (K4 on each card's rows), the replicates over the
            # processes
            y_r, d_r, ref_r, shard_r = row_shard()
            lo_p, hi_p, lo_u, hi_u = bootstrap_ci(
                y_r, d_r, ref_r, n_u, axis=across, shard=shard_r, **ci_kw)
        else:
            # the replicates over every worker, each on the full data
            lo_p, hi_p, lo_u, hi_u = bootstrap_ci(*full(), n_u, axis=axis,
                                                  **ci_kw)
        unknown_header = [f"unknown_cell_{i+1}" for i in range(n_u)]
        ci = (lo_p, hi_p, header + unknown_header)
        if writer:
            write_ci_proportions(outdir, lo_p, hi_p,
                                 header + unknown_header, ds.sample_names)
            if n_u > 0:
                write_ci_profile(outdir, lo_u[:block.n_rows],
                                 hi_u[:block.n_rows], unknown_header)

    def write_profile(u, unknown_header, rows_sharded):
        """The unknown profiles: one file from rank 0, or in a
        row-sharded solve one part file per rank with its global rows."""
        if rows_sharded:
            part, start = addressable_row_block(u, block)
            if part.shape[0]:
                write_profile_estimate(outdir, part, unknown_header,
                                       suffix=f".part{axis.rank:04d}",
                                       row_offset=start)
        elif writer:
            write_profile_estimate(outdir, u.cpu().numpy(), unknown_header)

    init_provided = None
    if args.initstate:
        try:
            init_provided = restore_factors(args.initstate, block,
                                            device=device, dtype=y.dtype)
        except ValueError as e:
            sys.stderr.write(f"Error: {e}\n")
            sys.exit(1)

    stats = SolveStats(block.n_rows, n_s)
    res, ic_n_u, list_ic = None, None, None
    profile = device_profile(args.profile, "trace.json" if axis.size == 1
                             else f"trace.rank{axis.rank:04d}.json")
    profile.__enter__()
    kw = dict(init=args.init, seed=seed, n_restarts=restart,
              n_iter1=args.iterations[0], n_iter2=args.iterations[1],
              tol=termination, tol_relative=args.reltol,
              record_trace=args.trace, init_provided=init_provided,
              shard=shard)
    if ic_name:
        # the model ranks over the processes; each solve row-sharded over
        # the process's workers (on the full data with one worker)
        ic_kw = dict(seed=seed, iter1=args.iterations[0],
                     iter2=args.iterations[1], tol=termination,
                     tol_relative=args.reltol, n_restarts=nb_r,
                     n_u_max=args.icmax[0], axis=across)
        if rows.size > 1:
            y_r, d_r, ref_r, shard_r = row_shard()
            u_best, proportions, ic_n_u, list_ic = evaluate_best_ic(
                y_r, d_r, ref_r, args.init, ic_name, shard=shard_r, **ic_kw)
            u_best = torch.as_tensor(np.concatenate(rows.all_gather_object(
                u_best[:shard_r.block.n_data].cpu().numpy())))
        else:
            u_best, proportions, ic_n_u, list_ic = evaluate_best_ic(
                *full(), args.init, ic_name, **ic_kw)
        unknown_header = [f"unknown_cell_{i+1}" for i in range(ic_n_u)]
        header = (unknown_header if ref_mat is None
                  else header + unknown_header)
        write_profile(u_best, unknown_header, False)
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
        write_profile(res.u, unknown_header, sharded)
    else:
        # the reference-based WLS, its sums over the ranks when sharded
        res = supervised_deconv(y, d, ref_mat, axis=axis)
    profile.__exit__(None, None, None)
    time_tot = time() - time_start
    if res is not None:
        stats.finish(res.n_iter)
        proportions = res.proportions
        if args.savestate:
            from demethify_tpu_torch.checkpoint import save_factors
            u_rows = None
            if res.u is not None:
                u_rows = res.u[:block.n_data] if sharded else res.u
            save_factors(args.savestate, alpha=res.proportions,
                         cost=torch.as_tensor(res.cost), u=u_rows,
                         row_start=block.start, n_rows=block.n_rows,
                         axis=axis)
        if (args.trace and writer and res.trace is not None
                and res.trace.numel()):
            write_cost_trace(outdir, res.trace)
    if not writer:
        return 0

    props_np = proportions.cpu().numpy().astype(np.float64)
    write_proportions(outdir, props_np, header, ds.sample_names)
    print("All demethified! Results in " + outdir)
    write_log(outdir, time_tot, ic_name, ic_n_u)
    if res is not None and stats.elapsed:
        with open(os.path.join(outdir, 'log.log'), 'a') as f:
            f.write('\n' + stats.summary() + '\n')
    if args.plot:
        from demethify_tpu_torch.plotting import (
            intervals_by_name,
            plot_proportions,
        )
        plot_proportions(props_np, header, ds.sample_names, outdir,
                         None if ci is None else intervals_by_name(*ci,
                                                                   header),
                         list_ic)
    return 0


if __name__ == "__main__":
    sys.exit(main())
