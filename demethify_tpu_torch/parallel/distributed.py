"""Multi-process runs: joining the ranks, each rank's block of the rows, and
the sums across the ranks.

Counterpart of ``demethify_tpu/parallel/distributed.py`` and of the JAX
solvers' ``_axis_sum`` / ``_axis_max`` (``solvers/fused.py:48-56``):

- ``initialize_layout`` joins N processes with ``torch.distributed`` (a
  gloo process group at ``tcp://ADDR``, or at a ``file://`` store) and
  gives each rank its card (``LOCAL_RANK``, else the process id, modulo
  the cards it sees); a no-op for one process. With ``--multihost N ID
  --shard`` it joins the 2-D layout: N processes of M workers each (a
  worker a card), worker i of process ID as rank ID M + i of one world,
  with two families of groups (``Layout``): ``rows``, the M workers of
  one process, over which a solve's rows are sharded, and ``across``, the
  N workers that share a local index, over which replicates or model
  ranks are partitioned (the JAX package's local row mesh and its
  processes).
- ``Axis`` sums, maxes and gathers across the ranks: the solvers' sums
  over the CpG axis and the replicate and model-selection partitions. It
  is the identity without a group (``LOCAL``).
- ``Shard``: a rank's block of a row-sharded dataset and what the
  set-up needs of it without the other ranks' rows: its padded rows
  zeroed, this rank's rows of a draw made whole on every rank (so that N
  ranks draw the one-rank numbers), and the rows gathered where a branch
  is small by definition.
- ``shard_dataset_global`` and ``addressable_row_block``: a rank's block
  of the loaded rows and its global offset (``parallel/mesh.RowBlock``).
- ``run_ranks`` starts local ranks as processes, with a deadline.

Transport: the sums go over NCCL when every rank holds a card of its own
(checked by gathering the cards' UUIDs), else over gloo, which reduces on
the host: two ranks on one card, and every CPU run. The choice is made
from the layout and printed; a failing NCCL is an error, never a switch
to gloo. Both give every rank the same bits of a sum, which the solvers
rely on: each rank runs the replicated alpha phase and its own
termination test on them. What is not a sum (an eigendecomposition on
the card, the ICA's rotation search) runs on the axis's rank 0 alone and
is broadcast (``Axis.on_root``), so every rank holds the same bits.
"""

import os
import subprocess
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from demethify_tpu_torch.device import resolve_device
from demethify_tpu_torch.parallel.mesh import RowBlock, row_block

# how long a rank waits in a collective for the others
TIMEOUT = timedelta(minutes=30)


class Axis:
    """The ranks that share a solve's CpG rows (or a partition of
    replicates or model ranks). ``group`` is the gloo process group (None:
    one process, every method the identity); ``device_group`` an NCCL
    group over the same ranks when each has a card of its own.
    ``one_process``: every rank is a worker of one launching process (the
    JAX package's fully addressable arrays: ``--shard`` alone); False when
    the ranks span processes (``--multihost``)."""

    def __init__(self, group=None, device_group=None, one_process=True):
        self.group = group
        self.device_group = device_group
        self.one_process = one_process

    @property
    def size(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def backend(self) -> str:
        if self.group is None:
            return "none"
        return "nccl" if self.device_group is not None else "gloo"

    def _flat(self, xs: Sequence[torch.Tensor], collective):
        """``collective(flat, group)`` on xs flattened into one tensor (one
        dtype), on the card's NCCL group or through the host's gloo; the
        result split back into xs' shapes."""
        dtypes = {x.dtype for x in xs}
        if len(dtypes) != 1:
            raise ValueError(f"Axis: one collective takes one dtype, got "
                             f"{sorted(map(str, dtypes))}")
        flat = torch.cat([x.reshape(-1) for x in xs])
        if self.device_group is not None:
            collective(flat, self.device_group)
        else:
            host = flat.cpu()
            collective(host, self.group)
            flat = host.to(flat.device)
        out, lo = [], 0
        for x in xs:
            out.append(flat[lo:lo + x.numel()].view(x.shape))
            lo += x.numel()
        return tuple(out)

    def _reduce(self, xs: Sequence[torch.Tensor], op):
        if self.group is None:
            return tuple(xs)
        return self._flat(xs, lambda t, g: dist.all_reduce(t, op, group=g))

    def sum_(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the ranks (a new tensor; x itself without a
        group)."""
        return self._reduce([x], dist.ReduceOp.SUM)[0]

    def sums(self, *xs: torch.Tensor):
        """Each of xs summed over the ranks, in ONE collective (one
        dtype): the solvers' per-iteration Gram partials."""
        return self._reduce(xs, dist.ReduceOp.SUM)

    def max_(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce([x], dist.ReduceOp.MAX)[0]

    def min_(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce([x], dist.ReduceOp.MIN)[0]

    def on_root(self, make: Callable, *likes: torch.Tensor):
        """make()'s tuple of tensors (one dtype), computed on the axis's
        rank 0 alone and broadcast in one collective; the other ranks pass
        ``likes``, tensors of the same shapes and dtype. Without a group,
        make() itself."""
        if self.group is None:
            return tuple(make())
        xs = tuple(make()) if self.rank == 0 else likes
        src = dist.get_global_rank(self.group, 0)
        return self._flat(xs, lambda t, g: dist.broadcast(t, src, group=g))

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x (each the same shape) concatenated along the
        rows in rank order, on every rank (x itself without a group)."""
        if self.group is None:
            return x
        on_card = self.device_group is not None
        src = x.contiguous() if on_card else x.cpu().contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src,
                        group=self.device_group if on_card else self.group)
        return torch.cat(parts).to(x.device)

    def all_gather_object(self, obj) -> list:
        """[obj of rank 0, obj of rank 1, ...] on every rank (pickled over
        gloo: host objects, numpy arrays)."""
        if self.group is None:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def broadcast_object(self, obj, src: int = 0):
        """The obj of the axis's rank ``src`` on every rank."""
        if self.group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(
            box, src=dist.get_global_rank(self.group, src), group=self.group)
        return box[0]

    def barrier(self):
        if self.group is not None:
            dist.barrier(group=self.group)


LOCAL = Axis()


def local_card(proc_id: int) -> int:
    """The card index of this rank among the cards it sees: LOCAL_RANK
    when the launcher sets it, else the process id, modulo the count."""
    local = int(os.environ.get("LOCAL_RANK", proc_id))
    return local % torch.cuda.device_count()


def _nccl_group(ranks: Sequence[int], cards):
    """An NCCL group over ``ranks`` when each holds a card of its own,
    else None (the group's sums then go over gloo, through the host).
    Every rank of the world must call this for every group, in the same
    order."""
    if cards is None or len({cards[r] for r in ranks}) != len(ranks):
        return None
    return dist.new_group(ranks=list(ranks), backend="nccl",
                          timeout=TIMEOUT)


@dataclass
class Layout:
    """The axes of a run: ``world``, every rank (a plain solve's rows are
    sharded over it); ``rows``, the workers of this process (a sweep's or
    a weights bootstrap's solves are row-sharded over it); ``across``,
    the workers of every process that share this one's local index (the
    model ranks and replicates are partitioned over it). A group of one
    rank is ``LOCAL``."""

    world: Axis
    rows: Axis
    across: Axis


def initialize_layout(address: Optional[str], n_procs: int, proc_id: int,
                      n_local: int = 1, local_id: int = 0,
                      device_name: str = "cuda"):
    """Join ``n_procs`` processes of ``n_local`` workers each as worker
    ``local_id`` of process ``proc_id`` (world rank proc_id n_local +
    local_id) -> (Layout, device). ``address`` is ``host:port`` (a TCP
    store served by rank 0) or a ``file://`` path. Every rank creates
    every group, in the same order: the ``rows`` groups, process by
    process, then the ``across`` groups, local index by local index; a
    group (the world too) also gets an NCCL group when its workers hold
    distinct cards (gloo otherwise, chosen from the cards' UUIDs, never
    as a fallback). One rank in all: (Layout(LOCAL, LOCAL, LOCAL), the
    device), nothing joined. ``device_name`` "cuda" without a GPU
    raises."""
    if not 0 <= proc_id < n_procs:
        raise ValueError(f"--multihost process id {proc_id} is not in "
                         f"[0, {n_procs})")
    if not 0 <= local_id < n_local:
        raise ValueError(f"worker {local_id} is not in [0, {n_local})")
    size = n_procs * n_local
    if size <= 1:
        return Layout(LOCAL, LOCAL, LOCAL), resolve_device(device_name)
    rank = proc_id * n_local + local_id
    if device_name == "cuda":
        resolve_device("cuda")          # raises without a GPU
        torch.cuda.set_device(local_card(rank))
    device = resolve_device(device_name)
    init = address if "://" in address else f"tcp://{address}"
    dist.init_process_group("gloo", init_method=init, world_size=size,
                            rank=rank, timeout=TIMEOUT)
    world = Axis(dist.group.WORLD, one_process=n_procs == 1)
    cards = None
    if device.type == "cuda":
        cards = world.all_gather_object(
            str(torch.cuda.get_device_properties(device).uuid))
    world.device_group = _nccl_group(range(size), cards)

    def family(groups, mine, one_process):
        """The Axis of group ``mine`` of ``groups`` (each a list of world
        ranks), after every rank made every group."""
        out = LOCAL
        for i, ranks in enumerate(groups):
            if len(ranks) == 1:
                continue
            if len(ranks) == size:
                axis = world
            else:
                axis = Axis(dist.new_group(ranks=ranks, backend="gloo",
                                           timeout=TIMEOUT),
                            one_process=one_process)
                axis.device_group = _nccl_group(ranks, cards)
            if i == mine:
                out = axis
        return out

    rows = family([[p * n_local + i for i in range(n_local)]
                   for p in range(n_procs)], proc_id, True)
    across = family([[p * n_local + i for p in range(n_procs)]
                     for i in range(n_local)], local_id, False)
    print(f"[multihost] rank {rank} of {size} (worker {local_id} of process "
          f"{proc_id}) on {device}: sums over the CpG rows by "
          f"{world.backend}; rows over {rows.size}, across {across.size}",
          flush=True)
    return Layout(world, rows, across), device


def shutdown(axis: Axis):
    if axis.group is not None:
        dist.destroy_process_group()


@dataclass
class Shard:
    """A row-sharded dataset's layout on one rank: the axis its sums go
    over and its block of the rows (``block.n_data`` data rows, then
    zero padding). The set-up (inits, the supervised WLS, minka's
    spectrum, the bootstrap's draws) runs on the rank's rows through it;
    no rank holds another's rows, but for a branch that is small by
    definition (``gather``)."""

    axis: Axis
    block: RowBlock

    @classmethod
    def whole(cls, n_rows: int) -> "Shard":
        """One rank holding all ``n_rows`` rows (every method the
        identity)."""
        return cls(LOCAL, row_block(n_rows, 1, 0))

    @property
    def n_rows(self) -> int:
        """The global count of data rows."""
        return self.block.n_rows

    def data_rows(self, x: torch.Tensor) -> torch.Tensor:
        """x (this rank's rows along dim 0) with its padded rows zeroed:
        what a set-up sum must see where an op makes a padded row
        non-zero (a residual clipped at 1e-8)."""
        if self.block.n_data == x.shape[0]:
            return x
        keep = torch.arange(x.shape[0], device=x.device) < self.block.n_data
        return torch.where(keep.view(-1, *([1] * (x.dim() - 1))), x,
                           torch.zeros((), dtype=x.dtype, device=x.device))

    def rows_of(self, x):
        """This rank's rows of the global ``x`` (its n_rows rows along dim
        0, padded with zeros to the block): a draw made whole on every
        rank, so that the N-rank numbers are the one-rank ones."""
        if self.axis.size == 1:
            return x
        return self.block.take(x)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global data rows of x (this rank's rows along dim 0), on
        every rank: for the branches that are small by definition (the
        dense SVD below 16 rows a column, the primal ICA, minka's exact
        spectrum)."""
        if self.axis.size == 1:
            return x[:self.n_rows]
        return self.axis.gather_rows(x)[:self.n_rows]


def axis_of(shard: Optional[Shard]) -> Axis:
    """The axis of ``shard``; LOCAL for None (one rank)."""
    return LOCAL if shard is None else shard.axis


def shard_dataset_global(meth: np.ndarray, counts: np.ndarray,
                         ref: Optional[np.ndarray], axis: Axis,
                         to_device: Callable):
    """This rank's block of the loaded (meth, counts, ref) rows ->
    (block, y, d, ref) with the three arrays moved by ``to_device``
    (``ref`` None stays None). Rows are padded with zeros to a multiple
    of the rank count: zero coverage makes them inert."""
    block = row_block(meth.shape[0], axis.size, axis.rank)
    return (block, *(None if x is None else to_device(block.take(x))
                     for x in (meth, counts, ref)))


def addressable_row_block(u: torch.Tensor, block: RowBlock):
    """(this rank's data rows of its u block as numpy, their first global
    row): what a rank writes to its profile part file."""
    return u[:block.n_data].detach().cpu().numpy(), block.start


def run_ranks(commands: List[List[str]], timeout: float,
              envs: Optional[List[dict]] = None, cwd=None) -> List[int]:
    """Run one process per command and wait for all of them, at most
    ``timeout`` seconds. When one exits non-zero, or the deadline passes,
    the others are killed (a rank left alone would wait in its next
    collective). Returns the exit codes (-9 for a process killed)."""
    procs = [subprocess.Popen(cmd, env=None if envs is None else envs[i],
                              cwd=cwd) for i, cmd in enumerate(commands)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = any(p.returncode not in (None, 0) for p in procs)
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    return [p.returncode for p in procs]
