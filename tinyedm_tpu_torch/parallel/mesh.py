"""Data and tensor parallelism, and ZeRO-1, on ``torch.distributed``.

Counterpart of ``tinyedm_tpu/parallel/mesh.py``. The JAX package places a
global batch on a (data, model) mesh and lets GSPMD insert the collectives;
the port runs one process per card (``torchrun`` or ``python -m
torch.distributed.run``, ``init_distributed``) and makes every collective
itself:

- The ranks form a ``data x model`` grid (``make_grid``), the model index
  fastest: ``rank = d * model_size + m``, the JAX ``make_mesh`` reshape. Each
  model group (the ``model_size`` ranks of one ``d``) shares its rows of the
  batch; each data group (the ranks of one ``m``) splits the batch. Every
  rank creates every group, in the same order.
- Rows: every rank iterates the same global batches (the data modules
  shuffle from a shared seed) and trains on its data rank's contiguous share
  (``process_local_slice``, ``shard_batch``); a data module that yields only
  its own rows says so with ``yields_process_local`` and is not sliced again.
- Tensor parallelism (``model_size > 1``): every weight-normed kernel whose
  output count divides ``model_size`` is stored, updated and averaged as its
  rank's shard of output channels (``tp_shards``, ``parallel/tensor.py``):
  params, Adam moments and every EMA tree alike, so Adam, the EMA and the
  forced weight norm (per output unit) stay shard-local. The layers gather
  activations over the model group (``parallel/tensor.py::gather``).
- ``ParallelPlan.sync`` is the step's gradient collective: one fp32
  all-reduce over the data group of a flat buffer that holds the rank's
  gradients (its shards and the replicated params) and the step's scalars,
  the means divided by the data size; under tensor parallelism one smaller
  all-reduce over the model group first sums the replicated params'
  gradients, which each rank holds as a partial sum. The buffer is made once
  and reused. It is not ``nn.parallel.DistributedDataParallel``: the step
  takes its gradients with ``torch.autograd.grad``, which DDP's reducer does
  not see.
- ZeRO-1 (``zero1=True``): each rank of a data group owns a contiguous range
  of the rank's flat layout, over its params in ``state.params`` order. It
  keeps only its range of the Adam moments and of each EMA tree, updates its
  range of the params, and one all-gather over the data group rebuilds them
  (they live in one flat buffer for that purpose). Under tensor parallelism
  the moments are thus sharded over both axes. The update is elementwise, so
  ZeRO-1 gives the data-parallel numbers bit for bit.

Every collective goes through ``all_reduce``, ``all_gather_into`` or
``barrier`` below, which report to ``parallel.audit``'s inventories with the
group they span ("world", "data" or "model"). A group of one rank inside a
larger world, or a process without a process group, makes no collective.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tinyedm_tpu_torch.parallel.audit import record
from tinyedm_tpu_torch.training.state import TrainState

# a rank that raised leaves the others in a collective: they fail after this
# instead of hanging (an epoch-end FID evaluation on rank 0 must fit in it)
DEFAULT_TIMEOUT = timedelta(minutes=30)
# every param starts at a multiple of 64 elements (256 bytes, cudaMalloc's
# alignment) in the flat buffers, so a kernel that reads a weight with
# vector loads finds it aligned as in a tensor of its own
ALIGN = 64


def init_distributed(backend: Optional[str] = None, init_method: Optional[str] = None,
                     timeout: timedelta = DEFAULT_TIMEOUT) -> tuple[int, int]:
    """Join the process group that ``torchrun`` describes in the environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``; ``MASTER_ADDR`` and
    ``MASTER_PORT`` for the default ``env://``); returns (rank, world size).
    ``backend=None`` is NCCL where CUDA is, else gloo. Where CUDA is, the
    process's card is ``cuda:LOCAL_RANK``."""
    rank = int(os.environ.get("RANK", 0))
    size = int(os.environ.get("WORLD_SIZE", 1))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if torch.cuda.is_available():
        card = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(card)
        if backend == "nccl":  # the communicator's card, known from the start
            kw["device_id"] = card
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank, world_size=size,
                            timeout=timeout, **kw)
    return rank, size


def distributed() -> bool:
    """Whether this process belongs to an initialized process group."""
    return dist.is_available() and dist.is_initialized()


def world() -> tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    if distributed():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place on the ``data x model`` grid of ranks, ``rank =
    data_rank * model_size + model_rank``, with its two process groups (None
    where the group is the whole world or one rank)."""

    rank: int
    data_size: int
    model_size: int
    data_group: Any = None
    model_group: Any = None

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_size

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_size

    def group(self, name: str) -> tuple[Any, int]:
        """(process group, size) of ``"world"``, ``"data"`` or ``"model"``."""
        if name == "world":
            return None, self.data_size * self.model_size
        if name == "data":
            return self.data_group, self.data_size
        if name == "model":
            return self.model_group, self.model_size
        raise ValueError(f"no group {name!r}")


# the grid of this process, as torch.distributed keeps its default group:
# set by make_grid, read by the collectives and the rank slices
_grid: Optional[Grid] = None


def make_grid(model_parallel: int = 1) -> Grid:
    """The ``data x model`` grid over the world, ``model_parallel`` ranks to
    a model group (``tinyedm_tpu/parallel/mesh.py::make_mesh``): creates the
    process groups (every rank must call it, with the same argument) and
    makes the grid this process's. A world that ``model_parallel`` does not
    divide raises ``ValueError``."""
    global _grid
    rank, size = world()
    n = int(model_parallel)
    if n < 1 or size % n != 0:
        raise ValueError(f"{size} ranks not divisible by model_parallel={model_parallel}")
    d = size // n
    data_group = model_group = None
    if distributed() and 1 < n < size:
        # every rank creates every group, in one order, or the run hangs
        for i in range(d):
            g = dist.new_group([i * n + m for m in range(n)])
            if rank // n == i:
                model_group = g
        for m in range(n):
            g = dist.new_group([i * n + m for i in range(d)])
            if rank % n == m:
                data_group = g
    _grid = Grid(rank, d, n, data_group, model_group)
    return _grid


def grid() -> Grid:
    """This process's grid: the last ``make_grid``'s over the current world,
    else data parallelism over the world."""
    rank, size = world()
    if _grid is not None and (_grid.rank, _grid.data_size * _grid.model_size) == (rank, size):
        return _grid
    return Grid(rank, size, 1)


def data_world() -> tuple[int, int]:
    """(data rank, data size): whose rows of a global batch this rank takes."""
    g = grid()
    return g.data_rank, g.data_size


def process_local_slice(x: np.ndarray, process_index: int, process_count: int) -> np.ndarray:
    """This process's contiguous share of a global-batch array: the shares of
    all processes tile the batch in order. The batch must divide evenly."""
    x = np.asarray(x)
    if x.shape[0] % process_count != 0:
        raise ValueError(f"global batch {x.shape[0]} not divisible by {process_count} processes")
    per = x.shape[0] // process_count
    return x[process_index * per : (process_index + 1) * per]


def local_rows(batch_size: int, n_valid: int, indices, pi: int, pc: int):
    """(local offsets, global indices) of the rows that process ``pi`` of
    ``pc`` writes out of a padded global batch of ``batch_size`` rows, the
    first ``n_valid`` real: its contiguous share (``process_local_slice``)
    without the pad rows. The offsets index the process's own rows."""
    per = batch_size // pc
    pos = process_local_slice(np.arange(batch_size), pi, pc)
    kept = pos[pos < n_valid]
    return kept - pi * per, [indices[int(k)] for k in kept]


def shard_batch(batch: Sequence[Any], process_local: bool = False) -> tuple:
    """This rank's rows of a host batch (a tuple of arrays with a leading
    global batch dimension, None entries kept): its data rank's share, the
    identity with one data rank or where the batch already is this rank's
    (``process_local``)."""
    rank, size = data_world()
    if size == 1 or process_local:
        return tuple(batch)
    return tuple(None if x is None else process_local_slice(x, rank, size) for x in batch)


# ----------------------------------------------------------------- collectives
def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _skip(n: int) -> bool:
    """No collective: no process group, or a group of one rank inside a
    larger world (a one-rank world still makes its collectives)."""
    return not distributed() or (n == 1 and dist.get_world_size() > 1)


def all_reduce(t: torch.Tensor, group: str = "world") -> None:
    """Sum ``t`` over the ranks of ``group`` ("world", "data" or "model"), in
    place."""
    pg, n = grid().group(group)
    if _skip(n):
        return
    record("all_reduce", _nbytes(t), n, _dtype(t), group)
    dist.all_reduce(t, group=pg)


def all_gather_into(out: torch.Tensor, shard: torch.Tensor, group: str = "world") -> None:
    """``out`` = the ranks' ``shard``s concatenated in rank order along dim 0
    (over ``group``); ``shard`` may be this rank's slice of ``out`` (in
    place)."""
    pg, n = grid().group(group)
    if _skip(n):
        if out.data_ptr() != shard.data_ptr() or out.numel() != shard.numel():
            out.copy_(shard)
        return
    record("all_gather", _nbytes(out), n, _dtype(out), group)
    # the entry point of torch 2.11 (the card's) and 2.13 (which deprecates
    # it for all_gather_single, absent from 2.11)
    dist.all_gather_into_tensor(out, shard, group=pg)


def barrier() -> None:
    if not distributed():
        return
    record("barrier", 0, dist.get_world_size(), "", "world")
    dist.barrier()


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class ParallelPlan:
    """The flat layout of a param dict (``state.params`` order, each param at
    an ``ALIGN``-element offset: under tensor parallelism the rank's shards
    and the replicated params) over the data group, rank ``rank`` of
    ``size`` (``data_world()`` by default), and the collectives of a train
    step on it. ``sharded``: the names of the params stored as model-group
    shards (``parallel/tensor.py::tp_shards``); the others are replicated
    over the model group.

    ``zero1``: rank ``r`` owns the elements ``[r * chunk, (r + 1) * chunk)``
    of the layout; ``pieces`` are (param index, start, stop within the
    param, offset within the rank's range) of the params it overlaps. A
    ZeRO-1 tree (Adam moments, EMA) is a dict of 1-D pieces, by param name,
    views of one ``chunk``-element tensor."""

    def __init__(self, params: dict[str, torch.Tensor], zero1: bool = False,
                 rank: Optional[int] = None, size: Optional[int] = None, sharded: Sequence[str] = ()):
        if rank is None or size is None:
            rank, size = data_world()
        odd = {k: p.dtype for k, p in params.items() if p.dtype != torch.float32}
        if odd:
            raise ValueError(f"the flat gradient buffer is fp32; these params are not: {odd}")
        self.zero1 = bool(zero1)
        self.rank, self.size = rank, size
        self.names = list(params)
        self.sharded = [i for i, k in enumerate(self.names) if k in set(sharded)]
        self.replicated = [i for i, k in enumerate(self.names) if k not in set(sharded)]
        self.shapes = [p.shape for p in params.values()]
        self.numels = [p.numel() for p in params.values()]
        self.device = next(iter(params.values())).device
        self.offsets = []
        end = 0
        for n in self.numels:
            self.offsets.append(end)
            end += _round_up(n, ALIGN)
        self.numel = end
        self.chunk = _round_up(-(-end // size), ALIGN)
        self.padded = self.chunk * size  # the flat length: ``size`` equal ranges
        lo, hi = rank * self.chunk, (rank + 1) * self.chunk
        self.pieces = []
        for i, (o, n) in enumerate(zip(self.offsets, self.numels)):
            a, b = max(o, lo), min(o + n, hi)
            if a < b:
                self.pieces.append((i, a - o, b - o, a - lo))
        self._buffer: Optional[torch.Tensor] = None  # gradients + scalars, made at the first sync
        self._params_flat: Optional[torch.Tensor] = None  # ZeRO-1: the params' storage

    @property
    def param_bytes(self) -> int:
        """The bytes of this rank's params (its shards and the replicated)."""
        return 4 * sum(self.numels)

    @property
    def model_size(self) -> int:
        return grid().model_size

    def _views(self, flat: torch.Tensor) -> list[torch.Tensor]:
        return [flat[o : o + n].view(s) for o, n, s in zip(self.offsets, self.numels, self.shapes)]

    # ------------------------------------------------------ data and model
    def sync(self, grads: list[torch.Tensor], means: list[torch.Tensor], sums: list[torch.Tensor],
             votes: Sequence[torch.Tensor] = ()) -> tuple[list[torch.Tensor], torch.Tensor, torch.Tensor]:
        """The step's gradient collectives: under tensor parallelism the
        replicated params' gradients (partial sums on each rank of a model
        group) and ``votes`` summed over the model group, in place; then one
        all-reduce over the data group: the gradients (``state.params``
        order) and ``means`` averaged, ``sums`` and ``votes`` summed (so
        ``votes`` count over the world). Returns the gradients as views of
        the flat buffer (valid until the next sync), the means, and the sums
        followed by the votes, as two new 1-D tensors."""
        votes = [v.float().reshape(1) for v in votes]
        rep = [grads[i] for i in self.replicated]
        if self.model_size > 1 and (rep or votes):
            buf = torch.cat([g.reshape(-1) for g in rep] + votes)
            all_reduce(buf, "model")
            *parts, tail = buf.split([g.numel() for g in rep] + [len(votes)])
            torch._foreach_copy_(rep, [v.view_as(g) for v, g in zip(parts, rep)])
            votes = list(tail.split(1))
        sums = [*sums, *votes]
        k = len(means) + len(sums)
        device = grads[0].device
        if self._buffer is None or self._buffer.numel() != self.padded + k or self._buffer.device != device:
            # zeros: the gaps between params and the tail stay zero
            self._buffer = torch.zeros(self.padded + k, dtype=torch.float32, device=device)
        flat = self._buffer
        views = self._views(flat)
        torch._foreach_copy_(views, grads)
        flat[self.padded :].copy_(torch.stack([s.float().reshape(()) for s in (*means, *sums)]))
        all_reduce(flat, "data")
        if self.size > 1:
            flat[: self.padded + len(means)].div_(self.size)
        scalars = flat[self.padded :].clone()
        return views, scalars[: len(means)], scalars[len(means) :]

    def sq_norms(self, tensors: Sequence[torch.Tensor], groups: Sequence[Sequence[int]]) -> torch.Tensor:
        """The squared L2 norm of each group of ``tensors`` (indices into
        ``state.params`` order, whole local tensors) over the model group:
        the shards' squares summed over it, a replicated param counted once;
        one all-reduce for all groups."""
        sharded = set(self.sharded)

        def part(group, want: bool) -> torch.Tensor:
            return sum((torch.sum(torch.square(tensors[i].float())) for i in group if (i in sharded) == want),
                       torch.zeros((), device=tensors[0].device))

        shard_sq = torch.stack([part(g, True) for g in groups])
        all_reduce(shard_sq, "model")
        return shard_sq + torch.stack([part(g, False) for g in groups])

    # --------------------------------------------------------------- ZeRO-1
    def adopt_params(self, params: dict[str, torch.Tensor]) -> None:
        """Move the params (the model's own ``nn.Parameter``s) into one flat
        buffer, each a view at its offset, so that ``gather_params`` writes
        them in place; their values do not change."""
        flat = torch.zeros(self.padded, dtype=torch.float32, device=self.device)
        with torch.no_grad():
            for p, o, n in zip(params.values(), self.offsets, self.numels):
                flat[o : o + n].copy_(p.detach().reshape(-1))
                p.data = flat[o : o + n].view_as(p)
        self._params_flat = flat

    def place(self, state: TrainState) -> None:
        """A whole state into ZeRO-1's form, in place: the params into the
        flat buffer (``adopt_params``), the Adam moments and EMA trees cut
        to this rank's pieces (``shard``)."""
        self.adopt_params(state.params)
        state.mu, state.nu = self.shard(state.mu), self.shard(state.nu)
        state.ema = tuple(self.shard(tree) for tree in state.ema)

    def gather_params(self, params: dict[str, torch.Tensor]) -> None:
        """Every rank's updated range into every rank's params: one
        all-gather over the data group, in place."""
        flat = self._params_flat
        if flat is None or any(p.data_ptr() != flat[o:].data_ptr() for p, o in zip(params.values(), self.offsets)):
            raise RuntimeError("the params are not in this plan's flat buffer: call adopt_params after loading them")
        lo = self.rank * self.chunk
        all_gather_into(flat, flat[lo : lo + self.chunk], "data")

    def pieces_of(self, tree: dict[str, torch.Tensor] | list[torch.Tensor]) -> list[torch.Tensor]:
        """Views of this rank's pieces of a full tree (a dict by param name,
        or a list in ``state.params`` order), in ``pieces`` order."""
        if isinstance(tree, dict):
            tree = [tree[k] for k in self.names]
        return [tree[i].reshape(-1)[a:b] for i, a, b, _ in self.pieces]

    def shard(self, tree: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """This rank's pieces of a full tree, copied into one new
        ``chunk``-element tensor on the plan's device; by param name."""
        shard = torch.zeros(self.chunk, dtype=torch.float32, device=self.device)
        out = {}
        for (i, a, b, s), v in zip(self.pieces, self.pieces_of(tree)):
            shard[s : s + b - a].copy_(v)
            out[self.names[i]] = shard[s : s + b - a]
        return out

    def gather(self, pieces: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The rank's full tree (its shards and the replicated params) of
        every data rank's pieces (``shard``'s form): one all-gather over the
        data group into a new flat tensor, viewed by name and shape."""
        shard = torch.zeros(self.chunk, dtype=torch.float32, device=self.device)
        for i, a, b, s in self.pieces:
            shard[s : s + b - a].copy_(pieces[self.names[i]])
        out = torch.empty(self.padded, dtype=torch.float32, device=self.device)
        all_gather_into(out, shard, "data")
        return dict(zip(self.names, self._views(out)))
