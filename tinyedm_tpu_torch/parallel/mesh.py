"""Data parallelism and ZeRO-1 on ``torch.distributed``.

Counterpart of the data axis of ``tinyedm_tpu/parallel/mesh.py``. The JAX
package places a global batch on a (data, model) mesh and lets XLA insert the
gradient all-reduce; the port runs one process per card (``torchrun`` or
``python -m torch.distributed.run``, ``init_distributed``) and makes the
collectives itself:

- Every rank iterates the same global batches (the data modules shuffle from
  a shared seed) and trains on its contiguous share (``process_local_slice``,
  ``shard_batch``); a data module that yields only its own rows says so with
  ``yields_process_local`` and is not sliced again.
- ``ParallelPlan.sync`` is the step's one collective under data parallelism:
  one fp32 all-reduce of a flat buffer that holds every gradient and the
  step's scalars (loss, uncertainty, sse, count, the interrupt flag), the
  means divided by the world size. The buffer is made once and reused. It is
  not ``nn.parallel.DistributedDataParallel``: the step takes its gradients
  with ``torch.autograd.grad``, which DDP's reducer does not see.
- ZeRO-1 (``zero1=True``): each rank owns a contiguous range of that flat
  layout, over the params in ``state.params`` order. It keeps only its
  range of the Adam moments and of each EMA tree, updates its range of the
  params, and one all-gather of the ranges rebuilds the params (which live
  in one flat buffer for that purpose). The forced weight norm then runs on
  the full params, as without ZeRO-1. The update is elementwise, so ZeRO-1
  gives the data-parallel numbers bit for bit.

Every collective goes through ``all_reduce``, ``all_gather_into`` or
``barrier`` below, which report to ``parallel.audit``'s inventories. Without
a process group the wrappers make no collective: one process is its own
world.
"""

from __future__ import annotations

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
    global batch dimension, None entries kept): the identity in one process
    or where the batch already is this rank's (``process_local``)."""
    rank, size = world()
    if size == 1 or process_local:
        return tuple(batch)
    return tuple(None if x is None else process_local_slice(x, rank, size) for x in batch)


# ----------------------------------------------------------------- collectives
def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce(t: torch.Tensor) -> None:
    """Sum ``t`` over the ranks, in place."""
    if not distributed():
        return
    record("all_reduce", _nbytes(t), dist.get_world_size(), str(t.dtype).removeprefix("torch."))
    dist.all_reduce(t)


def all_gather_into(out: torch.Tensor, shard: torch.Tensor) -> None:
    """``out`` = the ranks' ``shard``s concatenated in rank order; ``shard``
    may be this rank's slice of ``out`` (in place)."""
    if not distributed():
        if out.data_ptr() != shard.data_ptr() or out.numel() != shard.numel():
            out.copy_(shard)
        return
    record("all_gather", _nbytes(out), dist.get_world_size(), str(out.dtype).removeprefix("torch."))
    # the entry point of torch 2.11 (the card's) and 2.13 (which deprecates
    # it for all_gather_single, absent from 2.11)
    dist.all_gather_into_tensor(out, shard)


def barrier() -> None:
    if not distributed():
        return
    record("barrier", 0, dist.get_world_size())
    dist.barrier()


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class ParallelPlan:
    """The flat layout of a param dict (``state.params`` order, each param at
    an ``ALIGN``-element offset) over the world of ``rank`` of ``size``
    (``world()`` by default), and the collectives of a train step on it.

    ``zero1``: rank ``r`` owns the elements ``[r * chunk, (r + 1) * chunk)``
    of the layout; ``pieces`` are (param index, start, stop within the
    param, offset within the rank's range) of the params it overlaps. A
    ZeRO-1 tree (Adam moments, EMA) is a dict of 1-D pieces, by param name,
    views of one ``chunk``-element tensor."""

    def __init__(self, params: dict[str, torch.Tensor], zero1: bool = False,
                 rank: Optional[int] = None, size: Optional[int] = None):
        if rank is None or size is None:
            rank, size = world()
        odd = {k: p.dtype for k, p in params.items() if p.dtype != torch.float32}
        if odd:
            raise ValueError(f"the flat gradient buffer is fp32; these params are not: {odd}")
        self.zero1 = bool(zero1)
        self.rank, self.size = rank, size
        self.names = list(params)
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
        return 4 * sum(self.numels)

    def _views(self, flat: torch.Tensor) -> list[torch.Tensor]:
        return [flat[o : o + n].view(s) for o, n, s in zip(self.offsets, self.numels, self.shapes)]

    # -------------------------------------------------------- data parallel
    def sync(self, grads: list[torch.Tensor], means: list[torch.Tensor],
             sums: list[torch.Tensor]) -> tuple[list[torch.Tensor], torch.Tensor, torch.Tensor]:
        """The step's one all-reduce: the gradients (``state.params`` order)
        and ``means`` averaged over the ranks, ``sums`` summed. Returns the
        gradients as views of the flat buffer (valid until the next sync)
        and the scalars as two new 1-D tensors."""
        k = len(means) + len(sums)
        device = grads[0].device
        if self._buffer is None or self._buffer.numel() != self.padded + k or self._buffer.device != device:
            # zeros: the gaps between params and the tail stay zero
            self._buffer = torch.zeros(self.padded + k, dtype=torch.float32, device=device)
        flat = self._buffer
        views = self._views(flat)
        torch._foreach_copy_(views, grads)
        flat[self.padded :].copy_(torch.stack([s.float().reshape(()) for s in (*means, *sums)]))
        all_reduce(flat)
        if self.size > 1:
            flat[: self.padded + len(means)].div_(self.size)
        scalars = flat[self.padded :].clone()
        return views, scalars[: len(means)], scalars[len(means) :]

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
        all-gather, in place."""
        flat = self._params_flat
        if flat is None or any(p.data_ptr() != flat[o:].data_ptr() for p, o in zip(params.values(), self.offsets)):
            raise RuntimeError("the params are not in this plan's flat buffer: call adopt_params after loading them")
        lo = self.rank * self.chunk
        all_gather_into(flat, flat[lo : lo + self.chunk])

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
        """The full tree of every rank's pieces (``shard``'s form): one
        all-gather into a new flat tensor, viewed by name and shape."""
        shard = torch.zeros(self.chunk, dtype=torch.float32, device=self.device)
        for i, a, b, s in self.pieces:
            shard[s : s + b - a].copy_(pieces[self.names[i]])
        out = torch.empty(self.padded, dtype=torch.float32, device=self.device)
        all_gather_into(out, shard)
        return dict(zip(self.names, self._views(out)))
