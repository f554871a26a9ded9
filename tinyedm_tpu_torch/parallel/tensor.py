"""Tensor parallelism: weight-normed kernels sharded over output channels.

Counterpart of ``tinyedm_tpu/parallel/mesh.py::tp_param_spec`` and the
collectives GSPMD derives from it. Every weight-normed kernel (a ``weight``
of a ``WNConv`` or ``WNLinear``: OIHW or (out, in), output axis 0) whose
output count divides the model group's size is stored as its rank's shard of
output channels (``tp_shards``, ``shard_model``); everything else (conv_out's
image channels where they do not divide, the uncertainty head's output,
gains, the Fourier constants) is replicated. The per-output weight
normalization stays shard-local.

Each sharded layer computes its own output channels from its whole input.
Activations stay sharded where the next op is elementwise (a block's
residual branch between its two convs, with the embedding modulation
sharded alike; the residual ``mp_add`` on the block input's slice) and are
gathered over the model group (``gather``) where a layer needs them whole.

The gradients: a rank's gradient of a whole (replicated) activation is a
partial sum, whose sum over the model group is the true gradient, and of a
sharded one the true gradient of its channels. ``gather`` keeps that
invariant: its forward all-gathers the channel shards, its backward
all-reduces the incoming partial gradient over the model group and keeps the
rank's own slice (a reduce-scatter; gloo has none, so all-reduce and slice
is the one code path for gloo and NCCL alike). The train step seeds the
backward with ``1 / model_size`` (each rank computes the whole loss), so a
replicated param's gradient is a partial sum too, and ``ParallelPlan.sync``
sums those over the model group; a shard's gradient is already its own.

Attention partitions ``qkv_conv``'s rows by head: with heads ``h`` of size
``hd`` over ``N`` ranks, rank ``m`` holds rows ``t*C + h*hd + j`` for ``t``
in (q, k, v), its heads ``h`` and every ``j`` (``head_rows``), so its qkv
comes out in the attention kernels' ``(3, heads/N, hd)`` layout. Still an
output-channel shard: only its order of rows differs from the JAX package's
contiguous split, and checkpoints hold whole tensors.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tinyedm_tpu_torch.parallel.audit import open_inventories, recording_into
from tinyedm_tpu_torch.parallel.mesh import Grid, all_gather_into, all_reduce
from tinyedm_tpu_torch.training.state import weight_normed_names


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, grid: Grid) -> torch.Tensor:
        # the backward of a CUDA tensor runs on autograd's device thread: it
        # records into the forward's collective inventories
        ctx.dim, ctx.grid, ctx.inventories = dim, grid, open_inventories()
        out = torch.empty((grid.model_size, *x.shape), dtype=x.dtype, device=x.device)
        all_gather_into(out.view(-1, *x.shape[1:]), x.contiguous(), "model")
        return out.movedim(0, dim).flatten(dim, dim + 1)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        # a copy: autograd may hand the same gradient to another branch
        g = g.clone(memory_format=torch.contiguous_format)
        with recording_into(ctx.inventories):
            all_reduce(g, "model")
        return local(g, ctx.grid, ctx.dim), None, None


def gather(x: torch.Tensor, grid: Optional[Grid], dim: int = 1) -> torch.Tensor:
    """The whole activation of the model group's channel shards ``x`` along
    ``dim``, in model-rank order; its backward all-reduces the gradient over
    the model group and keeps this rank's slice. The identity without a
    grid."""
    if grid is None:
        return x
    return _Gather.apply(x, dim % x.ndim, grid)


def local(x: torch.Tensor, grid: Optional[Grid], dim: int = 1) -> torch.Tensor:
    """This model rank's contiguous slice of ``x`` along ``dim`` (a view);
    the identity without a grid."""
    if grid is None:
        return x
    c = x.shape[dim] // grid.model_size
    return x.narrow(dim, grid.model_rank * c, c)


def head_rows(channels: int, heads: int, model_size: int, model_rank: int) -> torch.Tensor:
    """The rows of a ``(3C, ...)`` qkv weight that rank ``model_rank`` of
    ``model_size`` holds: ``t*C + h*hd + j`` for ``t`` in (q, k, v), its
    ``heads / model_size`` heads ``h`` and every ``j``, in that order."""
    hd = channels // heads
    per = heads // model_size
    rows = torch.arange(3 * channels).reshape(3, heads, hd)
    return rows[:, model_rank * per : (model_rank + 1) * per].reshape(-1)


def tp_shards(model: nn.Module, model_size: int) -> dict[str, list[torch.Tensor]]:
    """The sharded params of ``model`` (whole) over ``model_size`` ranks: by
    name, the row indices of each model rank's shard (contiguous ranges; by
    head for an attention ``qkv_conv`` whose heads divide ``model_size``).
    ``tp_param_spec``'s rule: a WN layer's weight whose output count (axis
    0) divides ``model_size`` shards; everything else replicates."""
    from tinyedm_tpu_torch.models.layers import CosineAttention

    heads = {f"{name}.qkv_conv.weight".lstrip("."): m.num_heads for name, m in model.named_modules()
             if isinstance(m, CosineAttention)}
    out = {}
    wn = set(weight_normed_names(model))
    for name, p in model.named_parameters():
        if model_size == 1 or name not in wn or p.shape[0] % model_size:
            continue
        rows = p.shape[0]
        if name in heads and heads[name] % model_size == 0:
            out[name] = [head_rows(rows // 3, heads[name], model_size, m) for m in range(model_size)]
        else:
            per = rows // model_size
            out[name] = [torch.arange(m * per, (m + 1) * per) for m in range(model_size)]
    return out


def shard_model(model: nn.Module, grid: Grid) -> dict[str, list[torch.Tensor]]:
    """Cut ``model`` (whole, as every rank builds it) to this rank's shards
    in place, and give each sharded layer the grid (``layer.tp``) that its
    forward gathers over. Returns ``tp_shards``; the identity at model size
    1."""
    shards = tp_shards(model, grid.model_size)
    modules = dict(model.named_modules())
    with torch.no_grad():
        for name, rows in shards.items():
            owner, _ = name.rsplit(".", 1)
            layer = modules[owner]
            layer.weight = nn.Parameter(layer.weight[rows[grid.model_rank].to(layer.weight.device)].clone())
            layer.tp = grid
    return shards


def shard_tree(tree: dict[str, torch.Tensor], shards: dict[str, list[torch.Tensor]],
               model_rank: int) -> dict[str, torch.Tensor]:
    """A whole tree (params, a moment, an EMA tree) cut to rank
    ``model_rank``'s shards, replicated entries as they are."""
    return {k: v[shards[k][model_rank].to(v.device)].clone() if k in shards else v for k, v in tree.items()}


@torch.no_grad()
def gather_tree(tree: dict[str, torch.Tensor], shards: dict[str, list[torch.Tensor]], grid: Grid,
                device: Optional[torch.device | str] = None) -> dict[str, torch.Tensor]:
    """The whole tree of the model group's shards: one all-gather per
    sharded tensor, copied to ``device`` (the tensor's own by default) one at
    a time, so no collective carries the tree."""
    out = {}
    for k, v in tree.items():
        v = v.detach()
        if k in shards:
            gathered = torch.empty((grid.model_size * v.shape[0], *v.shape[1:]), dtype=v.dtype, device=v.device)
            all_gather_into(gathered, v.contiguous(), "model")
            rows = torch.cat(shards[k]).to(v.device)
            v = torch.empty_like(gathered).index_copy_(0, rows, gathered)
        out[k] = v.to(device or v.device)
    return out
