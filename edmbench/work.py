"""Operations and bytes from shapes: the yardstick of the per-layer metrics.

Counted once, from a configuration file, at the cell's shapes, the same
work whatever implements it: a multiply-add is two operations, a bf16
value two bytes, each input read once and each output written once.
``PEAKS`` is the H100 SXM's data sheet (dense bf16 on the tensor cores, HBM3
bandwidth).
"""

from __future__ import annotations

import dataclasses
from collections import Counter

from edmbench.reference.model import HEADS, conditional, topology

PEAKS = {"bf16_flops": 989e12, "bytes_per_s": 3.35e12}
BF16 = 2  # bytes


@dataclasses.dataclass(frozen=True)
class Conv:
    name: str
    cin: int
    cout: int
    k: int
    h: int
    w: int
    dgrad: bool  # whether the backward takes its input's gradient

    @property
    def flops(self) -> int:
        """Per image, direct convolution."""
        return 2 * self.cout * self.cin * self.k * self.k * self.h * self.w


@dataclasses.dataclass(frozen=True)
class Attention:
    n: int  # tokens
    channels: int
    heads: int

    @property
    def hd(self) -> int:
        return self.channels // self.heads


def layers(cfg: dict) -> tuple[list[Conv], list[Attention], Counter]:
    """The convolutions and attention layers of one forward, and the other
    products' operations per image by kind (``mm``: the attention
    projections and the embedding linears; ``bmm``: q k^T and p v)."""
    d, e = cfg["denoiser"], cfg["embedding"]
    heads = d.get("num_heads", HEADS)
    side = cfg["image_size"]
    c0 = d["encoder_out_channels"][0]
    convs = [Conv("conv_in", d["in_channels"] + 1, c0, 3, side, side, False)]
    attns, ops = [], Counter()
    ops["mm"] += 2 * e["fourier_dim"] * e["embedding_dim"]
    if conditional(cfg):
        ops["mm"] += 2 * e["num_classes"] * e["embedding_dim"]
    for b in topology(cfg):
        if b.resample:
            side = side * 2 if b.decoder else side // 2
        out = b.out_channels
        if b.skip_channels:
            s = b.skip_channels
            hidden = max(1, s // 16)
            convs += [Conv(b.prefix + "cat_factor.conv_0", s + 1, hidden, 1, 1, 1, True),
                      Conv(b.prefix + "cat_factor.conv_1", hidden, s, 1, 1, 1, True)]
        cin = b.cat_channels if b.decoder else b.in_channels
        if cin != out:
            convs.append(Conv(b.prefix + "conv_1x1", cin, out, 1, side, side, True))
        convs += [Conv(b.prefix + "conv_3x3_1", b.cat_channels if b.decoder else out, out, 3, side, side, True),
                  Conv(b.prefix + "conv_3x3_2", out, out, 3, side, side, True)]
        ops["mm"] += 2 * d["embedding_dim"] * out
        if b.attention:
            n = side * side
            attns.append(Attention(n, out, heads))
            ops["mm"] += 2 * n * out * 4 * out  # qkv (3C) and out (C) projections
            ops["bmm"] += 4 * n * n * out  # q k^T and p v over all heads
    convs.append(Conv("conv_out", convs[-1].cout, d["out_channels"], 1, cfg["image_size"],
                      cfg["image_size"], True))
    ops["conv"] = sum(c.flops for c in convs)
    return convs, attns, ops


def uncertainty_flops(cfg: dict) -> int:
    """The uncertainty head of a training forward, per image."""
    if not cfg.get("use_uncertainty"):
        return 0
    fd = cfg["embedding"]["fourier_dim"]
    return 2 * (fd + 1) * fd + 2 * fd


def forward_flops(cfg: dict, train: bool = False) -> int:
    """Operations of one forward per image."""
    return sum(layers(cfg)[2].values()) + (uncertainty_flops(cfg) if train else 0)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two limits."""
    return max(flops / PEAKS["bf16_flops"], nbytes / PEAKS["bytes_per_s"])


def conv_bound_s(cfg: dict, batch: int, train: bool) -> float:
    """Summed least times of one batch's convolution calls: each forward,
    and in training each input gradient (not conv_in's, whose input needs
    none) and each weight gradient, in bf16."""
    total = 0.0
    for c in layers(cfg)[0]:
        x = batch * c.cin * c.h * c.w * BF16
        y = batch * c.cout * c.h * c.w * BF16
        w = c.cout * c.cin * c.k * c.k * BF16
        f = batch * c.flops
        total += bound_s(f, x + w + y)
        if train:
            if c.dgrad:
                total += bound_s(f, y + w + x)
            total += bound_s(f, x + y + w)
    return total


def attention_fwd_bound_s(a: Attention, batch: int) -> float:
    """The forward kernel: qkv read, output written; 4 b h n^2 hd operations."""
    return bound_s(4 * batch * a.heads * a.n * a.n * a.hd, 4 * batch * a.n * a.channels * BF16)


def attention_bwd_bound_s(a: Attention, batch: int) -> float:
    """The backward kernels: qkv, output and its gradient read, the qkv
    gradient written; 10 b h n^2 hd operations."""
    return bound_s(10 * batch * a.heads * a.n * a.n * a.hd, 8 * batch * a.n * a.channels * BF16)


def attention_bound_s(cfg: dict, batch: int, train: bool) -> float:
    """Summed least times of one forward's (and in training its backward's)
    attention kernel calls at ``batch``."""
    attns = layers(cfg)[1]
    total = sum(attention_fwd_bound_s(a, batch) for a in attns)
    if train:
        total += sum(attention_bwd_bound_s(a, batch) for a in attns)
    return total
