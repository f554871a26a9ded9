"""Operations and bytes of the DiT configurations from their shapes, by
``work.py``'s rules (a multiply-add two operations, a bf16 value two bytes,
each input read once and each output written once, ``work.PEAKS``), at the
published head dim (72 for DiT-XL/2), whatever bucket a kernel pads it to.

Per image a forward is the patch embed, ``depth`` blocks (qkv, attention,
projection, two MLP linears, the adaLN modulation), the final adaLN and
linear layers, and the timestep embedder; the label table is a gather.
"""

from __future__ import annotations

import dataclasses

from edmbench.work import BF16, Attention, attention_bwd_bound_s, attention_fwd_bound_s, bound_s


@dataclasses.dataclass(frozen=True)
class Gemm:
    name: str
    rows_per_image: int  # tokens (n) or 1 (a per-image linear)
    k: int  # input features
    n: int  # output features
    dgrad: bool  # whether the backward takes its input's gradient
    count: int = 1  # how many such layers

    def flops(self, batch: int) -> int:
        return 2 * batch * self.rows_per_image * self.k * self.n * self.count


def tokens(cfg: dict) -> int:
    d = cfg["denoiser"]
    return (d["input_size"] // d["patch_size"]) ** 2


def gemms(cfg: dict) -> list[Gemm]:
    """The linear layers of one forward. The patch embed's input (the noisy
    latents) and the timestep embedder's first input (its frequencies) need
    no gradient."""
    d, e = cfg["denoiser"], cfg["embedding"]
    c, n, p, depth = d["hidden_size"], tokens(cfg), d["patch_size"], d["depth"]
    hidden = int(c * d["mlp_ratio"])
    return [
        Gemm("t_embedder.mlp.0", 1, e["frequency_dim"], c, False),
        Gemm("t_embedder.mlp.2", 1, c, c, True),
        Gemm("x_embedder.proj", n, d["in_channels"] * p * p, c, False),
        Gemm("attn.qkv", n, c, 3 * c, True, depth),
        Gemm("attn.proj", n, c, c, True, depth),
        Gemm("mlp.fc1", n, c, hidden, True, depth),
        Gemm("mlp.fc2", n, hidden, c, True, depth),
        Gemm("adaLN_modulation", 1, c, 6 * c, True, depth),
        Gemm("final_layer.adaLN_modulation", 1, c, 2 * c, True),
        Gemm("final_layer.linear", n, c, p * p * d["out_channels"], True),
    ]


def attentions(cfg: dict) -> list[Attention]:
    d = cfg["denoiser"]
    return [Attention(tokens(cfg), d["hidden_size"], d["num_heads"])] * d["depth"]


def forward_flops(cfg: dict) -> int:
    """Operations of one forward per image: the linears and the attention
    products (``4 n^2 C``: q k^T and p v over all heads)."""
    return sum(g.flops(1) for g in gemms(cfg)) + sum(4 * a.n * a.n * a.channels for a in attentions(cfg))


def gemm_bound_s(cfg: dict, batch: int, train: bool) -> float:
    """Summed least times of one batch's GEMM calls: each linear's forward
    and, in training, its input gradient (where it takes one) and its weight
    gradient, in bf16."""
    total = 0.0
    for g in gemms(cfg):
        m = batch * g.rows_per_image
        nbytes = (m * g.k + g.k * g.n + m * g.n) * BF16
        f = g.flops(batch) // g.count
        calls = 1 + (int(g.dgrad) + 1 if train else 0)
        total += g.count * calls * bound_s(f, nbytes)
    return total


def flash_bound_s(cfg: dict, batch: int, train: bool) -> float:
    """Summed least times of one batch's flash kernel calls (``work.py``'s
    forward and backward formulas)."""
    total = sum(attention_fwd_bound_s(a, batch) for a in attentions(cfg))
    if train:
        total += sum(attention_bwd_bound_s(a, batch) for a in attentions(cfg))
    return total
