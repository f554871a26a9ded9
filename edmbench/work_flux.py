"""Operations and bytes of the FLUX configurations from their shapes, by
``work.py``'s rules (a multiply-add two operations, a bf16 value two bytes,
each input read once and each output written once, ``work.PEAKS``), at the
published head dim (128 for FLUX.1-dev).

Per image a forward is the three embedders (``time_in``, ``guidance_in``,
``vector_in``), ``img_in`` on the packed latents and ``txt_in`` on the text
tokens, ``depth`` double blocks (each stream's modulation, qkv, projection
and two MLP linears at its own token count: the image's and the text's),
``depth_single_blocks`` single blocks (modulation, ``linear1``, ``linear2``
on all tokens), the last layer's modulation and linear, and an attention
over all tokens a block.
"""

from __future__ import annotations

from edmbench.work import BF16, Attention, attention_bwd_bound_s, attention_fwd_bound_s, bound_s
from edmbench.work_dit import Gemm


def tokens(cfg: dict) -> tuple[int, int]:
    """(image tokens, text tokens) of one sample: the latents packed 2 x 2."""
    return (cfg["image_size"] // 2) ** 2, cfg["txt_len"]


def gemms(cfg: dict) -> list[Gemm]:
    """The linear layers of one forward. The embedders' first layers and
    ``img_in`` and ``txt_in`` read inputs that need no gradient."""
    d, e = cfg["denoiser"], cfg["embedding"]
    c, f = d["hidden_size"], e["frequency_dim"]
    mlp = int(c * d["mlp_ratio"])
    n_img, n_txt = tokens(cfg)
    n, depth, single = n_img + n_txt, d["depth"], d["depth_single_blocks"]
    out = [Gemm("time_in.in_layer", 1, f, c, False), Gemm("time_in.out_layer", 1, c, c, True)]
    if e["guidance_embed"]:
        out += [Gemm("guidance_in.in_layer", 1, f, c, False), Gemm("guidance_in.out_layer", 1, c, c, True)]
    out += [Gemm("vector_in.in_layer", 1, e["vec_in_dim"], c, False), Gemm("vector_in.out_layer", 1, c, c, True),
            Gemm("img_in", n_img, d["in_channels"], c, False),
            Gemm("txt_in", n_txt, d["context_in_dim"], c, False)]
    for s, rows in (("img", n_img), ("txt", n_txt)):
        out += [Gemm(f"{s}_mod.lin", 1, c, 6 * c, True, depth),
                Gemm(f"{s}_attn.qkv", rows, c, 3 * c, True, depth),
                Gemm(f"{s}_attn.proj", rows, c, c, True, depth),
                Gemm(f"{s}_mlp.0", rows, c, mlp, True, depth),
                Gemm(f"{s}_mlp.2", rows, mlp, c, True, depth)]
    out += [Gemm("modulation.lin", 1, c, 3 * c, True, single),
            Gemm("linear1", n, c, 3 * c + mlp, True, single),
            Gemm("linear2", n, c + mlp, c, True, single),
            Gemm("final_layer.adaLN_modulation", 1, c, 2 * c, True),
            Gemm("final_layer.linear", n_img, c, d["out_channels"], True)]
    return out


def attentions(cfg: dict) -> list[Attention]:
    d = cfg["denoiser"]
    n = sum(tokens(cfg))
    return [Attention(n, d["hidden_size"], d["num_heads"])] * (d["depth"] + d["depth_single_blocks"])


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
