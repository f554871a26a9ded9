"""DiT, the transformer denoiser of Peebles & Xie 2022 (arXiv:2212.09748),
under EDM preconditioning.

The equations of ``facebookresearch/DiT``'s ``models.py`` (``DiT_XL_2``: depth
28, hidden 1152, 16 heads of 72, patch 2, MLP ratio 4), with its parameter
names, split across the two halves an ``EDM`` holds:

- ``DiTEmbedding`` (``EDM.embedding``): the timestep embedder, 256
  sinusoidal frequencies (cos then sin, periods up to 10000) of its input,
  then ``Linear-SiLU-Linear``; plus the class table of ``num_classes + 1``
  rows, whose last row is the null class. The port's null label -1 (label
  dropout, guidance) takes that row. Returns ``(frequencies, c)``, ``c`` the
  sum of the two embeddings.
- ``DiTDenoiser`` (``EDM.denoiser``): ``DenoiserWrapper`` around ``DiT``,
  the patch embed (``Conv2d(in, hidden, p, stride p)``, computed as a linear
  layer on the flattened patches), a fixed 2-D sin-cos position table,
  ``depth`` adaLN-Zero blocks and the final adaLN layer, then unpatchify.
  A block: ``SiLU -> Linear(hidden, 6 hidden)`` gives per-sample shift, scale
  and gate for the attention and the MLP; ``x + gate * branch(LN(x) (1 +
  scale) + shift)``, LayerNorm without affine at eps 1e-6; the attention a
  qkv projection with bias, softmax attention over all tokens at scale
  ``1/sqrt(hd)`` (``ops/attention.py::flash_attention`` on the q, k, v views
  of the ``(b, n, 3C)`` qkv tensor: the flash CUDA kernels at n >= 1024, the
  plain path below), and a projection; the MLP ``fc1 -> GELU(tanh) -> fc2``.

Departures from the published DiT:

- EDM's preconditioning and loss weight (``DenoiserWrapper``,
  ``diffusion/loss.py``) replace DDPM's epsilon target and learned sigma, so
  ``out_channels`` is the input's (4, not 8);
- the timestep embedder is fed EDM's ``c_noise = ln(sigma) / 4``, as EDM's
  ``EDMPrecond`` feeds ADM's positional embedding, and not DDPM's step index;
- class dropout is the train step's ``label_dropout`` (-1, the null row);
- the training recipe's EMA is one power-function profile
  (``training/ema.py``), its Adam at weight decay 0 stands for DiT's AdamW at
  weight decay 0, and there is no uncertainty head.

Precision: the stored parameters are fp32; every linear layer of ``DiT``
(the patch embed included) runs in ``dtype`` (bf16 in the recipe) with fp32
sums, and so does the attention; the embedder's two small linears run in
fp32, an island as EDM2 keeps its embedding. The residual stream, the
LayerNorm statistics, the modulation ``LN(x) (1 + scale) + shift`` and the
gated residual sums are fp32: a branch's ``dtype`` output is added as
``x + gate * y`` in fp32 (``torch.addcmul``), and ``LN(x) (1 + scale) +
shift`` is rounded to ``dtype`` once, where the next linear layer takes it.
To hold one microbatch of 32 at 1024 tokens on one card, neither saves an
fp32 copy for the backward: the normalization recomputes ``LN(x)`` there
from ``x`` and its statistics (``_NormModulate``), and the gate keeps the
``dtype`` branch.

``reset_parameters`` follows DiT's ``initialize_weights``: xavier-uniform
linears with zero biases, the class table and the timestep MLP N(0, 0.02),
the sin-cos table, and the adaLN-Zero zeros (every modulation and the final
linear layer), so that each block starts as the identity.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tinyedm_tpu_torch.models.unet import DenoiserWrapper
from tinyedm_tpu_torch.ops.attention import flash_attention
from tinyedm_tpu_torch.utils.profiling import span

LN_EPS = 1e-6
MAX_PERIOD = 10000


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """DiT's ``TimestepEmbedder.timestep_embedding``: (B,) -> (B, dim) fp32,
    ``[cos(t f), sin(t f)]`` at ``f_i = MAX_PERIOD^(-i / (dim/2))``."""
    half = dim // 2
    freqs = torch.exp(-math.log(MAX_PERIOD) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    return F.pad(emb, (0, 1)) if dim % 2 else emb


def sincos_pos_embed(dim: int, grid: int) -> np.ndarray:
    """DiT's ``get_2d_sincos_pos_embed`` (fp64 numpy): (grid^2, dim), the
    first half of the channels ``[sin, cos]`` of a token's column index, the
    second half of its row index (as DiT's code computes them, whose names
    say the reverse)."""

    def one_d(d: int, pos: np.ndarray) -> np.ndarray:
        omega = 1.0 / MAX_PERIOD ** (np.arange(d // 2, dtype=np.float64) / (d / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    cols, rows = np.meshgrid(np.arange(grid, dtype=np.float32), np.arange(grid, dtype=np.float32))
    return np.concatenate([one_d(dim // 2, cols), one_d(dim // 2, rows)], axis=1)


class Linear(nn.Module):
    """``y = x W^T + b`` in ``dtype`` (fp32 sums) from fp32 parameters, the
    weight flattened to (out, in); the output stays in ``dtype``. ``init``
    names its start under DiT's ``initialize_weights``: ``"xavier"``
    (xavier-uniform, zero bias), ``"normal"`` (N(0, 0.02), zero bias) or
    ``"zero"`` (adaLN-Zero)."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype, init: str = "xavier"):
        super().__init__()
        self.dtype = dtype
        self.init = init
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.bias.zero_()
            if self.init == "zero":
                self.weight.zero_()
            elif self.init == "normal":
                self.weight.normal_(0.0, 0.02, generator=generator)
            else:
                xavier_uniform_(self.weight.flatten(1), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.flatten(1).to(self.dtype), self.bias.to(self.dtype))


def xavier_uniform_(w: torch.Tensor, generator: torch.Generator) -> None:
    bound = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
    w.uniform_(-bound, bound, generator=generator)


class _NormModulate(torch.autograd.Function):
    """``LN(x) (1 + scale) + shift`` in fp32, rounded to ``dtype``: x (B, N, C)
    fp32, shift and scale (B, C). Saves ``x``, its statistics and ``scale``;
    the backward recomputes ``LN(x)`` (an fp32 (B, N, C) tensor a block
    layer does not keep)."""

    @staticmethod
    def forward(ctx, x, shift, scale, dtype):
        xhat, mean, rstd = torch.native_layer_norm(x, (x.shape[-1],), None, None, LN_EPS)
        ctx.save_for_backward(x, mean, rstd, scale)
        return torch.addcmul(shift[:, None], xhat, 1 + scale[:, None]).to(dtype)

    @staticmethod
    def backward(ctx, g):
        x, mean, rstd, scale = ctx.saved_tensors
        g = g.float()
        xhat = (x - mean) * rstd
        dx = torch.ops.aten.native_layer_norm_backward(
            g * (1 + scale[:, None]), x, (x.shape[-1],), mean, rstd, None, None, [True, False, False])[0]
        return dx, g.sum(1), (g * xhat).sum(1), None


def norm_modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """DiT's ``modulate(norm(x), shift, scale)``, rounded to ``dtype``."""
    return _NormModulate.apply(x, shift, scale, dtype)


class Attention(nn.Module):
    """timm's ``Attention`` as DiT builds it: qkv with bias, no q/k norm."""

    def __init__(self, hidden_size: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} not divisible by num_heads {num_heads}")
        self.num_heads = num_heads
        self.qkv = Linear(hidden_size, 3 * hidden_size, dtype)
        self.proj = Linear(hidden_size, hidden_size, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads)
        q, k, v = qkv.unbind(2)  # (b, n, heads, hd) views of the (b, n, 3C) tensor
        return self.proj(flash_attention(q, k, v).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, hidden_size: int, mlp_hidden: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Linear(hidden_size, mlp_hidden, dtype)
        self.fc2 = Linear(mlp_hidden, hidden_size, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class DiTBlock(nn.Module):
    """The adaLN-Zero block, with spans ``tinyedm.dit.modulation``,
    ``.attention`` and ``.mlp`` (each normalization and gated sum in the span
    of its branch)."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.attn = Attention(hidden_size, num_heads, dtype)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio), dtype)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Linear(hidden_size, 6 * hidden_size, dtype, "zero"))

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        with span("tinyedm.dit.modulation"):
            mod = self.adaLN_modulation(c).float().chunk(6, dim=1)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod
        with span("tinyedm.dit.attention"):
            x = torch.addcmul(x, gate_msa[:, None], self.attn(norm_modulate(x, shift_msa, scale_msa, self.dtype)))
        with span("tinyedm.dit.mlp"):
            x = torch.addcmul(x, gate_mlp[:, None], self.mlp(norm_modulate(x, shift_mlp, scale_mlp, self.dtype)))
        return x


class FinalLayer(nn.Module):
    def __init__(self, hidden_size: int, patch_size: int, out_channels: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.linear = Linear(hidden_size, patch_size * patch_size * out_channels, dtype, "zero")
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), Linear(hidden_size, 2 * hidden_size, dtype, "zero"))

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        shift, scale = self.adaLN_modulation(c).float().chunk(2, dim=1)
        return self.linear(norm_modulate(x, shift, scale, self.dtype))


class PatchEmbed(nn.Module):
    """timm's ``PatchEmbed``: ``Conv2d(in, hidden, p, stride p)`` with bias,
    its weight stored as the conv's (hidden, in, p, p), computed as one
    linear layer on the (b, n, in p p) patches."""

    def __init__(self, patch_size: int, in_channels: int, hidden_size: int, dtype: torch.dtype):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Linear(in_channels * patch_size * patch_size, hidden_size, dtype)
        self.proj.weight = nn.Parameter(torch.empty(hidden_size, in_channels, patch_size, patch_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        p = self.patch_size
        patches = x.reshape(b, c, h // p, p, w // p, p).permute(0, 2, 4, 1, 3, 5).reshape(b, -1, c * p * p)
        return self.proj(patches)


class DiT(nn.Module):
    """The DiT backbone as ``DenoiserWrapper``'s net: ``forward(x, c_noise,
    c)`` with ``x`` the preconditioned input (B, in, H, W) and ``c`` the
    embedder's (B, hidden); returns (B, out, H, W) in ``dtype``. ``c_noise``
    is taken for the wrapper's call and unused: the embedder has read it."""

    def __init__(self, input_size: int, in_channels: int, out_channels: int, patch_size: int,
                 hidden_size: int, depth: int, num_heads: int, mlp_ratio: float, dtype: torch.dtype):
        super().__init__()
        if input_size % patch_size:
            raise ValueError(f"input_size {input_size} not divisible by patch_size {patch_size}")
        self.out_channels = out_channels
        self.patch_size = patch_size
        self.grid = input_size // patch_size
        self.x_embedder = PatchEmbed(patch_size, in_channels, hidden_size, dtype)
        self.register_buffer("pos_embed", torch.empty(1, self.grid * self.grid, hidden_size))
        self.blocks = nn.ModuleList(DiTBlock(hidden_size, num_heads, mlp_ratio, dtype) for _ in range(depth))
        self.final_layer = FinalLayer(hidden_size, patch_size, out_channels, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        table = sincos_pos_embed(self.pos_embed.shape[-1], self.grid)
        with torch.no_grad():
            self.pos_embed.copy_(torch.from_numpy(table).float()[None])

    def unpatchify(self, x: torch.Tensor) -> torch.Tensor:
        """(B, n, p p out) -> (B, out, H, W), DiT's channel order (p, q, c)."""
        b, p, g, c = x.shape[0], self.patch_size, self.grid, self.out_channels
        return x.reshape(b, g, g, p, p, c).permute(0, 5, 1, 3, 2, 4).reshape(b, c, g * p, g * p)

    def forward(self, x: torch.Tensor, c_noise: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        del c_noise
        h = self.x_embedder(x).float() + self.pos_embed
        for block in self.blocks:
            h = block(h, c)
        return self.unpatchify(self.final_layer(h, c))


class DiTEmbedding(nn.Module):
    """DiT's timestep and class embedders on EDM's noise level:
    ``(sigma, labels) -> (frequencies, c)``, ``c`` fp32 (B, hidden) =
    ``t_embedder(ln(sigma) / 4) + y_embedder(labels)``. Labels -1 (or None,
    for a conditional model) take the null row; ``num_classes`` None or -1
    makes it unconditional."""

    def __init__(self, hidden_size: int, num_classes: Optional[int] = None, frequency_dim: int = 256):
        super().__init__()
        self.embedding_dim = hidden_size
        self.fourier_dim = frequency_dim
        self.num_classes = num_classes
        self.t_embedder = nn.Module()
        self.t_embedder.mlp = nn.Sequential(Linear(frequency_dim, hidden_size, torch.float32, "normal"), nn.SiLU(),
                                            Linear(hidden_size, hidden_size, torch.float32, "normal"))
        self.y_embedder = None
        if num_classes not in (None, -1):
            self.y_embedder = nn.Module()
            self.y_embedder.embedding_table = nn.Parameter(torch.empty(num_classes + 1, hidden_size))

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.y_embedder is not None:
            with torch.no_grad():
                self.y_embedder.embedding_table.normal_(0.0, 0.02, generator=generator)

    def forward(self, sigma: torch.Tensor, class_labels: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        freqs = timestep_embedding(torch.log(sigma.float()) / 4.0, self.fourier_dim)
        c = self.t_embedder.mlp(freqs).float()
        if self.y_embedder is not None:
            if class_labels is None:
                class_labels = torch.full(sigma.shape, -1, device=sigma.device)
            labels = class_labels.reshape(-1).long()
            rows = torch.where(labels < 0, torch.full_like(labels, self.num_classes), labels)
            c = c + F.embedding(rows, self.y_embedder.embedding_table)
        elif class_labels is not None:
            raise ValueError("class_labels given but num_classes is None")
        return freqs, c


class DiTDenoiser(DenoiserWrapper):
    """``DenoiserWrapper(DiT(...), sigma_data)``, built from the keywords of
    a configuration, as ``EDM.denoiser``."""

    def __init__(self, input_size: int = 64, in_channels: int = 4, out_channels: int = 4, patch_size: int = 2,
                 hidden_size: int = 1152, depth: int = 28, num_heads: int = 16, mlp_ratio: float = 4.0,
                 sigma_data: float = 0.5, dtype: torch.dtype = torch.float32):
        super().__init__(DiT(input_size, in_channels, out_channels, patch_size, hidden_size, depth, num_heads,
                             mlp_ratio, dtype), sigma_data)
        self.in_channels = in_channels
