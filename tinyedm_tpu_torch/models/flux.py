"""FLUX.1, the text-to-image transformer of Black Forest Labs
(``black-forest-labs/flux``: ``src/flux/model.py``, ``modules/layers.py``;
the ``flux-dev`` entry of ``util.py``'s configs), under EDM preconditioning.

The equations of ``Flux``, with its parameter names, split across the two
halves an ``EDM`` holds:

- ``FluxEmbedding`` (``EDM.embedding``): ``vec = time_in(emb(t)) +
  guidance_in(emb(g)) + vector_in(y)``, each ``*_in`` an ``MLPEmbedder``
  (``in_layer -> SiLU -> out_layer``) and ``emb`` DiT's 256 frequencies
  ``[cos, sin]`` of ``1000 t`` (``models/dit.py::timestep_embedding``);
  ``y`` is the pooled text vector and ``g`` the guidance value of the
  ``TextConditioning``. Returns ``(frequencies, (vec, txt))``, ``txt`` the
  text encoder's tokens, which the denoiser embeds.
- ``FluxDenoiser`` (``EDM.denoiser``): ``DenoiserWrapper`` around ``Flux``:
  the latents packed 2 x 2 (``b c (h 2) (w 2) -> b (h w) (c 2 2)``) through
  ``img_in``, the text tokens through ``txt_in``; the position ids (a text
  token's (0, 0, 0), an image token's (0, row, col)) and their rotary table
  (``ops/rope.py::rope_table``, ``axes_dim`` pairs per axis at ``theta``);
  ``depth`` double-stream blocks, then ``depth_single_blocks``
  single-stream blocks on ``cat(txt, img)``, the image tokens through the last layer,
  unpacked.

A double block: per stream s (img, txt) ``Modulation`` (``lin(SiLU(vec))``,
6 chunks: shift, scale, gate twice); ``qkv_s = qkv(LN(x_s) (1 + scale1) +
shift1)`` with bias, LayerNorm without affine at eps 1e-6; q and k through
the stream's ``QKNorm`` (per-head RMSNorm, a learned scale of ``hd``) and
RoPE, attention over ``cat(txt, img)`` tokens at ``1/sqrt(hd)``; split back,
``x_s += gate1 proj_s(attn_s)``, ``x_s += gate2 mlp_s(LN(x_s) (1 + scale2) +
shift2)``, ``mlp_s`` ``Linear -> GELU(tanh) -> Linear``. A single block:
``Modulation`` of 3 chunks, ``linear1(LN(x) (1 + scale) + shift)`` split into
qkv (3 hidden) and an MLP input (``mlp_ratio`` hidden), QKNorm and RoPE on q
and k, attention, ``x += gate linear2(cat(attn, GELU_tanh(mlp)))``. The last
layer is DiT's ``FinalLayer`` at patch 1.

Departures from the published FLUX.1-dev:

- EDM's preconditioning and loss weight (``DenoiserWrapper``,
  ``diffusion/loss.py``) replace rectified flow's velocity target, so the 64
  packed output channels are EDM's ``F``;
- ``time_in`` reads ``1000 c_noise``, ``c_noise = ln(sigma) / 4``, where
  FLUX reads ``1000 t`` for t in [0, 1]: the same range of arguments;
- caption dropout (the train step's ``label_dropout``) zeroes a sample's
  text tokens and pooled vector, where FLUX's empty prompt would need the
  text encoders;
- the normalized q and k are scaled and rotated in fp32 and rounded once
  (FLUX rounds after the norm, before its scale);
- there is no uncertainty head.

Precision, as the DiT's (``models/dit.py``): fp32 parameters and residual
streams; every linear layer of ``Flux`` runs in ``dtype`` (bf16 in the
recipe) with fp32 sums, and so does the attention (the flash kernels at n
>= 1024, ``ops/attention.py::flash_attention``); the three embedders' linear
layers run in fp32; the LayerNorm statistics, the modulation and the gated
sums are fp32 (``models/dit.py::norm_modulate``, ``torch.addcmul``); the
RMSNorm statistics and RoPE are fp32 (``ops/rope.py::qk_norm_rope``).

Spans: ``tinyedm.flux.double`` and ``tinyedm.flux.single`` around a block,
inside them ``tinyedm.flux.qk_norm_rope`` and ``tinyedm.flux.attention``.

``reset_parameters`` follows DiT's rules: xavier-uniform linear layers with
zero biases, the embedders' N(0, 0.02), RMSNorm scales 1, the last layer
zeroed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tinyedm_tpu_torch.diffusion.protocols import TextConditioning
from tinyedm_tpu_torch.models.dit import FinalLayer, Linear, norm_modulate, timestep_embedding
from tinyedm_tpu_torch.models.unet import DenoiserWrapper
from tinyedm_tpu_torch.ops.attention import flash_attention
from tinyedm_tpu_torch.ops.rope import qk_norm_rope, rope_table
from tinyedm_tpu_torch.utils.profiling import span

TIME_FACTOR = 1000.0


class MLPEmbedder(nn.Module):
    """``out_layer(SiLU(in_layer(x)))`` in fp32."""

    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__()
        self.in_layer = Linear(in_dim, hidden_dim, torch.float32, "normal")
        self.out_layer = Linear(hidden_dim, hidden_dim, torch.float32, "normal")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_layer(F.silu(self.in_layer(x)))


class RMSNorm(nn.Module):
    """The learned scale of one of q, k; ``ops/rope.py`` normalizes."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)


class QKNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.query_norm = RMSNorm(dim)
        self.key_norm = RMSNorm(dim)


class SelfAttention(nn.Module):
    """A stream's ``qkv`` (with bias), ``norm`` and ``proj``; the attention
    itself runs on the joined streams (``DoubleStreamBlock``)."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.qkv = Linear(dim, 3 * dim, dtype)
        self.norm = QKNorm(dim // num_heads)
        self.proj = Linear(dim, dim, dtype)


class Modulation(nn.Module):
    """``lin(SiLU(vec))`` in ``dtype``, as fp32 chunks: 6 (double) or 3."""

    def __init__(self, dim: int, double: bool, dtype: torch.dtype):
        super().__init__()
        self.multiplier = 6 if double else 3
        self.lin = Linear(dim, self.multiplier * dim, dtype)

    def forward(self, vec: torch.Tensor) -> tuple[torch.Tensor, ...]:
        return self.lin(F.silu(vec)).float().chunk(self.multiplier, dim=1)


def _mlp(dim: int, hidden: int, dtype: torch.dtype) -> nn.Sequential:
    return nn.Sequential(Linear(dim, hidden, dtype), nn.GELU(approximate="tanh"), Linear(hidden, dim, dtype))


def _attention(qkv: torch.Tensor, q_scale: torch.Tensor, k_scale: torch.Tensor, heads: int,
               cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """QK RMSNorm, RoPE and softmax attention on a (b, n, 3C) qkv tensor
    (the channels (3, heads, hd)); (b, n, C) in qkv's dtype."""
    b, n, c3 = qkv.shape
    q, k, v = qkv.reshape(b, n, 3, heads, c3 // (3 * heads)).unbind(2)
    with span("tinyedm.flux.qk_norm_rope"):
        q, k = qk_norm_rope(q, k, q_scale, k_scale, cos, sin)
    with span("tinyedm.flux.attention"):
        return flash_attention(q, k, v).reshape(b, n, c3 // 3)


def _per_token(txt_scale: torch.Tensor, img_scale: torch.Tensor, n_txt: int, n_img: int) -> torch.Tensor:
    """Each stream's RMSNorm scale for its own tokens: (n_txt + n_img, 1, hd)."""
    hd = txt_scale.shape[0]
    return torch.cat((txt_scale.expand(n_txt, 1, hd), img_scale.expand(n_img, 1, hd)))


class DoubleStreamBlock(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.num_heads = num_heads
        mlp_hidden = int(hidden_size * mlp_ratio)
        for s in ("img", "txt"):
            setattr(self, f"{s}_mod", Modulation(hidden_size, True, dtype))
            setattr(self, f"{s}_attn", SelfAttention(hidden_size, num_heads, dtype))
            setattr(self, f"{s}_mlp", _mlp(hidden_size, mlp_hidden, dtype))

    def forward(self, img: torch.Tensor, txt: torch.Tensor, vec: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        with span("tinyedm.flux.double"):
            i_shift1, i_scale1, i_gate1, i_shift2, i_scale2, i_gate2 = self.img_mod(vec)
            t_shift1, t_scale1, t_gate1, t_shift2, t_scale2, t_gate2 = self.txt_mod(vec)
            n_txt = txt.shape[1]
            qkv = torch.cat((self.txt_attn.qkv(norm_modulate(txt, t_shift1, t_scale1, self.dtype)),
                             self.img_attn.qkv(norm_modulate(img, i_shift1, i_scale1, self.dtype))), dim=1)
            t_norm, i_norm = self.txt_attn.norm, self.img_attn.norm
            attn = _attention(qkv, _per_token(t_norm.query_norm.scale, i_norm.query_norm.scale, n_txt, img.shape[1]),
                              _per_token(t_norm.key_norm.scale, i_norm.key_norm.scale, n_txt, img.shape[1]),
                              self.num_heads, cos, sin)
            txt = torch.addcmul(txt, t_gate1[:, None], self.txt_attn.proj(attn[:, :n_txt]))
            img = torch.addcmul(img, i_gate1[:, None], self.img_attn.proj(attn[:, n_txt:]))
            img = torch.addcmul(img, i_gate2[:, None],
                                self.img_mlp(norm_modulate(img, i_shift2, i_scale2, self.dtype)))
            txt = torch.addcmul(txt, t_gate2[:, None],
                                self.txt_mlp(norm_modulate(txt, t_shift2, t_scale2, self.dtype)))
            return img, txt


class SingleStreamBlock(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.num_heads = num_heads
        self.hidden_size = hidden_size
        self.mlp_hidden_dim = int(hidden_size * mlp_ratio)
        self.linear1 = Linear(hidden_size, 3 * hidden_size + self.mlp_hidden_dim, dtype)
        self.linear2 = Linear(hidden_size + self.mlp_hidden_dim, hidden_size, dtype)
        self.norm = QKNorm(hidden_size // num_heads)
        self.modulation = Modulation(hidden_size, False, dtype)

    def forward(self, x: torch.Tensor, vec: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        with span("tinyedm.flux.single"):
            shift, scale, gate = self.modulation(vec)
            qkv, mlp = self.linear1(norm_modulate(x, shift, scale, self.dtype)).split(
                [3 * self.hidden_size, self.mlp_hidden_dim], dim=-1)
            attn = _attention(qkv, self.norm.query_norm.scale, self.norm.key_norm.scale, self.num_heads, cos, sin)
            out = self.linear2(torch.cat((attn, F.gelu(mlp, approximate="tanh")), dim=2))
            return torch.addcmul(x, gate[:, None], out)


def image_ids(txt_len: int, h: int, w: int) -> np.ndarray:
    """The position ids of ``txt_len`` text tokens, then an h x w grid of
    image tokens row by row: (txt_len + h w, 3)."""
    ids = np.zeros((txt_len + h * w, 3), np.float64)
    ids[txt_len:, 1] = np.repeat(np.arange(h), w)
    ids[txt_len:, 2] = np.tile(np.arange(w), h)
    return ids


class Flux(nn.Module):
    """FLUX's backbone as ``DenoiserWrapper``'s net: ``forward(x, c_noise,
    c)`` with ``x`` the preconditioned latents (B, in/4, H, W) and ``c`` the
    embedding's ``(vec, txt)``; returns (B, out/4, H, W) in ``dtype``.
    ``c_noise`` is taken for the wrapper's call and unused: the embedding
    has read it."""

    def __init__(self, in_channels: int, out_channels: int, context_in_dim: int, hidden_size: int,
                 mlp_ratio: float, num_heads: int, depth: int, depth_single_blocks: int,
                 axes_dim: tuple[int, ...], theta: float, dtype: torch.dtype):
        super().__init__()
        hd = hidden_size // num_heads
        if hidden_size % num_heads or sum(axes_dim) != hd:
            raise ValueError(f"hidden_size {hidden_size} over {num_heads} heads must give a head dim equal to "
                             f"sum(axes_dim) = {sum(axes_dim)}")
        self.out_channels = out_channels
        self.axes_dim = tuple(axes_dim)
        self.theta = theta
        self.img_in = Linear(in_channels, hidden_size, dtype)
        self.txt_in = Linear(context_in_dim, hidden_size, dtype)
        self.double_blocks = nn.ModuleList(
            DoubleStreamBlock(hidden_size, num_heads, mlp_ratio, dtype) for _ in range(depth))
        self.single_blocks = nn.ModuleList(
            SingleStreamBlock(hidden_size, num_heads, mlp_ratio, dtype) for _ in range(depth_single_blocks))
        self.final_layer = FinalLayer(hidden_size, 1, out_channels, dtype)
        self._tables: dict = {}

    def rope(self, txt_len: int, h: int, w: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        """The rotary table of ``image_ids(txt_len, h, w)``, made once a shape."""
        key = (txt_len, h, w, device)
        if key not in self._tables:
            self._tables[key] = rope_table(image_ids(txt_len, h, w), self.axes_dim, self.theta, device)
        return self._tables[key]

    def forward(self, x: torch.Tensor, c_noise: torch.Tensor, c: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        del c_noise
        vec, txt = c
        b, ch, hh, ww = x.shape
        h, w = hh // 2, ww // 2
        packed = x.reshape(b, ch, h, 2, w, 2).permute(0, 2, 4, 1, 3, 5).reshape(b, h * w, ch * 4)
        img = self.img_in(packed).float()
        txt = self.txt_in(txt).float()
        n_txt = txt.shape[1]
        cos, sin = self.rope(n_txt, h, w, x.device)
        for block in self.double_blocks:
            img, txt = block(img, txt, vec, cos, sin)
        joint = torch.cat((txt, img), dim=1)
        for block in self.single_blocks:
            joint = block(joint, vec, cos, sin)
        out = self.final_layer(joint[:, n_txt:], vec)
        c = self.out_channels // 4
        return out.reshape(b, h, w, c, 2, 2).permute(0, 3, 1, 4, 2, 5).reshape(b, c, hh, ww)


class FluxEmbedding(nn.Module):
    """FLUX's ``time_in``, ``guidance_in`` and ``vector_in`` on EDM's noise
    level and a ``TextConditioning``: ``(sigma, cond) -> (frequencies, (vec,
    cond.txt))``, ``vec`` fp32 (B, hidden). It always reads a conditioning
    (``vec_in_dim``); it has no classes."""

    num_classes = None

    def __init__(self, hidden_size: int, vec_in_dim: int = 768, frequency_dim: int = 256,
                 guidance_embed: bool = True):
        super().__init__()
        self.embedding_dim = hidden_size
        self.fourier_dim = frequency_dim
        self.vec_in_dim = vec_in_dim
        self.time_in = MLPEmbedder(frequency_dim, hidden_size)
        self.guidance_in = MLPEmbedder(frequency_dim, hidden_size) if guidance_embed else None
        self.vector_in = MLPEmbedder(vec_in_dim, hidden_size)

    def forward(self, sigma: torch.Tensor, cond: Optional[TextConditioning] = None
                ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
        if not isinstance(cond, TextConditioning):
            raise ValueError(f"FLUX needs a TextConditioning, got {type(cond).__name__}")
        freqs = timestep_embedding(TIME_FACTOR * (torch.log(sigma.float()) / 4.0), self.fourier_dim)
        vec = self.time_in(freqs)
        if self.guidance_in is not None:
            vec = vec + self.guidance_in(timestep_embedding(TIME_FACTOR * cond.guidance.float(), self.fourier_dim))
        return freqs, (vec + self.vector_in(cond.y.float()), cond.txt)


class FluxDenoiser(DenoiserWrapper):
    """``DenoiserWrapper(Flux(...), sigma_data)``, built from the keywords of
    a configuration, as ``EDM.denoiser``, its keywords FLUX's ``FluxParams``
    (defaults ``flux-dev``'s): ``in_channels`` and ``out_channels`` are the
    packed widths (4 latent channels each), ``depth`` counts the double
    blocks."""

    def __init__(self, in_channels: int = 64, out_channels: int = 64, context_in_dim: int = 4096,
                 hidden_size: int = 3072, mlp_ratio: float = 4.0, num_heads: int = 24, depth: int = 19,
                 depth_single_blocks: int = 38, axes_dim: tuple[int, ...] = (16, 56, 56), theta: float = 10000.0,
                 sigma_data: float = 1.0, dtype: torch.dtype = torch.float32):
        super().__init__(Flux(in_channels, out_channels, context_in_dim, hidden_size, mlp_ratio, num_heads,
                              depth, depth_single_blocks, tuple(axes_dim), theta, dtype), sigma_data)
        self.in_channels = in_channels
