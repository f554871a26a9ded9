"""Magnitude-preserving layers.

Counterpart of ``tinyedm_tpu/models/layers.py``. Activations are NCHW and
conv weights OIHW; stored weights are fp32 and every forward recomputes the
effective weight ``normalize(w) / sqrt(fan_in)`` in fp32 and casts it to the
compute dtype, as the JAX package does (``compute_weight``): where none is
wanted, with one ``weight_norm_cast``, on the card one launch of its CUDA
kernel; where a gradient is wanted, with the autograd Function
``_WeightNormCast``, on the card one launch of that kernel forward and one
of its backward kernel, on the CPU the composite's ops. Parameters
are made empty and filled by ``reset_parameters(generator)`` (see
``models/edm.py::init_weights``) or by a loaded state dict.

Under tensor parallelism (``parallel/tensor.py::shard_model``) a sharded
``WNConv`` or ``WNLinear`` holds its rank's output channels and its grid in
``tp`` (None otherwise): it computes those channels from its whole input,
and the module that calls it gathers them over the model group where it
needs them whole (``gather``) or works on its slice (``local``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tinyedm_tpu_torch.ops.attention import flash_attention, xla_attention
from tinyedm_tpu_torch.ops.fused_attention import (
    MAX_FUSED_TOKENS,
    attention_block,
    block_kernel_fits,
    cosine_attention_qkv,
)
from tinyedm_tpu_torch.ops.mp import (
    _WeightNormCast,
    mp_add,
    mp_silu,
    pixel_norm,
    weight_norm_cast,
    weight_normalize,
)
from tinyedm_tpu_torch.parallel.tensor import gather, local


class _WeightNormed(nn.Module):
    """A stored fp32 weight (out, ...) whose effective weight is
    ``weight_normalize(w) / sqrt(fan_in)``, used in ``dtype``."""

    def __init__(self, shape: tuple[int, ...], dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(shape))
        self.tp = None  # the grid of a sharded layer (its rows; fan-in whole)
        self.scale = 1.0 / math.sqrt(math.prod(shape[1:]))  # 1 / sqrt(fan_in)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(generator=generator)

    def effective_weight(self) -> torch.Tensor:
        return weight_normalize(self.weight) * self.scale

    def compute_weight(self) -> torch.Tensor:
        """The effective weight in ``dtype``: ``_WeightNormCast`` where a
        gradient is wanted, else one ``weight_norm_cast`` (as ``pixel_norm``
        routes)."""
        w = self.weight
        if torch.is_grad_enabled() and w.requires_grad:
            return _WeightNormCast.apply(w, self.scale, self.dtype)
        return weight_norm_cast(w, self.scale, self.dtype)


class WNLinear(_WeightNormed):
    """Weight-normalized, bias-free linear layer; stored weight (out, in)."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype = torch.float32):
        super().__init__((out_features, in_features), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.compute_weight())


class WNConv(_WeightNormed):
    """Weight-normalized, bias-free 2D conv, padding SAME; OIHW stored weight.

    The JAX package's conv_in im2col GEMM and its 1x1-as-GEMM rewrite are XLA
    layout devices with the same math as this plain ``conv2d``."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__((out_channels, in_channels, kernel_size, kernel_size), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.compute_weight()
        return F.conv2d(x.to(self.dtype), w, padding=w.shape[-1] // 2)


def upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsampling (each pixel repeated twice per axis)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def downsample_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 average-pool downsampling."""
    return F.avg_pool2d(x, 2)


class UncertaintyNet(nn.Module):
    """EDM2 multi-task uncertainty head on the fp32 Fourier embedding:
    ``gain * linear_out(mp_silu(linear(concat(x, 1))))``, ``gain`` made 0."""

    def __init__(self, in_features: int, hidden_features: int):
        super().__init__()
        self.linear = WNLinear(in_features + 1, hidden_features)
        self.linear_out = WNLinear(hidden_features, 1)
        self.gain = nn.Parameter(torch.empty(()))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.gain.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        x = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)
        h = gather(mp_silu(self.linear(x)), self.linear.tp)
        return self.gain * gather(self.linear_out(h), self.linear_out.tp)


class ScaleLong(nn.Module):
    """Learned skip-connection gain: skip (B, C, H, W) -> gain (B, C, 1, 1)."""

    def __init__(self, channels: int, r: int = 16, dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = max(1, channels // r)
        self.conv_0 = WNConv(channels + 1, hidden, 1, dtype=dtype)
        self.conv_1 = WNConv(hidden, channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)
        pooled = x.mean(dim=(2, 3), keepdim=True)
        h = gather(mp_silu(self.conv_0(pooled)), self.conv_0.tp)
        return gather(torch.sigmoid(self.conv_1(h)), self.conv_1.tp)


class ClassEmbedding(nn.Module):
    """One-hot class embedding scaled by sqrt(num_classes); fp32. A label
    outside ``[0, num_classes)``, such as the null label -1 of guidance and
    label dropout, gives a zero row, as ``jax.nn.one_hot`` does. Sharded, it
    returns its rank's channels."""

    def __init__(self, num_classes: int, embedding_dim: int):
        super().__init__()
        self.num_classes = num_classes
        self.linear = WNLinear(num_classes, embedding_dim)

    def forward(self, labels: torch.Tensor) -> torch.Tensor:
        classes = torch.arange(self.num_classes, device=labels.device)
        onehot = (labels.reshape(-1, 1).long() == classes).float()
        return self.linear(onehot * math.sqrt(self.num_classes))


class FourierEmbedding(nn.Module):
    """Random Fourier features; ``freqs`` and ``phases`` are buffers."""

    def __init__(self, embedding_dim: int):
        super().__init__()
        self.register_buffer("freqs", torch.empty(embedding_dim))
        self.register_buffer("phases", torch.empty(embedding_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        two_pi = 2.0 * math.pi
        with torch.no_grad():
            self.freqs.normal_(generator=generator).mul_(two_pi)
            self.phases.uniform_(generator=generator).mul_(two_pi)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(-1).float()
        return torch.cos(torch.outer(x, self.freqs) + self.phases) * math.sqrt(2.0)


class Embedding(nn.Module):
    """sigma (+ optional class) embedding, an fp32 island. Returns
    ``(fourier_embedding, embedding)``. Sharded, the two linears (both of
    ``embedding_dim`` outputs) give their ranks' channels, which the
    ``mp_add`` and ``mp_silu`` take as they come before one gather."""

    def __init__(
        self,
        fourier_dim: int,
        embedding_dim: int,
        num_classes: Optional[int] = None,
        add_factor: float = 0.5,
    ):
        super().__init__()
        self.fourier_dim = fourier_dim
        self.embedding_dim = embedding_dim
        self.num_classes = num_classes
        self.add_factor = add_factor
        self.fourier_embed = FourierEmbedding(fourier_dim)
        self.sigma_embed = WNLinear(fourier_dim, embedding_dim)
        self.class_embed = (
            ClassEmbedding(num_classes, embedding_dim) if num_classes not in (None, -1) else None
        )

    def forward(
        self, sigma: torch.Tensor, class_labels: Optional[torch.Tensor] = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        c_noise = torch.log(sigma.float()) / 4.0
        fourier = self.fourier_embed(c_noise)
        emb = self.sigma_embed(fourier)
        if class_labels is not None:
            if self.class_embed is None:
                raise ValueError("class_labels given but num_classes is None")
            emb = mp_add(emb, self.class_embed(class_labels), self.add_factor)
        return fourier, gather(mp_silu(emb), self.sigma_embed.tp)


class CosineAttention(nn.Module):
    """Cosine self-attention over the H*W tokens, with a residual
    ``mp_add(x, out_conv(attention(qkv_conv(x))), 0.5)``.

    The JAX module's order of branches: ``fused="block"`` sends the whole
    block, where ``block_kernel_fits(n, C, heads)`` says the JAX package's
    block kernels fit, through ``attention_block`` (the block CUDA kernels on
    the card: both convs, the attention and the residual), with the effective
    weights as (in, out) matrices in the compute dtype. ``fused="auto"`` sends
    n <= MAX_FUSED_TOKENS through ``cosine_attention_qkv`` (the fused CUDA
    kernels on the card), and ``fused="on"`` sends every n there (the CUDA
    kernels take keys in chunks, so any n; a head dim above their
    MAX_HEAD_DIM raises, naming it). Otherwise, and for a "block" layer
    whose kernels do not fit, q, k and v are pixel-normed over the head dim and
    ``use_pallas`` sends them through ``flash_attention`` (the flash CUDA
    kernels at n >= 1024, ``xla_attention`` below), else through
    ``xla_attention``, the JAX package's XLA branch. ``fused="off"`` is kept
    for parity checks. Every route has the same parameters. The 1x1 convs run
    as GEMMs on the (b, n, C) token view, so the qkv tensor comes out
    (b, n, 3C) contiguous.

    Under tensor parallelism (``qkv_conv.tp``) the layer runs on its rank's
    heads where the heads divide the model group: ``qkv_conv`` holds their
    rows (``parallel/tensor.py::head_rows``), the attention runs on
    ``heads / N`` heads, its ``(b, n, C/N)`` output is gathered before
    ``out_conv``, and ``out_conv``'s channels take the residual on the
    input's slice before a gather. Where the heads do not divide, qkv is
    gathered and every rank runs every head, as GSPMD does around a
    ``pallas_call``. ``fused="block"`` takes the split route there (the
    GEMMs around ``cosine_attention_qkv`` on the rank's heads, where the
    block kernels would have run): its kernels add the residual from whole
    weights."""

    def __init__(
        self,
        channels: int,
        num_heads: int = 4,
        dtype: torch.dtype = torch.float32,
        use_pallas: bool = False,
        fused: str = "auto",
    ):
        super().__init__()
        if channels % num_heads:
            raise ValueError(f"channels {channels} not divisible by num_heads {num_heads}")
        if fused not in ("auto", "on", "off", "block"):
            raise ValueError(f"fused must be 'auto', 'on', 'off' or 'block', got {fused!r}")
        self.num_heads = num_heads
        self.dtype = dtype
        self.use_pallas = use_pallas
        self.fused = fused
        self.qkv_conv = WNConv(channels, 3 * channels, 1, dtype=dtype)
        self.out_conv = WNConv(channels, channels, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        n = h * w
        x = x.to(self.dtype)
        tokens = x.flatten(2).transpose(1, 2)  # (b, n, C) view
        tp = self.qkv_conv.tp
        if self.fused == "block" and tp is None and block_kernel_fits(n, c, self.num_heads):
            w_qkv = self.qkv_conv.compute_weight()[:, :, 0, 0].t()
            w_out = self.out_conv.compute_weight()[:, :, 0, 0].t()
            y = attention_block(tokens, w_qkv, w_out, self.num_heads)
            return y.transpose(1, 2).reshape(b, c, h, w)
        w_qkv = self.qkv_conv.compute_weight()[:, :, 0, 0]
        qkv = torch.matmul(tokens, w_qkv.t())  # (b, n, 3C), contiguous; a rank's rows under TP
        heads = self.num_heads
        by_head = tp is not None and heads % tp.model_size == 0
        if by_head:
            heads //= tp.model_size  # the rank's heads, in the kernels' layout
        else:
            qkv = gather(qkv, tp, -1)
        split_block = self.fused == "block" and tp is not None and block_kernel_fits(n, c, self.num_heads)
        if self.fused == "on" or (self.fused == "auto" and n <= MAX_FUSED_TOKENS) or split_block:
            y = cosine_attention_qkv(qkv, heads)
        else:
            hd = qkv.shape[-1] // (3 * heads)
            q, k, v = pixel_norm(qkv.reshape(b, n, 3, heads, hd), dim=-1).unbind(2)
            attend = flash_attention if self.use_pallas else xla_attention
            y = attend(q, k, v).reshape(b, n, heads * hd)
        if by_head:
            y = gather(y, tp, -1)
        w_out = self.out_conv.compute_weight()[:, :, 0, 0]
        y = torch.matmul(y, w_out.t()).transpose(1, 2).reshape(b, -1, h, w)
        return gather(mp_add(local(x, self.out_conv.tp), y, 0.5), self.out_conv.tp)
