"""Magnitude-preserving layers.

Counterpart of ``tinyedm_tpu/models/layers.py``. Activations are NCHW and
conv weights OIHW; stored weights are fp32 and every forward recomputes the
effective weight ``normalize(w) / sqrt(fan_in)`` in fp32 before casting it to
the compute dtype, as the JAX package does. Parameters are made empty and
filled by ``reset_parameters(generator)`` (see ``models/edm.py::init_weights``)
or by a loaded state dict.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tinyedm_tpu_torch.ops.attention import flash_attention, xla_attention
from tinyedm_tpu_torch.ops.fused_attention import MAX_FUSED_TOKENS, cosine_attention_qkv
from tinyedm_tpu_torch.ops.mp import mp_add, mp_silu, pixel_norm, weight_normalize


class WNLinear(nn.Module):
    """Weight-normalized, bias-free linear layer; stored weight (out, in)."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(generator=generator)

    def effective_weight(self) -> torch.Tensor:
        return weight_normalize(self.weight) * (1.0 / math.sqrt(self.weight.shape[1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.effective_weight().to(self.dtype))


class WNConv(nn.Module):
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
        super().__init__()
        self.dtype = dtype
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, k, k))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(generator=generator)

    def effective_weight(self) -> torch.Tensor:
        fan_in = self.weight[0].numel()
        return weight_normalize(self.weight) * (1.0 / math.sqrt(fan_in))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.effective_weight().to(self.dtype)
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
        return self.gain * self.linear_out(mp_silu(self.linear(x)))


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
        return torch.sigmoid(self.conv_1(mp_silu(self.conv_0(pooled))))


class ClassEmbedding(nn.Module):
    """One-hot class embedding scaled by sqrt(num_classes); fp32."""

    def __init__(self, num_classes: int, embedding_dim: int):
        super().__init__()
        self.num_classes = num_classes
        self.linear = WNLinear(num_classes, embedding_dim)

    def forward(self, labels: torch.Tensor) -> torch.Tensor:
        onehot = F.one_hot(labels.reshape(-1).long(), self.num_classes).float()
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
    ``(fourier_embedding, embedding)``."""

    def __init__(
        self,
        fourier_dim: int,
        embedding_dim: int,
        num_classes: Optional[int] = None,
        add_factor: float = 0.5,
    ):
        super().__init__()
        self.fourier_dim = fourier_dim
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
        return fourier, mp_silu(emb)


class CosineAttention(nn.Module):
    """Cosine self-attention over the H*W tokens, with a residual
    ``mp_add(x, out_conv(attention(qkv_conv(x))), 0.5)``.

    The JAX module's order of branches: ``fused="auto"`` sends n <=
    MAX_FUSED_TOKENS through ``cosine_attention_qkv`` (the fused CUDA kernels
    on the card); otherwise q, k and v are pixel-normed over the head dim and
    ``use_pallas`` sends them through ``flash_attention`` (the flash CUDA
    kernels at n >= 1024, ``xla_attention`` below), else through
    ``xla_attention``, the JAX package's XLA branch. ``fused="off"`` is kept
    for parity checks. The 1x1 convs run as GEMMs on the (b, n, C) token
    view, so the qkv tensor comes out (b, n, 3C) contiguous."""

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
        if fused == "block":
            raise NotImplementedError(
                "fused='block' (the whole-block attention kernel) is not ported yet; "
                "see ROADMAP.md section 2"
            )
        if fused not in ("auto", "off"):
            raise ValueError(f"fused must be 'auto' or 'off', got {fused!r}")
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
        w_qkv = self.qkv_conv.effective_weight().to(self.dtype)[:, :, 0, 0]
        qkv = torch.matmul(tokens, w_qkv.t())  # (b, n, 3C), contiguous
        if self.fused == "auto" and n <= MAX_FUSED_TOKENS:
            y = cosine_attention_qkv(qkv, self.num_heads)
        else:
            heads = self.num_heads
            q, k, v = pixel_norm(qkv.reshape(b, n, 3, heads, c // heads), dim=-1).unbind(2)
            attend = flash_attention if self.use_pallas else xla_attention
            y = attend(q, k, v).reshape(b, n, c)
        w_out = self.out_conv.effective_weight().to(self.dtype)[:, :, 0, 0]
        y = torch.matmul(y, w_out.t()).transpose(1, 2).reshape(b, c, h, w)
        return mp_add(x, y, 0.5)
