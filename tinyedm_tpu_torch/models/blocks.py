"""Encoder/decoder U-Net blocks.

Counterpart of ``tinyedm_tpu/models/blocks.py``. NCHW. The per-block
embedding modulation is an fp32 island: the embedding linear runs in fp32,
the residual is cast to fp32, multiplied by ``g * gain + 1``, passed through
``mp_silu`` and (in training) dropout in fp32, then cast back to the compute
dtype (the JAX package's default ``mod_fp32=True``; its bf16 island is not
ported). Autograd saves the island's fp32 tensors: the JAX package's
``remat_island`` recompute is not ported, since on the H100 it made the
CIFAR-10 train step about 10 ms slower to save 1.5 GiB of 80 (PERF.md).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tinyedm_tpu_torch.models.layers import (
    CosineAttention,
    ScaleLong,
    WNConv,
    WNLinear,
    downsample_2x,
    upsample_2x,
)
from tinyedm_tpu_torch.ops.dropout import apply_dropout_bits, dropout_bits, dropout_threshold
from tinyedm_tpu_torch.ops.mp import mp_add, mp_silu, pixel_norm


class _Block(nn.Module):
    """The residual branch and attention the two block kinds share."""

    def __init__(
        self,
        res_channels: int,
        out_channels: int,
        embedding_dim: int,
        attention: bool,
        num_heads: int,
        add_factor: float,
        dtype: torch.dtype,
        use_pallas_attention: bool,
        fused: str,
        dropout_rate: float,
    ):
        super().__init__()
        self.dtype = dtype
        self.add_factor = add_factor
        self.dropout_rate = dropout_rate
        self.conv_3x3_1 = WNConv(res_channels, out_channels, 3, dtype=dtype)
        self.embed = WNLinear(embedding_dim, out_channels)
        self.gain = nn.Parameter(torch.empty(()))
        self.conv_3x3_2 = WNConv(out_channels, out_channels, 3, dtype=dtype)
        self.attention = (
            CosineAttention(
                out_channels, num_heads, dtype=dtype, use_pallas=use_pallas_attention, fused=fused
            )
            if attention
            else None
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.gain.fill_(1.0)

    def _island(
        self, res: torch.Tensor, gmod: torch.Tensor, bits: Optional[torch.Tensor]
    ) -> torch.Tensor:
        r = mp_silu(res.float() * gmod[:, :, None, None])
        if bits is not None:
            r = apply_dropout_bits(bits, r, self.dropout_rate)
        return r.to(self.dtype)

    def _residual(
        self,
        res: torch.Tensor,
        embedding: torch.Tensor,
        train: bool,
        generator: Optional[torch.Generator],
    ) -> torch.Tensor:
        res = self.conv_3x3_1(mp_silu(res))
        gmod = self.embed(embedding.float()) * self.gain + 1.0  # (B, C) fp32
        bits = None
        if train and dropout_threshold(self.dropout_rate) < 65536:
            if generator is None:
                raise ValueError("training with dropout needs a generator")
            bits = dropout_bits(tuple(res.shape), generator, res.device)
        return self.conv_3x3_2(self._island(res, gmod, bits))

    def _finish(self, x: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
        out = mp_add(x, res, self.add_factor)
        return self.attention(out) if self.attention is not None else out


class EncoderBlock(_Block):
    """downsample? -> 1x1 conv (if channels change) -> pixel_norm(channels)
    -> residual branch -> mp_add -> optional cosine attention."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        embedding_dim: int,
        down: bool = False,
        attention: bool = False,
        num_heads: int = 4,
        add_factor: float = 0.3,
        dtype: torch.dtype = torch.float32,
        use_pallas_attention: bool = False,
        fused: str = "auto",
        dropout_rate: float = 0.0,
    ):
        super().__init__(
            out_channels, out_channels, embedding_dim, attention, num_heads, add_factor,
            dtype, use_pallas_attention, fused, dropout_rate,
        )
        self.down = down
        self.conv_1x1 = (
            WNConv(in_channels, out_channels, 1, dtype=dtype)
            if in_channels != out_channels
            else None
        )

    def forward(
        self,
        x: torch.Tensor,
        embedding: torch.Tensor,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        if self.down:
            x = downsample_2x(x)
        if self.conv_1x1 is not None:
            x = self.conv_1x1(x)
        x = pixel_norm(x, dim=1)
        return self._finish(x, self._residual(x, embedding, train, generator))


class DecoderBlock(_Block):
    """concat(x, skip * ScaleLong(skip))? -> upsample? -> residual branch
    taken from that input BEFORE the 1x1 conv -> 1x1 conv (if channels
    change) -> mp_add -> optional cosine attention. No pixel_norm."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        embedding_dim: int,
        skip_channels: int = 0,
        up: bool = False,
        attention: bool = False,
        num_heads: int = 4,
        add_factor: float = 0.3,
        dtype: torch.dtype = torch.float32,
        use_pallas_attention: bool = False,
        fused: str = "auto",
        dropout_rate: float = 0.0,
    ):
        cat_channels = in_channels + skip_channels
        super().__init__(
            cat_channels, out_channels, embedding_dim, attention, num_heads, add_factor,
            dtype, use_pallas_attention, fused, dropout_rate,
        )
        self.up = up
        self.cat_factor = ScaleLong(skip_channels, dtype=dtype) if skip_channels else None
        self.conv_1x1 = (
            WNConv(cat_channels, out_channels, 1, dtype=dtype)
            if cat_channels != out_channels
            else None
        )

    def forward(
        self,
        x: torch.Tensor,
        embedding: torch.Tensor,
        skip: Optional[torch.Tensor] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        if (skip is None) != (self.cat_factor is None):
            raise ValueError("skip must be given exactly when the block was built with skip_channels")
        if skip is not None:
            x = torch.cat([x, skip.to(self.dtype) * self.cat_factor(skip)], dim=1)
        if self.up:
            x = upsample_2x(x)
        res = x
        if self.conv_1x1 is not None:
            x = self.conv_1x1(x)
        return self._finish(x, self._residual(res, embedding, train, generator))
