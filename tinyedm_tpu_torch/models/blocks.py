"""Encoder/decoder U-Net blocks.

Counterpart of ``tinyedm_tpu/models/blocks.py``. NCHW. The per-block
embedding modulation is an island: the embedding linear runs in fp32, the
residual is cast to fp32 and multiplied by ``g * gain + 1``; with
``mod_fp32=True`` (the default) ``mp_silu`` and (in training) dropout run in
fp32 before the cast back to the compute dtype, with ``mod_fp32=False`` the
product is cast to the compute dtype first and they run there (the JAX
package's bf16 island). Autograd saves the island's tensors: the JAX
package's ``remat_island`` recompute is not ported, since on the H100 it made
the CIFAR-10 train step about 10 ms slower to save 1.5 GiB of 80 (PERF.md).

A block's dropout bits are drawn by ``draw_bits`` before its computation
(``run``), as the JAX package draws them outside ``jax.checkpoint``: a
recompute of ``run`` (``Denoiser(remat=True)``) applies the same mask, since
it draws nothing.

Under tensor parallelism (``parallel/tensor.py``) the residual branch stays
sharded between its two convs: ``conv_3x3_1`` and the ``embed`` linear give
the rank's channels, the island runs on them with the rank's slice of the
(whole-drawn) dropout bits, so the mask is one process's, and the result is
gathered for ``conv_3x3_2``. Its channels take the residual ``mp_add`` on the
block input's slice (the decoder's ``conv_1x1`` output is that slice
already) before the block output is gathered.
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
from tinyedm_tpu_torch.parallel.tensor import gather, local


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
        mod_fp32: bool,
    ):
        super().__init__()
        self.dtype = dtype
        self.mod_fp32 = mod_fp32
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
        r = res.float() * gmod[:, :, None, None]
        if not self.mod_fp32:
            r = r.to(self.dtype)
        r = mp_silu(r)
        if bits is not None:
            r = apply_dropout_bits(bits, r, self.dropout_rate)
        return r.to(self.dtype)

    def _residual_size(self, h: int, w: int) -> tuple[int, int]:
        raise NotImplementedError

    def draw_bits(
        self, x: torch.Tensor, train: bool, generator: Optional[torch.Generator]
    ) -> Optional[torch.Tensor]:
        """The dropout bits of a forward on block input ``x``, shaped as the
        residual branch's first conv output; None outside training or when
        the rate keeps everything."""
        if not train or dropout_threshold(self.dropout_rate) >= 65536:
            return None
        if generator is None:
            raise ValueError("training with dropout needs a generator")
        b, _, h, w = x.shape
        tp = self.conv_3x3_2.tp  # drawn whole under tensor parallelism
        channels = self.conv_3x3_2.weight.shape[0] * (tp.model_size if tp is not None else 1)
        shape = (b, channels, *self._residual_size(h, w))
        return dropout_bits(shape, generator, x.device)

    def _residual(
        self, res: torch.Tensor, embedding: torch.Tensor, bits: Optional[torch.Tensor]
    ) -> torch.Tensor:
        """The residual branch: the rank's channels of ``conv_3x3_2`` under
        tensor parallelism."""
        tp = self.conv_3x3_1.tp
        res = self.conv_3x3_1(mp_silu(res))
        gmod = self.embed(embedding.float()) * self.gain + 1.0  # (B, C) fp32
        bits = None if bits is None else local(bits, tp)
        return self.conv_3x3_2(gather(self._island(res, gmod, bits), tp))

    def _finish(self, x: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
        """``mp_add`` of ``x`` and ``res`` (both the rank's channels under
        tensor parallelism), gathered, then the attention."""
        out = gather(mp_add(x, res, self.add_factor), self.conv_3x3_2.tp)
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
        mod_fp32: bool = True,
    ):
        super().__init__(
            out_channels, out_channels, embedding_dim, attention, num_heads, add_factor,
            dtype, use_pallas_attention, fused, dropout_rate, mod_fp32,
        )
        self.down = down
        self.conv_1x1 = (
            WNConv(in_channels, out_channels, 1, dtype=dtype)
            if in_channels != out_channels
            else None
        )

    def _residual_size(self, h: int, w: int) -> tuple[int, int]:
        return (h // 2, w // 2) if self.down else (h, w)

    def forward(
        self,
        x: torch.Tensor,
        embedding: torch.Tensor,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        return self.run(x, embedding, self.draw_bits(x, train, generator))

    def run(
        self, x: torch.Tensor, embedding: torch.Tensor, bits: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """The block on the dropout bits of ``draw_bits`` (None: no dropout)."""
        if self.down:
            x = downsample_2x(x)
        if self.conv_1x1 is not None:
            x = gather(self.conv_1x1(x), self.conv_1x1.tp)
        x = pixel_norm(x, dim=1)
        return self._finish(local(x, self.conv_3x3_2.tp), self._residual(x, embedding, bits))


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
        mod_fp32: bool = True,
    ):
        cat_channels = in_channels + skip_channels
        super().__init__(
            cat_channels, out_channels, embedding_dim, attention, num_heads, add_factor,
            dtype, use_pallas_attention, fused, dropout_rate, mod_fp32,
        )
        self.up = up
        self.cat_factor = ScaleLong(skip_channels, dtype=dtype) if skip_channels else None
        self.conv_1x1 = (
            WNConv(cat_channels, out_channels, 1, dtype=dtype)
            if cat_channels != out_channels
            else None
        )

    def _residual_size(self, h: int, w: int) -> tuple[int, int]:
        return (2 * h, 2 * w) if self.up else (h, w)

    def forward(
        self,
        x: torch.Tensor,
        embedding: torch.Tensor,
        skip: Optional[torch.Tensor] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        return self.run(x, embedding, skip, self.draw_bits(x, train, generator))

    def run(
        self,
        x: torch.Tensor,
        embedding: torch.Tensor,
        skip: Optional[torch.Tensor] = None,
        bits: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """The block on the dropout bits of ``draw_bits`` (None: no dropout)."""
        if (skip is None) != (self.cat_factor is None):
            raise ValueError("skip must be given exactly when the block was built with skip_channels")
        if skip is not None:
            x = torch.cat([x, skip.to(self.dtype) * self.cat_factor(skip)], dim=1)
        if self.up:
            x = upsample_2x(x)
        res = x
        # the rank's channels under tensor parallelism (conv_1x1's own)
        x = self.conv_1x1(x) if self.conv_1x1 is not None else local(x, self.conv_3x3_2.tp)
        return self._finish(x, self._residual(res, embedding, bits))
