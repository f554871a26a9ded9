"""EDM2 magnitude-preserving U-Net denoiser, unrolled.

Counterpart of ``tinyedm_tpu/models/unet.py::Denoiser``: NCHW activations,
compute in ``dtype`` with fp32 preconditioning and an fp32 output combine.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from tinyedm_tpu_torch.models.blocks import DecoderBlock, EncoderBlock
from tinyedm_tpu_torch.models.layers import WNConv
from tinyedm_tpu_torch.models.topology import (
    default_decoder_block_types,
    default_decoder_out_channels,
    default_encoder_block_types,
    default_encoder_out_channels,
    default_skip_connections,
    get_skip_channels,
    parse_block_type,
    validate_topology,
)
from tinyedm_tpu_torch.ops.precond import edm_precond


class Denoiser(nn.Module):
    """D(x; sigma) = c_skip*x + c_out*gain_out*F(c_in*x, emb).

    The input is concat(c_in * x, ones); the conv_in output is the first skip
    and every encoder block output is pushed as a skip; decoder blocks pop
    skips LIFO where ``skip_connections`` says so."""

    def __init__(
        self,
        in_channels: int = 3,
        out_channels: int = 3,
        encoder_block_types: Sequence[str] = default_encoder_block_types(),
        decoder_block_types: Sequence[str] = default_decoder_block_types(),
        encoder_out_channels: Sequence[int] = default_encoder_out_channels(),
        decoder_out_channels: Sequence[int] = default_decoder_out_channels(),
        skip_connections: Sequence[bool] = default_skip_connections(),
        dropout_rate: float = 0.0,
        sigma_data: float = 0.5,
        encoder_add_factor: float = 0.3,
        decoder_add_factor: float = 0.3,
        embedding_dim: int = 768,
        num_heads: int = 4,
        dtype: torch.dtype = torch.float32,
        use_pallas_attention: bool = False,
        fused: str = "auto",
    ):
        super().__init__()
        validate_topology(
            encoder_block_types,
            decoder_block_types,
            encoder_out_channels,
            decoder_out_channels,
            skip_connections,
        )
        self.sigma_data = sigma_data
        self.dtype = dtype
        self.skip_connections = tuple(bool(s) for s in skip_connections)
        common = dict(
            embedding_dim=embedding_dim,
            num_heads=num_heads,
            dtype=dtype,
            use_pallas_attention=use_pallas_attention,
            fused=fused,
            dropout_rate=dropout_rate,
        )
        self.conv_in = WNConv(in_channels + 1, encoder_out_channels[0], 3, dtype=dtype)
        ch = encoder_out_channels[0]
        encoder = []
        for btype, out_ch in zip(encoder_block_types, encoder_out_channels):
            down, attn = parse_block_type(btype)
            encoder.append(
                EncoderBlock(ch, out_ch, down=down, attention=attn,
                             add_factor=encoder_add_factor, **common)
            )
            ch = out_ch
        self.encoder_blocks = nn.ModuleList(encoder)
        skip_ch = get_skip_channels(encoder_out_channels, decoder_out_channels, skip_connections)
        decoder = []
        for btype, out_ch, s_ch in zip(decoder_block_types, decoder_out_channels, skip_ch):
            up, attn = parse_block_type(btype)
            decoder.append(
                DecoderBlock(ch, out_ch, skip_channels=s_ch, up=up, attention=attn,
                             add_factor=decoder_add_factor, **common)
            )
            ch = out_ch
        self.decoder_blocks = nn.ModuleList(decoder)
        self.gain_out = nn.Parameter(torch.empty(()))
        self.conv_out = WNConv(ch, out_channels, 1, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.gain_out.zero_()

    def forward(
        self,
        noisy_image: torch.Tensor,
        sigma: torch.Tensor,
        embedding: torch.Tensor,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``train`` turns dropout on; its bits come from ``generator``, drawn
        block by block in module order."""
        noisy32 = noisy_image.float()
        c = edm_precond(sigma, self.sigma_data)
        x = c.c_in * noisy32
        x = self.conv_in(torch.cat([x, torch.ones_like(x[:, :1])], dim=1))
        skips = [x]
        for block in self.encoder_blocks:
            x = block(x, embedding, train, generator)
            skips.append(x)
        for block, has_skip in zip(self.decoder_blocks, self.skip_connections):
            x = block(x, embedding, skips.pop() if has_skip else None, train, generator)
        out = self.conv_out(x).float() * self.gain_out
        return out * c.c_out + noisy32 * c.c_skip
