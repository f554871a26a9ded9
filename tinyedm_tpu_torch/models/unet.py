"""EDM2 magnitude-preserving U-Net denoiser, unrolled.

Counterpart of ``tinyedm_tpu/models/unet.py::Denoiser``: NCHW activations,
compute in ``dtype`` with fp32 preconditioning and an fp32 output combine.

``remat`` recomputes each block in the backward, as the JAX package's
``nn.remat`` does: ``remat_policy="full"`` recomputes the whole block
(``torch.utils.checkpoint``); ``"convs"`` keeps the outputs of the convs,
matmuls and attention kernels and recomputes only the elementwise chains
between them (selective checkpointing, with the attention kernels' forwards
registered as ``torch.library`` custom ops so that the policy can name them:
``SAVED_BY_CONVS``). Either way the dropout bits are drawn before the
recomputed region, so the gradients are those of the model without remat.

Under tensor parallelism (``parallel/tensor.py::shard_model``) the sharded
convs give their ranks' channels, gathered where the next layer needs them
whole: ``conv_in``'s output, each block's output, and ``conv_out``'s where
its image channels divide the model group.

``scan_blocks`` is a layout flag of the JAX package (runs of identical
blocks stacked under one ``nn.scan``): an eager model gains nothing from a
scan, so the port takes the flag, builds the same per-block modules and
computes the same numbers. Its state dicts are always per-block;
``utils/interop.py`` unstacks a scanned JAX tree.

``DenoiserWrapper`` is the generic EDM preconditioner around any net: the
reference API's, exported for parity; the U-Net configs use ``Denoiser``, the
DiT config ``models/dit.py::DiTDenoiser``, a ``DenoiserWrapper``.
"""

from __future__ import annotations

import functools
import inspect
from typing import Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

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
from tinyedm_tpu_torch.ops.attention import flash_attention_fwd_op
from tinyedm_tpu_torch.ops.fused_attention import attention_block_fwd_op, cosine_attention_fwd_op
from tinyedm_tpu_torch.ops.precond import edm_precond
from tinyedm_tpu_torch.parallel.tensor import gather

_aten = torch.ops.aten
# the ops whose outputs remat_policy="convs" keeps (the JAX package's
# _convs_saveable_policy: conv_general_dilated, dot_general, custom_vjp_call)
SAVED_BY_CONVS = (
    _aten.convolution.default,
    _aten.mm.default,
    _aten.addmm.default,
    _aten.bmm.default,
    _aten.baddbmm.default,
    cosine_attention_fwd_op,
    flash_attention_fwd_op,
    attention_block_fwd_op,
)
REMAT_POLICIES = ("full", "convs")


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
        mod_fp32: bool = True,
        remat: bool = False,
        remat_policy: str = "full",
        scan_blocks: bool = False,
    ):
        super().__init__()
        # YAML 1.1 reads `fused: on` and `fused: off` as booleans
        fused = {True: "on", False: "off"}.get(fused, fused)
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, got {remat_policy!r}")
        validate_topology(
            encoder_block_types,
            decoder_block_types,
            encoder_out_channels,
            decoder_out_channels,
            skip_connections,
        )
        self.sigma_data = sigma_data
        self.in_channels = in_channels
        self.dtype = dtype
        self.skip_connections = tuple(bool(s) for s in skip_connections)
        self.remat = remat
        self.remat_policy = remat_policy
        self.scan_blocks = scan_blocks
        common = dict(
            embedding_dim=embedding_dim,
            num_heads=num_heads,
            dtype=dtype,
            use_pallas_attention=use_pallas_attention,
            fused=fused,
            dropout_rate=dropout_rate,
            mod_fp32=mod_fp32,
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

    def _block(self, block: nn.Module, train: bool, generator: Optional[torch.Generator],
               *inputs: Optional[torch.Tensor]) -> torch.Tensor:
        """``block.run`` on ``inputs`` and the block's dropout bits, under
        the remat policy when a gradient is wanted."""
        bits = block.draw_bits(inputs[0], train, generator)
        if not (self.remat and torch.is_grad_enabled()):
            return block.run(*inputs, bits)
        context = {}
        if self.remat_policy == "convs":
            context["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, list(SAVED_BY_CONVS)
            )
        return checkpoint(block.run, *inputs, bits, use_reentrant=False,
                          preserve_rng_state=False, **context)

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
        x = gather(self.conv_in(torch.cat([x, torch.ones_like(x[:, :1])], dim=1)), self.conv_in.tp)
        skips = [x]
        for block in self.encoder_blocks:
            x = self._block(block, train, generator, x, embedding)
            skips.append(x)
        for block, has_skip in zip(self.decoder_blocks, self.skip_connections):
            skip = skips.pop() if has_skip else None
            x = self._block(block, train, generator, x, embedding, skip)
        out = gather(self.conv_out(x), self.conv_out.tp).float() * self.gain_out
        return out * c.c_out + noisy32 * c.c_skip


@functools.lru_cache(maxsize=None)
def _forward_takes(cls: type) -> frozenset[str]:
    """The names among ``train`` and ``generator`` that ``cls.forward`` takes."""
    return frozenset({"train", "generator"} & set(inspect.signature(cls.forward).parameters))


class DenoiserWrapper(nn.Module):
    """D(x; sigma) = c_skip*x + c_out*net(c_in*x, c_noise, embedding), the
    preconditioning in fp32, ``c_noise = ln(sigma)/4`` handed to the net as
    (B,). The call is ``Denoiser``'s, so an ``EDM`` holds either. ``train``
    (and ``generator``, the dropout bits' source) reach the net only where
    its ``forward`` takes them; other nets keep the bare three-argument call,
    as in the JAX package."""

    def __init__(self, net: nn.Module, sigma_data: float = 0.5):
        super().__init__()
        self.net = net
        self.sigma_data = sigma_data

    def forward(
        self,
        noisy_image: torch.Tensor,
        sigma: torch.Tensor,
        embedding: Optional[torch.Tensor] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        noisy32 = noisy_image.float()
        c = edm_precond(sigma, self.sigma_data)
        takes = _forward_takes(type(self.net))
        kwargs = {k: v for k, v in (("train", train), ("generator", generator)) if k in takes}
        f = self.net(c.c_in * noisy32, c.c_noise, embedding, **kwargs)
        return c.c_skip * noisy32 + c.c_out * f.float()
