"""Declarative U-Net topology (reference: src/tinyedm/networks.py:332-487).

Block specs are strings: "Enc"/"EncD"/"EncA" and "Dec"/"DecU"/"DecA"
(D = downsample, U = upsample, A = attention). Defaults reproduce the EDM2
ImageNet-64 topology: 15 encoder blocks, 21 decoder blocks, channels
192 -> 768, and the skip-connection mask in get_skip_connections.
"""

from __future__ import annotations

from typing import Sequence


def default_encoder_block_types() -> tuple[str, ...]:
    # reference: networks.py:332-349
    return (
        "Enc", "Enc", "Enc", "EncD",
        "Enc", "Enc", "Enc", "EncD",
        "EncA", "EncA", "EncA", "EncD",
        "EncA", "EncA", "EncA",
    )


def default_decoder_block_types() -> tuple[str, ...]:
    # reference: networks.py:352-375
    return (
        "DecA", "Dec", "DecA", "DecA", "DecA", "DecA",
        "DecU", "DecA", "DecA", "DecA", "DecA",
        "DecU", "Dec", "Dec", "Dec", "Dec",
        "DecU", "Dec", "Dec", "Dec", "Dec",
    )


def default_encoder_out_channels() -> tuple[int, ...]:
    # reference: networks.py:378-379
    return (192, 192, 192, 192, 384, 384, 384, 384, 576, 576, 576, 576, 768, 768, 768)


def default_decoder_out_channels() -> tuple[int, ...]:
    # reference: networks.py:382-405
    return (
        768, 768, 768, 768, 768, 768,
        576, 576, 576, 576, 576,
        384, 384, 384, 384, 384, 384,
        192, 192, 192, 192,
    )


def default_skip_connections() -> tuple[bool, ...]:
    # reference: networks.py:408-432 — decoder positions that consume a skip
    return (
        False, False, True, True, True, True,
        False, True, True, True, True,
        False, True, True, True, True,
        False, True, True, True, True,
    )


def get_skip_channels(
    encoder_out_channels: Sequence[int],
    decoder_out_channels: Sequence[int],
    skip_connections: Sequence[bool],
) -> tuple[int, ...]:
    """Channel count of the skip consumed by each decoder block (0 = none).

    Skips are popped LIFO: reversed encoder outputs first, then the conv_in
    output (whose channel count equals encoder_out_channels[0]).
    Reference: networks.py:435-444.
    """
    sources = list(reversed(encoder_out_channels)) + [encoder_out_channels[0]]
    it = iter(sources)
    out: list[int] = []
    for has_skip in skip_connections:
        out.append(next(it) if has_skip else 0)
    return tuple(out)


def parse_block_type(block_type: str) -> tuple[bool, bool]:
    """Returns (resample, attention) for a block-type string.

    resample means down for Enc* and up for Dec*.
    """
    return block_type.endswith("D") or block_type.endswith("U"), block_type.endswith("A")


def validate_topology(
    encoder_block_types: Sequence[str],
    decoder_block_types: Sequence[str],
    encoder_out_channels: Sequence[int],
    decoder_out_channels: Sequence[int],
    skip_connections: Sequence[bool],
) -> None:
    if len(encoder_block_types) != len(encoder_out_channels):
        raise ValueError(
            "encoder_block_types and encoder_out_channels must have the same "
            f"length, got {len(encoder_block_types)} and {len(encoder_out_channels)}"
        )
    if len(decoder_block_types) != len(decoder_out_channels):
        raise ValueError(
            "decoder_block_types and decoder_out_channels must have the same "
            f"length, got {len(decoder_block_types)} and {len(decoder_out_channels)}"
        )
    if len(skip_connections) != len(decoder_out_channels):
        raise ValueError(
            "skip_connections must have the same length as decoder_out_channels, "
            f"got {len(skip_connections)} and {len(decoder_out_channels)}"
        )
    n_skips = sum(bool(s) for s in skip_connections)
    n_available = len(encoder_block_types) + 1  # +1: conv_in output
    if n_skips != n_available:
        raise ValueError(
            f"skip mask consumes {n_skips} skips but the encoder produces {n_available}"
        )
