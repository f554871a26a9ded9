"""Model configurations of the port, as Python constants.

Each entry is the ``model`` block (``embedding`` and ``denoiser`` keywords)
of a config in ``experiments/conf/``, with interpolations resolved and
``_target_`` dropped; a CPU test holds each constant equal to its YAML file.
The port reads no YAML: the machine with the card has no YAML parser.
"""

from __future__ import annotations

from typing import Optional

import torch

from tinyedm_tpu_torch.models.edm import EDM, init_weights
from tinyedm_tpu_torch.models.layers import Embedding
from tinyedm_tpu_torch.models.unet import Denoiser
from tinyedm_tpu_torch.utils.cuda import resolve_device

# experiments/conf/cifar10.yaml:20-45 (the reference FID-4.0 recipe, 35.62 M
# parameters, bf16 compute, unconditional)
CIFAR10 = {
    "embedding": {"fourier_dim": 64, "embedding_dim": 256, "num_classes": None},
    "denoiser": {
        "in_channels": 3,
        "out_channels": 3,
        "sigma_data": 0.5,
        "embedding_dim": 256,
        "encoder_block_types": ["Enc", "Enc", "EncD", "EncA", "EncA", "EncD", "EncA", "EncA"],
        "decoder_block_types": [
            "DecA", "Dec", "DecA", "DecA", "DecA", "DecU",
            "DecA", "DecA", "DecA", "DecU", "Dec", "Dec", "Dec",
        ],
        "encoder_out_channels": [256] * 8,
        "decoder_out_channels": [256] * 13,
        "skip_connections": [
            False, False, True, True, True, False,
            True, True, True, False, True, True, True,
        ],
        "dropout_rate": 0.13,
        "dtype": "bfloat16",
    },
}

# experiments/conf/smoke.yaml (tiny conditional model: 16x16 images, widths
# 32-64, every block type, attention at 8x8)
SMOKE = {
    "embedding": {"fourier_dim": 16, "embedding_dim": 32, "num_classes": 10},
    "denoiser": {
        "in_channels": 3,
        "out_channels": 3,
        "sigma_data": 0.5,
        "embedding_dim": 32,
        "encoder_block_types": ["Enc", "EncD", "EncA"],
        "decoder_block_types": ["DecA", "Dec", "DecU", "Dec", "Dec"],
        "encoder_out_channels": [32, 64, 64],
        "decoder_out_channels": [64, 64, 32, 32, 32],
        "skip_connections": [True, True, False, True, True],
        "num_heads": 2,
        "dropout_rate": 0.1,
        "dtype": "bfloat16",
    },
}

CONFIGS = {"cifar10": CIFAR10, "smoke": SMOKE}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_model(
    name: str,
    device: Optional[str | torch.device] = None,
    dtype: Optional[torch.dtype] = None,
    *,
    fused: str = "auto",
    seed: int = 0,
) -> EDM:
    """The named config's EDM in eval mode on ``device`` (the card unless
    ``"cpu"`` is asked for), with weights drawn from ``seed``.

    ``dtype`` overrides the config's compute dtype. Dropout is a training
    feature and is not built."""
    dev = resolve_device(device)
    cfg = CONFIGS[name]
    den_kwargs = dict(cfg["denoiser"])
    den_kwargs.pop("dropout_rate")
    config_dtype = _DTYPES[den_kwargs.pop("dtype")]
    model = EDM(
        Embedding(**cfg["embedding"]),
        Denoiser(**den_kwargs, dtype=dtype or config_dtype, fused=fused),
    )
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
