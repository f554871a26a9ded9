"""Model and training configurations of the port, as Python constants.

Each entry of ``CONFIGS`` is the ``model`` block (``embedding`` and
``denoiser`` keywords) of a config in ``experiments/conf/``, with
interpolations resolved and ``_target_`` dropped; ``TRAINING`` holds the
training recipe of a config beside it. A CPU test holds each constant equal
to its YAML file. The port reads no YAML: the machine with the card has no
YAML parser.
"""

from __future__ import annotations

from typing import Optional

import torch

from tinyedm_tpu_torch.diffusion.diffuser import Diffuser
from tinyedm_tpu_torch.models.edm import EDM, init_weights
from tinyedm_tpu_torch.models.layers import Embedding
from tinyedm_tpu_torch.models.unet import Denoiser
from tinyedm_tpu_torch.training.ema import EMAConfig
from tinyedm_tpu_torch.training.train_step import OptimizerConfig
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

# experiments/conf/cifar10.yaml: the training recipe around the model block
# (datamodule batch, the model block's diffuser and optimizer/EMA keys, the
# trainer's accumulation). Adam's betas and eps are EDMSpec's and
# OptimizerConfig's defaults, which the YAML does not override.
CIFAR10_TRAINING = {
    "seed": 42,
    "batch_size": 256,
    "accumulate_grad_batches": 1,
    "diffuser": {"P_std": 1.2, "P_mean": -1.2},
    "use_uncertainty": False,
    "lr": 0.02,
    "steady_steps": 200,
    "rampup_steps": 200,  # counted in epochs (the YAML's scheduler_interval)
    "use_ema": True,
    "ema_length": 0.13,
    "every_n_steps": 1,
}

TRAINING = {"cifar10": CIFAR10_TRAINING}

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

    ``dtype`` overrides the config's compute dtype. The config's dropout
    rate is built in; dropout runs only in a forward with ``train=True``."""
    dev = resolve_device(device)
    cfg = CONFIGS[name]
    den_kwargs = dict(cfg["denoiser"])
    config_dtype = _DTYPES[den_kwargs.pop("dtype")]
    use_uncertainty = TRAINING.get(name, {}).get("use_uncertainty", False)
    model = EDM(
        Embedding(**cfg["embedding"]),
        Denoiser(**den_kwargs, dtype=dtype or config_dtype, fused=fused),
        use_uncertainty=use_uncertainty,
    )
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def build_training(
    name: str,
    device: Optional[str | torch.device] = None,
    dtype: Optional[torch.dtype] = None,
    *,
    fused: str = "auto",
    seed: int = 0,
) -> tuple[EDM, Diffuser, OptimizerConfig, Optional[EMAConfig], int]:
    """(model, diffuser, optimizer config, EMA config, batch size) of the
    named config's training recipe; the model as ``build_model`` makes it."""
    t = TRAINING[name]
    model = build_model(name, device, dtype, fused=fused, seed=seed)
    opt_cfg = OptimizerConfig(
        lr=t["lr"],
        rampup_steps=t["rampup_steps"],
        steady_steps=t["steady_steps"],
        accum_steps=t["accumulate_grad_batches"],
    )
    ema_cfg = (
        EMAConfig(sigma_rels=(t["ema_length"],), every_n_steps=t["every_n_steps"])
        if t["use_ema"]
        else None
    )
    return model, Diffuser(**t["diffuser"]), opt_cfg, ema_cfg, t["batch_size"]
