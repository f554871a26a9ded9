"""Model and training configurations of the port, as Python constants.

Each entry of ``CONFIGS`` is the ``model`` block (``embedding`` and
``denoiser`` keywords) of a config in ``experiments/conf/``, with
interpolations resolved and ``_target_`` dropped; ``TRAINING`` holds the
training recipe of a config beside it. An entry builds the U-Net's
``Embedding`` and ``Denoiser`` unless its ``classes`` names others, as the
DiT's ``DiTEmbedding`` and ``DiTDenoiser`` (``models/dit.py``). A CPU test
holds each constant equal to its YAML file. The port reads no YAML: the machine with the card has no
YAML parser.
"""

from __future__ import annotations

from typing import Optional

import torch

from tinyedm_tpu_torch.diffusion.diffuser import Diffuser
from tinyedm_tpu_torch.models.dit import DiTDenoiser, DiTEmbedding
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

# experiments/conf/imagenet512.yaml:30-44 (the ImageNet-512 latent recipe,
# 272.95 M parameters: 64x64x4 latents, 1000 classes, bf16 compute, the
# flash-attention route for any attention layer at n >= 1024). The YAML
# leaves the topology to the Denoiser's defaults, the EDM2 ImageNet-64
# topology of tinyedm_tpu/models/topology.py:14-56, written out here.
IMAGENET512 = {
    "embedding": {"fourier_dim": 192, "embedding_dim": 768, "num_classes": 1000},
    "denoiser": {
        "in_channels": 4,
        "out_channels": 4,
        "sigma_data": 0.5,
        "embedding_dim": 768,
        "encoder_block_types": [
            "Enc", "Enc", "Enc", "EncD", "Enc", "Enc", "Enc", "EncD",
            "EncA", "EncA", "EncA", "EncD", "EncA", "EncA", "EncA",
        ],
        "decoder_block_types": [
            "DecA", "Dec", "DecA", "DecA", "DecA", "DecA",
            "DecU", "DecA", "DecA", "DecA", "DecA",
            "DecU", "Dec", "Dec", "Dec", "Dec",
            "DecU", "Dec", "Dec", "Dec", "Dec",
        ],
        "encoder_out_channels": [192] * 4 + [384] * 4 + [576] * 4 + [768] * 3,
        "decoder_out_channels": [768] * 6 + [576] * 5 + [384] * 6 + [192] * 4,
        "skip_connections": [
            False, False, True, True, True, True,
            False, True, True, True, True,
            False, True, True, True, True,
            False, True, True, True, True,
        ],
        "dropout_rate": 0.0,
        "dtype": "bfloat16",
        "use_pallas_attention": True,
    },
}

# experiments/conf/mnist.yaml:24-43 (class-conditional 28x28x1 digits,
# widths 128-512, 11 + 16 blocks: attention at 14x14 (n = 196, C 256) and
# 7x7 (n = 49, C 512), 4 heads; dropout 0.1, bf16 compute)
MNIST = {
    "embedding": {"fourier_dim": 64, "embedding_dim": 256, "num_classes": 10},
    "denoiser": {
        "in_channels": 1,
        "out_channels": 1,
        "sigma_data": 0.5,
        "embedding_dim": 256,
        "encoder_block_types": ["Enc", "Enc", "Enc", "EncD", "EncA", "EncA", "EncA", "EncD",
                                "EncA", "EncA", "EncA"],
        "decoder_block_types": ["DecA", "Dec", "DecA", "DecA", "DecA", "DecA", "DecU", "DecA",
                                "DecA", "DecA", "DecA", "DecU", "Dec", "Dec", "Dec", "Dec"],
        "encoder_out_channels": [128] * 4 + [256] * 4 + [512] * 3,
        "decoder_out_channels": [512] * 7 + [256] * 5 + [128] * 4,
        "skip_connections": [
            False, False, True, True, True, True,
            False, True, True, True, True,
            False, True, True, True, True,
        ],
        "dropout_rate": 0.1,
        "dtype": "bfloat16",
    },
}

# experiments/conf/imagenet.yaml:22-37 (ImageNet-64 latents: the ImageNet-512
# model without use_pallas_attention; the YAML leaves the topology to the
# Denoiser's defaults, as imagenet512.yaml does)
IMAGENET = {
    "embedding": dict(IMAGENET512["embedding"]),
    "denoiser": {k: v for k, v in IMAGENET512["denoiser"].items() if k != "use_pallas_attention"},
}

# experiments/conf/dit_xl2_512.yaml: DiT-XL/2 (Peebles & Xie 2022,
# facebookresearch/DiT models.py::DiT_XL_2) on the 64x64x4 SD-VAE latents of
# 512px images, 1024 tokens of patch 2, under EDM preconditioning (out_channels
# 4 where DiT's learned sigma doubles them); bf16 linears and attention,
# the flash-attention route at n = 1024
DIT_XL2_512 = {
    "classes": (DiTEmbedding, DiTDenoiser),
    "embedding": {"hidden_size": 1152, "num_classes": 1000, "frequency_dim": 256},
    "denoiser": {
        "input_size": 64,
        "in_channels": 4,
        "out_channels": 4,
        "patch_size": 2,
        "hidden_size": 1152,
        "depth": 28,
        "num_heads": 16,
        "mlp_ratio": 4.0,
        "sigma_data": 0.5,
        "dtype": "bfloat16",
    },
}

CONFIGS = {"cifar10": CIFAR10, "smoke": SMOKE, "imagenet512": IMAGENET512, "mnist": MNIST,
           "imagenet": IMAGENET, "dit_xl2_512": DIT_XL2_512}

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
    "scheduler_interval": "epoch",
    "use_ema": True,
    "ema_length": 0.13,
    "every_n_steps": 1,
}

# experiments/conf/imagenet512.yaml: the uncertainty-weighted loss, a
# per-step lr schedule, 4-way gradient accumulation and two tracked EMA
# profiles (ema_lengths replaces ema_length, as EDMSpec.build_ema_config does)
IMAGENET512_TRAINING = {
    "seed": 42,
    "batch_size": 128,
    "accumulate_grad_batches": 4,
    "diffuser": {"P_std": 1.0, "P_mean": -0.4},
    "use_uncertainty": True,
    "lr": 0.008,
    "steady_steps": 70000,
    "rampup_steps": 2000,
    "scheduler_interval": "step",
    "use_ema": True,
    "ema_length": 0.13,
    "ema_lengths": [0.05, 0.13],
    "every_n_steps": 1,
}

# experiments/conf/mnist.yaml: per-epoch schedule, no EMA
MNIST_TRAINING = {
    "seed": 42,
    "batch_size": 128,
    "accumulate_grad_batches": 1,
    "diffuser": {"P_std": 1.2, "P_mean": -1.2},
    "use_uncertainty": False,
    "lr": 0.01,
    "steady_steps": 500,
    "rampup_steps": 500,
    "scheduler_interval": "epoch",
    "use_ema": False,
    "ema_length": 0.1,
    "every_n_steps": 1,
}

# experiments/conf/imagenet.yaml: a per-step schedule and 3-way accumulation
# of datamodule batches of 176 (Lightning's accumulate_grad_batches: a step
# of 528 samples; the JAX step instead splits the batch it is given, and
# 176 does not split in 3)
IMAGENET_TRAINING = {
    "seed": 42,
    "batch_size": 176,
    "accumulate_grad_batches": 3,
    "diffuser": {"P_std": 1.0, "P_mean": -0.4},
    "use_uncertainty": False,
    "lr": 0.01,
    "steady_steps": 70000,
    "rampup_steps": 2000,
    "scheduler_interval": "step",
    "use_ema": True,
    "ema_length": 0.13,
    "every_n_steps": 1,
}

# experiments/conf/dit_xl2_512.yaml: DiT's train.py, AdamW at lr 1e-4 and
# weight decay 0 (Adam here), no lr schedule (steady past any run), a global
# batch of 256 (8 microbatches of 32 on one card; 32 a rank on 8), class
# dropout 0.1; DiT's constant EMA decay 0.9999 becomes one power profile
DIT_XL2_512_TRAINING = {
    "seed": 0,
    "batch_size": 256,
    "accumulate_grad_batches": 8,
    "diffuser": {"P_std": 1.0, "P_mean": -0.4},
    "use_uncertainty": False,
    "lr": 0.0001,
    "steady_steps": 7000000,
    "rampup_steps": 0,
    "scheduler_interval": "step",
    "label_dropout": 0.1,
    "use_ema": True,
    "ema_length": 0.05,
    "every_n_steps": 1,
}

TRAINING = {"cifar10": CIFAR10_TRAINING, "imagenet512": IMAGENET512_TRAINING,
            "mnist": MNIST_TRAINING, "imagenet": IMAGENET_TRAINING, "dit_xl2_512": DIT_XL2_512_TRAINING}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_model(
    name: str,
    device: Optional[str | torch.device] = None,
    dtype: Optional[torch.dtype] = None,
    *,
    fused: str = "auto",
    seed: int = 0,
    knobs: Optional[dict] = None,
) -> EDM:
    """The named config's EDM in eval mode on ``device`` (the card unless
    ``"cpu"`` is asked for), with weights drawn from ``seed``.

    ``dtype`` overrides the config's compute dtype and ``knobs`` adds
    Denoiser keywords (``remat``, ``remat_policy``, ``mod_fp32``,
    ``scan_blocks``). The config's dropout rate and ``use_pallas_attention``
    are built in; dropout runs only in a forward with ``train=True``. A DiT
    config takes no ``fused`` route and no knobs: its attention has one
    route."""
    dev = resolve_device(device)
    model = model_from_config(name, dtype, fused=fused, knobs=knobs)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def classes(name: str) -> tuple[type, type]:
    """The named config's embedding and denoiser classes: its ``classes``,
    else the U-Net's."""
    return CONFIGS[name].get("classes", (Embedding, Denoiser))


def model_from_config(name: str, dtype: Optional[torch.dtype] = None, *,
                      fused: str = "auto", knobs: Optional[dict] = None) -> EDM:
    """The named config's EDM with its parameters allocated but not drawn:
    under ``torch.device("meta")`` it allocates nothing, which is how a
    caller counts the parameters of a model too large to draw on the CPU."""
    cfg = CONFIGS[name]
    den_kwargs = dict(cfg["denoiser"])
    config_dtype = _DTYPES[den_kwargs.pop("dtype")]
    embedding_cls, denoiser_cls = classes(name)
    if denoiser_cls is not Denoiser:  # the DiT: one attention route, no U-Net knobs
        if knobs:
            raise ValueError(f"the {name} DiT takes no U-Net knobs, got {sorted(knobs)}")
        return EDM(embedding_cls(**cfg["embedding"]), denoiser_cls(**den_kwargs, dtype=dtype or config_dtype))
    use_uncertainty = TRAINING.get(name, {}).get("use_uncertainty", False)
    return EDM(
        Embedding(**cfg["embedding"]),
        Denoiser(**den_kwargs, **(knobs or {}), dtype=dtype or config_dtype, fused=fused),
        use_uncertainty=use_uncertainty,
    )


def build_training(
    name: str,
    device: Optional[str | torch.device] = None,
    dtype: Optional[torch.dtype] = None,
    *,
    fused: str = "auto",
    seed: int = 0,
    knobs: Optional[dict] = None,
) -> tuple[EDM, Diffuser, OptimizerConfig, Optional[EMAConfig], int, str]:
    """(model, diffuser, optimizer config, EMA config, batch size, schedule
    interval) of the named config's training recipe; the model as
    ``build_model`` makes it. The interval says what the lr schedule's count
    ticks with, which the caller passes to the train step: ``"epoch"`` or
    ``"step"``. The EMA tracks every profile of ``ema_lengths`` where the
    recipe gives them, else ``ema_length``."""
    t = TRAINING[name]
    model = build_model(name, device, dtype, fused=fused, seed=seed, knobs=knobs)
    opt_cfg = OptimizerConfig(
        lr=t["lr"],
        rampup_steps=t["rampup_steps"],
        steady_steps=t["steady_steps"],
        scheduler_interval=t["scheduler_interval"],
        accum_steps=t["accumulate_grad_batches"],
        label_dropout=t.get("label_dropout", 0.0),
    )
    ema_cfg = (
        EMAConfig(sigma_rels=tuple(t.get("ema_lengths") or (t["ema_length"],)),
                  every_n_steps=t["every_n_steps"])
        if t["use_ema"]
        else None
    )
    return (model, Diffuser(**t["diffuser"]), opt_cfg, ema_cfg, t["batch_size"],
            t["scheduler_interval"])
