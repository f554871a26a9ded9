"""tinyedm_tpu_torch: the PyTorch + CUDA port of tinyedm_tpu for NVIDIA Hopper.

It samples (the EDM2 U-Net in ``models``; Heun, DPM-Solver++(2M) and churn
in ``diffusion.solver``; classifier-free guidance and autoguidance in
``diffusion.guidance``; the generation CLI ``generate``) and trains
(``training.train_step``, the recipes of ``configs.build_training``: CIFAR-10,
MNIST, ImageNet-64 and ImageNet-512 latents), with every attention kernel of
the JAX package as hand-written CUDA (``csrc/``, built on first use). The
run loop reads ``experiments/conf/*.yaml`` (``config``), feeds the data
modules (``data``) to the ``training.trainer.Trainer`` (validation,
checkpoints, previews, resume) behind the CLI ``train``; ``generate
--ckpt_path`` samples what it saved. EDM2's ImageNet-512 workflow: latents
packed into one store (``data.latpack``), post-hoc EMA reconstruction
(``posthoc_ema``) and FID/KID with an InceptionV3 in PyTorch (``eval_fid``,
``utils.fid``, ``utils.inception``, ``training.callbacks.FIDCallback``).
Entry points run on the card unless ``device="cpu"`` is asked for.

The reference API (the names of ``tinyedm_tpu.__all__``, ``Linear`` and
``Conv2d`` the weight-normed layers, ``PreditionWriter`` in the reference's
spelling) imports from here, as do the Protocols of ``diffusion.protocols``.
Learning-level checks: ``validate_learning`` and ``soak``.
"""

from tinyedm_tpu_torch.configs import CONFIGS, build_model, build_training
from tinyedm_tpu_torch.diffusion.diffuser import Diffuser
from tinyedm_tpu_torch.diffusion.loss import WeightedMeanSquaredError
from tinyedm_tpu_torch.diffusion.protocols import EDMDenoiser, EDMDiffuser, EDMEmbedding, EDMSolver
from tinyedm_tpu_torch.diffusion.solver import (
    DeterministicSolver,
    MultistepSolver,
    StochasticSolver,
    karras_sigma_schedule,
)
from tinyedm_tpu_torch.models.edm import EDM
from tinyedm_tpu_torch.models.layers import (
    ClassEmbedding,
    CosineAttention,
    Embedding,
    FourierEmbedding,
    ScaleLong,
    UncertaintyNet,
    WNConv,
    WNLinear,
)
from tinyedm_tpu_torch.models.unet import Denoiser, DenoiserWrapper
from tinyedm_tpu_torch.ops.fused_attention import cosine_attention_qkv
from tinyedm_tpu_torch.training.callbacks import (
    GenerateCallback,
    LatentsGenerateCallback,
    PreditionWriter,
)

# the reference API's aliases
Linear = WNLinear
Conv2d = WNConv

__all__ = [
    # the reference API (tinyedm_tpu.__all__)
    "EDM",
    "Diffuser",
    "GenerateCallback",
    "PreditionWriter",
    "LatentsGenerateCallback",
    "DeterministicSolver",
    "StochasticSolver",
    "WeightedMeanSquaredError",
    "Denoiser",
    "DenoiserWrapper",
    "Linear",
    "Conv2d",
    "WNLinear",
    "WNConv",
    "Embedding",
    "FourierEmbedding",
    "ClassEmbedding",
    "CosineAttention",
    "ScaleLong",
    "UncertaintyNet",
    # the port's own
    "CONFIGS",
    "build_model",
    "build_training",
    "MultistepSolver",
    "karras_sigma_schedule",
    "cosine_attention_qkv",
    "EDMDiffuser",
    "EDMEmbedding",
    "EDMDenoiser",
    "EDMSolver",
]

__version__ = "0.1.0"
