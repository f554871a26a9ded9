"""tinyedm_tpu_torch: the PyTorch + CUDA port of tinyedm_tpu for NVIDIA Hopper.

It runs CIFAR-10 Heun sampling end to end (the EDM2 U-Net in ``models``,
the Heun solver in ``diffusion.solver``, the generation CLI ``generate``) and
the CIFAR-10 training step (``training.train_step``, the recipe from
``configs.build_training``), with the fused cosine attention as hand-written
CUDA kernels, forward and backward (``csrc/cosine_attention_{fwd,bwd}.cu``,
built on first use). Entry points run on the card unless ``device="cpu"`` is
asked for.
"""

from tinyedm_tpu_torch.configs import CONFIGS, build_model, build_training
from tinyedm_tpu_torch.diffusion.solver import DeterministicSolver, karras_sigma_schedule
from tinyedm_tpu_torch.models.edm import EDM
from tinyedm_tpu_torch.models.unet import Denoiser
from tinyedm_tpu_torch.ops.fused_attention import cosine_attention_qkv
