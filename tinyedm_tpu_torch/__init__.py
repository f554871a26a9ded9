"""tinyedm_tpu_torch: the PyTorch + CUDA port of tinyedm_tpu for NVIDIA Hopper.

This slice runs CIFAR-10 Heun sampling end to end: the EDM2 U-Net forward
(``models``), the Heun solver (``diffusion.solver``) and the generation CLI
(``generate``), with the fused cosine-attention forward as a hand-written
CUDA kernel (``csrc/cosine_attention_fwd.cu``, built on first use). Entry
points run on the card unless ``device="cpu"`` is asked for.
"""

from tinyedm_tpu_torch.configs import CONFIGS, build_model
from tinyedm_tpu_torch.diffusion.solver import DeterministicSolver, karras_sigma_schedule
from tinyedm_tpu_torch.models.edm import EDM
from tinyedm_tpu_torch.models.unet import Denoiser
from tinyedm_tpu_torch.ops.fused_attention import cosine_attention_qkv
