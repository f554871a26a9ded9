"""Top-level EDM model: embedding + denoiser (+ optional uncertainty head).

Counterpart of ``tinyedm_tpu/models/edm.py``: ``forward`` is
``EDM.__call__``, the function the ODE solver drives, and
``denoise_with_aux`` the training forward, which also returns the
uncertainty head's output.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tinyedm_tpu_torch.models.layers import Embedding, UncertaintyNet
from tinyedm_tpu_torch.models.unet import Denoiser


class EDM(nn.Module):
    def __init__(self, embedding: Embedding, denoiser: Denoiser, use_uncertainty: bool = False):
        super().__init__()
        self.embedding = embedding
        self.denoiser = denoiser
        # the reference's UncertaintyNet(fourier_dim, fourier_dim)
        self.u = (
            UncertaintyNet(embedding.fourier_dim, embedding.fourier_dim)
            if use_uncertainty
            else None
        )

    @property
    def conditional(self) -> bool:
        # -1 is the Embedding's unconditional sentinel
        n = self.embedding.num_classes
        return n is not None and n != -1

    @property
    def sigma_data(self) -> float:
        return self.denoiser.sigma_data

    def forward(
        self,
        noisy_image: torch.Tensor,
        sigma: torch.Tensor,
        class_labels: Optional[torch.Tensor] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """noisy_image (B, C, H, W), sigma (B,) -> denoised (B, C, H, W) fp32."""
        if not self.conditional:
            class_labels = None
        _, emb = self.embedding(sigma, class_labels)
        return self.denoiser(noisy_image, sigma, emb, train, generator)

    def denoise_with_aux(
        self,
        noisy_image: torch.Tensor,
        sigma: torch.Tensor,
        class_labels: Optional[torch.Tensor] = None,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Training forward: (denoised, uncertainty (B,) or None). ``train``
        turns dropout on, with bits from ``generator``."""
        if not self.conditional:
            class_labels = None
        fourier, emb = self.embedding(sigma, class_labels)
        denoised = self.denoiser(noisy_image, sigma, emb, train, generator)
        uncertainty = self.u(fourier).reshape(-1) if self.u is not None else None
        return denoised, uncertainty


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialization of every module that owns parameters or
    buffers, in module order: weights N(0, 1), block gains 1, ``gain_out``
    and the uncertainty gain 0, Fourier frequencies 2*pi*N(0, 1) and phases
    2*pi*U(0, 1)."""
    for module in model.modules():
        reset = getattr(module, "reset_parameters", None)
        if reset is not None:
            reset(generator)
    return model
