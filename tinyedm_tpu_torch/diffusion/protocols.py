"""Structural typing for the pluggable pieces of an EDM.

Counterpart of ``tinyedm_tpu/diffusion/protocols.py``, over tensors and
with the port's calling conventions: a diffuser takes the clean image first
and an explicit ``torch.Generator`` second (``diffusion/diffuser.py``), and
modules own their weights. The Protocols are ``runtime_checkable``:
``isinstance`` checks that the members exist, not their signatures.
"""

from __future__ import annotations

from typing import Callable, Optional, Protocol, runtime_checkable

import torch


@runtime_checkable
class EDMDiffuser(Protocol):
    """clean image + generator -> (noisy image, per-sample sigma)."""

    def __call__(
        self, clean_image: torch.Tensor, generator: Optional[torch.Generator]
    ) -> tuple[torch.Tensor, torch.Tensor]: ...


@runtime_checkable
class EDMEmbedding(Protocol):
    """sigma (+ optional class labels) -> (fourier_embedding, embedding)."""

    embedding_dim: int
    fourier_dim: int
    num_classes: Optional[int]


@runtime_checkable
class EDMDenoiser(Protocol):
    """noisy image + sigma + embedding -> denoised image."""

    sigma_data: float


@runtime_checkable
class EDMSolver(Protocol):
    """denoise_fn + noise (+ optional labels) -> final sample."""

    def solve(
        self,
        denoise_fn: Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]], torch.Tensor],
        x0: torch.Tensor,
        class_labels: Optional[torch.Tensor] = None,
    ) -> torch.Tensor: ...
