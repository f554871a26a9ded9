"""Structural typing for the pluggable pieces of an EDM.

Counterpart of ``tinyedm_tpu/diffusion/protocols.py``, over tensors and
with the port's calling conventions: a diffuser takes the clean image first
and an explicit ``torch.Generator`` second (``diffusion/diffuser.py``), and
modules own their weights. The Protocols are ``runtime_checkable``:
``isinstance`` checks that the members exist, not their signatures.

A model's conditioning is what ``EDM`` hands its embedding: class labels
(B,), or for a text-conditioned model a ``TextConditioning``, which the
train step slices into microbatches and drops out as it does labels, and
the solvers pass through to every forward.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Protocol, Union, runtime_checkable

import torch


@dataclasses.dataclass(frozen=True)
class TextConditioning:
    """A text-to-image model's conditioning, per sample: the text encoder's
    tokens ``txt`` (B, L, context_dim), the pooled text vector ``y`` (B,
    vec_dim) and the guidance value ``guidance`` (B,)."""

    txt: torch.Tensor
    y: torch.Tensor
    guidance: torch.Tensor

    def __getitem__(self, rows) -> "TextConditioning":
        return TextConditioning(self.txt[rows], self.y[rows], self.guidance[rows])

    def dropped(self, p: float, generator: Optional[torch.Generator] = None) -> "TextConditioning":
        """Caption dropout: each sample's tokens and pooled vector zeroed
        with probability ``p`` (one uniform draw a sample from
        ``generator``, as label dropout draws one a label)."""
        drop = torch.rand(self.guidance.shape, generator=generator, device=self.txt.device) < p
        keep = (~drop).to(self.txt.dtype)
        return TextConditioning(self.txt * keep[:, None, None], self.y * keep[:, None], self.guidance)


Conditioning = Union[torch.Tensor, TextConditioning]


def is_conditional(embedding) -> bool:
    """Whether an embedding (a module or its config's ``ModuleSpec``) reads a
    conditioning: a text-conditioned one (it has ``vec_in_dim``) always, a
    class embedding where it has classes (-1 is the unconditional sentinel)."""
    if getattr(embedding, "vec_in_dim", None) is not None:
        return True
    n = embedding.num_classes
    return n is not None and n != -1


@runtime_checkable
class EDMDiffuser(Protocol):
    """clean image + generator -> (noisy image, per-sample sigma)."""

    def __call__(
        self, clean_image: torch.Tensor, generator: Optional[torch.Generator]
    ) -> tuple[torch.Tensor, torch.Tensor]: ...


@runtime_checkable
class EDMEmbedding(Protocol):
    """sigma (+ optional conditioning) -> (fourier_embedding, embedding): the
    embedding a (B, C) tensor, or a text-conditioned model's pair (B, C)
    vector and text tokens, which its denoiser reads."""

    embedding_dim: int
    fourier_dim: int
    num_classes: Optional[int]


@runtime_checkable
class EDMDenoiser(Protocol):
    """noisy image + sigma + embedding -> denoised image."""

    sigma_data: float


@runtime_checkable
class EDMSolver(Protocol):
    """denoise_fn + noise (+ optional conditioning) -> final sample."""

    def solve(
        self,
        denoise_fn: Callable[[torch.Tensor, torch.Tensor, Optional[Conditioning]], torch.Tensor],
        x0: torch.Tensor,
        class_labels: Optional[Conditioning] = None,
    ) -> torch.Tensor: ...
