"""Classifier-free guidance, autoguidance and limited-interval guidance.

Counterpart of ``tinyedm_tpu/diffusion/guidance.py``. A conditional model's
unconditional forward is the same model with the null label ``-1``, which
the class embedding maps to its zero row (``jax.nn.one_hot`` semantics), so
guidance needs no second set of weights:

    D_guided(x, sigma) = D_uncond + scale * (D_cond - D_uncond)

CFG runs both branches as one stacked forward of batch 2B. Autoguidance
(Karras et al. 2024) guides with a second, weaker model instead:
``D_guide + scale * (D_main - D_guide)``, two forwards. Label dropout
(``drop_labels``) trains the null branch.

Limited-interval guidance (Kynkaanniemi et al. 2024) guides only while
``lo < sigma <= hi``. The solvers know every half-step's sigma on the host
and ask an ``IntervalGate`` for its branch with it, so outside the interval
the guide forward does not run and no step reads the card to decide.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from tinyedm_tpu_torch.diffusion.protocols import Conditioning, TextConditioning

NULL_LABEL = -1  # the class embedding's zero row: EDM2's unconditional form

DenoiseFn = Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]], torch.Tensor]
Interval = Optional[Tuple[float, float]]


class IntervalGate:
    """``guided_fn`` while ``lo < sigma <= hi``, ``plain_fn`` elsewhere.

    ``branch(sigma)`` picks on a host value (the solvers' way); calling the
    gate picks on ``sigma[0]``, which waits for the card when sigma lives
    there. Inside a solver step every row shares one sigma. The bounds are
    rounded to fp32, as the JAX gate compares the fp32 sigma with them."""

    def __init__(self, plain_fn: DenoiseFn, guided_fn: DenoiseFn, interval: Tuple[float, float]):
        self.plain_fn = plain_fn
        self.guided_fn = guided_fn
        self.lo, self.hi = (float(np.float32(v)) for v in interval)

    def branch(self, sigma: float) -> DenoiseFn:
        return self.guided_fn if self.lo < sigma <= self.hi else self.plain_fn

    def __call__(self, x: torch.Tensor, sigma: torch.Tensor, labels: Optional[torch.Tensor]) -> torch.Tensor:
        return self.branch(float(sigma.reshape(-1)[0]))(x, sigma, labels)


def _interval_gate(plain_fn: DenoiseFn, guided_fn: DenoiseFn, interval: Interval) -> DenoiseFn:
    return guided_fn if interval is None else IntervalGate(plain_fn, guided_fn, interval)


def cfg_denoise_fn(denoise_fn: DenoiseFn, guidance_scale: float, interval: Interval = None) -> DenoiseFn:
    """``denoise_fn(x, sigma, labels)`` with classifier-free guidance: the
    conditional and null-label branches in one stacked forward, combined.
    Scale 1 is the conditional model, 0 the unconditional one. Labels are
    required. ``interval=(lo, hi)``: guided only while ``lo < sigma <= hi``,
    the plain conditional forward elsewhere."""
    scale = float(guidance_scale)

    def guided(x: torch.Tensor, sigma: torch.Tensor, labels: Optional[torch.Tensor]) -> torch.Tensor:
        if labels is None:
            raise ValueError(
                "classifier-free guidance needs class labels; "
                "the model has nothing to guide toward without them"
            )
        labels2 = torch.cat([labels, torch.full_like(labels, NULL_LABEL)])
        d = denoise_fn(torch.cat([x, x]), torch.cat([sigma, sigma]), labels2)
        d_cond, d_uncond = d.chunk(2)
        return d_uncond + scale * (d_cond - d_uncond)

    return _interval_gate(denoise_fn, guided, interval)


def autoguidance_denoise_fn(
    main_fn: DenoiseFn, guide_fn: DenoiseFn, guidance_scale: float, interval: Interval = None
) -> DenoiseFn:
    """Autoguidance: ``D_guide + scale * (D_main - D_guide)``, two forwards
    (the models have different weights), for conditional and unconditional
    models alike. Scale 1 is the main model up to one rounding.
    ``interval``: the main model alone outside ``lo < sigma <= hi``."""
    scale = float(guidance_scale)

    def guided(x: torch.Tensor, sigma: torch.Tensor, labels: Optional[torch.Tensor]) -> torch.Tensor:
        d_main = main_fn(x, sigma, labels)
        d_guide = guide_fn(x, sigma, labels)
        return d_guide + scale * (d_main - d_guide)

    return _interval_gate(main_fn, guided, interval)


def drop_labels(labels: Conditioning, p: float, generator: Optional[torch.Generator] = None) -> Conditioning:
    """Label dropout for CFG training: each label becomes ``NULL_LABEL`` with
    probability ``p`` (one uniform draw per label from ``generator``). A
    ``TextConditioning`` drops its captions instead (``dropped``)."""
    if isinstance(labels, TextConditioning):
        return labels.dropped(p, generator)
    drop = torch.rand(labels.shape, generator=generator, device=labels.device) < p
    return torch.where(drop, torch.full_like(labels, NULL_LABEL), labels)
