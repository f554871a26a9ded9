"""The plain reference of the EDM2 training step: the EDM loss (with
EDM2's uncertainty weighting where the configuration asks for it) over
microbatches, Adam, the forced weight normalization and the power-function
EMA profiles, in fp32 PyTorch from the papers' equations.

``train`` runs the first steps from the raw weights and the batches the
harness drew, drawing each step's randomness from a generator seeded as the
harness seeded the program's, and returns what ``correct`` compares: each
step's loss, each leaf's first gradient and each leaf's change and EMA
change after the steps.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from edmbench.reference.model import denoise, is_constant, normalize_weight
from edmbench.reference.precision import FP32, Precision


@dataclasses.dataclass
class Readings:
    sse: list[float]  # each step's summed per-sample weighted error
    grad_norms: dict[str, float]  # the first step's gradient, by leaf
    change_norms: dict[str, float]  # |p_n - p_0| after the steps
    ema_change_norms: list[dict[str, float]]  # |ema_n - p_0| by profile


def ema_gamma(sigma_rel: float) -> float:
    """The power-EMA exponent of a relative length: the largest real root of
    g^3 + 7 g^2 + (16 - sr^-2) g + (12 - sr^-2) (EDM2, eq. 3)."""
    t = sigma_rel ** -2
    return float(np.roots([1.0, 7.0, 16.0 - t, 12.0 - t]).real.max())


def ema_decay(step: int, gamma: float) -> float:
    """(1 - 1/(t + 1))^(gamma + 1) at the step count t before the update, in fp32."""
    one, t = np.float32(1.0), np.float32(step)
    return float((one - one / (t + one)) ** (np.float32(gamma) + one))


def loss_fn(P: dict, cfg: dict, images: torch.Tensor, labels: Optional[torch.Tensor],
            gen: torch.Generator, prec: Precision,
            keep: Optional[int] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The EDM loss of one microbatch and its summed per-sample error:
    ln sigma ~ N(P_mean, P_std), noise of that sigma, lambda(sigma) =
    (sigma^2 + sd^2) / (sigma sd)^2, each sample's mean of lambda (D - x)^2,
    averaged over the batch; with the uncertainty head, lambda / e^u and
    mean(u) added. ``keep`` takes the first ``keep`` samples only (the fault
    of half the batch left out, for the check's control readings)."""
    t = cfg["training"]["diffuser"]
    b = images.shape[0]
    eps = torch.randn((b,), generator=gen, device=images.device)
    noise = torch.randn(images.shape, generator=gen, device=images.device)
    sigma = torch.exp(t["P_mean"] + eps * t["P_std"])
    noisy = images + noise * sigma.reshape(-1, 1, 1, 1)
    denoised, u = denoise(P, cfg, noisy, sigma, labels, gen, prec)
    sd = cfg["denoiser"]["sigma_data"]
    weight = (sigma ** 2 + sd ** 2) / (sigma * sd) ** 2
    if u is not None:
        weight = weight / torch.exp(u)
    per_sample = (weight.reshape(b, 1) * (denoised - images).reshape(b, -1) ** 2).mean(dim=1)
    rows = slice(0, keep or b)
    loss = per_sample[rows].mean()
    sse = per_sample[rows].sum().detach()
    return (loss + u[rows].mean() if u is not None else loss), sse


def train(cfg: dict, weights: dict[str, torch.Tensor], batches: list, gen_seeds: list[int],
          steps: int, prec: Precision = FP32, half_batch: bool = False) -> Readings:
    """``steps`` training steps from ``weights`` (raw, as drawn) on
    ``batches`` ((images NCHW, labels or None) on the card), step ``i``
    drawing from a generator seeded with ``gen_seeds[i]``."""
    t = cfg["training"]
    device = batches[0][0].device
    P = {k: v.detach().float().clone() for k, v in weights.items()}
    names = [k for k in P if not is_constant(k)]
    with torch.no_grad():
        for k in names:
            if P[k].ndim in (2, 4):
                P[k] = normalize_weight(P[k])
    p0 = {k: P[k].clone() for k in names}
    mu = {k: torch.zeros_like(P[k]) for k in names}
    nu = {k: torch.zeros_like(P[k]) for k in names}
    gammas = [ema_gamma(s) for s in t["ema_lengths"]]
    emas = [{k: P[k].clone() for k in names} for _ in gammas]
    b1, b2 = t["betas"]
    lr = float(np.float32(t["lr"]))
    accum = t["accum_steps"]
    losses, first_grads = [], None
    for step in range(steps):
        images, labels = batches[step]
        gen = torch.Generator(device=device).manual_seed(gen_seeds[step])
        m = images.shape[0] // accum
        grads = {k: torch.zeros_like(P[k]) for k in names}
        total = 0.0
        for i in range(accum):
            rows = slice(i * m, (i + 1) * m)
            leaves = {k: P[k].requires_grad_(True) for k in names}
            loss, sse = loss_fn(P, cfg, images[rows], None if labels is None else labels[rows], gen, prec,
                                keep=m // 2 if half_batch else None)
            g = torch.autograd.grad(loss, [leaves[k] for k in names])
            for k, gk in zip(names, g):
                grads[k] += gk
            total += sse.item()
            for k in names:
                P[k] = P[k].detach()
        losses.append(total)
        with torch.no_grad():
            count = step + 1
            bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
            bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
            for k in names:
                g = grads[k] / accum
                mu[k] = b1 * mu[k] + (1 - b1) * g
                nu[k] = b2 * nu[k] + (1 - b2) * g * g
                P[k] = P[k] - lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + t["eps"])
                if P[k].ndim in (2, 4):
                    P[k] = normalize_weight(P[k])
            if first_grads is None:
                first_grads = {k: float(torch.linalg.vector_norm(grads[k] / accum)) for k in names}
            for ema, gamma in zip(emas, gammas):
                decay = ema_decay(step, gamma)
                for k in names:
                    ema[k] = ema[k] * decay + P[k] * float(np.float32(1) - np.float32(decay))
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(P[k] - p0[k])) for k in names}
        ema_change = [{k: float(torch.linalg.vector_norm(e[k] - p0[k])) for k in names} for e in emas]
    return Readings(losses, first_grads, change, ema_change)
