"""Weighted MSE loss and its running metric, all in fp32.

Counterpart of ``tinyedm_tpu/diffusion/loss.py``; the differentiable batch
value is the training loss.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def weighted_sum_squared_error(
    weight: torch.Tensor, preds: torch.Tensor, target: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """sum_b mean_pixels(w_b * (pred_b - target_b)^2), and the batch count."""
    n = preds.shape[0]
    diff = preds.reshape(n, -1).float() - target.reshape(n, -1).float()
    per_sample = torch.mean(weight.reshape(n, 1).float() * diff * diff, dim=1)
    return per_sample.sum(), torch.tensor(float(n), device=preds.device)


def weighted_mse(weight: torch.Tensor, preds: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Batch-mean weighted MSE."""
    sse, n = weighted_sum_squared_error(weight, preds, target)
    return sse / n


@dataclasses.dataclass
class WeightedMeanSquaredError:
    """Running (sum of per-sample errors, sample count); ``update`` and
    ``merge`` accumulate, ``compute`` reads the mean."""

    sum_sse: torch.Tensor
    total: torch.Tensor

    @classmethod
    def create(cls, device: Optional[torch.device] = None) -> "WeightedMeanSquaredError":
        zero = torch.zeros((), dtype=torch.float32, device=device)
        return cls(zero, zero.clone())

    def update(
        self, weight: torch.Tensor, preds: torch.Tensor, target: torch.Tensor
    ) -> "WeightedMeanSquaredError":
        sse, n = weighted_sum_squared_error(weight, preds, target)
        return WeightedMeanSquaredError(self.sum_sse + sse, self.total + n)

    def merge(self, other: "WeightedMeanSquaredError") -> "WeightedMeanSquaredError":
        return WeightedMeanSquaredError(self.sum_sse + other.sum_sse, self.total + other.total)

    def compute(self) -> torch.Tensor:
        return self.sum_sse / torch.clamp(self.total, min=1.0)


def edm_training_loss(
    weight: torch.Tensor,
    denoised: torch.Tensor,
    clean: torch.Tensor,
    uncertainty: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """mse(lambda, D, x), or with uncertainty u: mse(lambda / exp(u), D, x) +
    mean(u). Returns (loss, metrics) with the raw (sse, count) pair."""
    metrics: dict[str, torch.Tensor] = {}
    if uncertainty is not None:
        u = uncertainty.float()
        sse, n = weighted_sum_squared_error(weight / torch.exp(u), denoised, clean)
        u_mean = torch.mean(u)
        loss = sse / n + u_mean
        metrics["uncertainty"] = u_mean
    else:
        sse, n = weighted_sum_squared_error(weight, denoised, clean)
        loss = sse / n
    metrics["sse"] = sse
    metrics["count"] = n
    return loss, metrics
