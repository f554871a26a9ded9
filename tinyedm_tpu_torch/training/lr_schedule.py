"""LR schedule: linear rampup -> steady -> inverse-sqrt decay.

Counterpart of ``tinyedm_tpu/training/lr_schedule.py``, in fp32. ``count``
is the scheduler tick: epochs or optimizer steps. At count 0 with a rampup
the multiplier is 1e-8.
"""

from __future__ import annotations

import torch


def edm_lr_multiplier(count, rampup_steps: int, steady_steps: int) -> torch.Tensor:
    """The schedule's multiplier at ``count``, a float32 tensor of count's shape."""
    count = torch.as_tensor(count, dtype=torch.float32)
    rampup = float(max(rampup_steps, 1))
    steady = float(max(steady_steps, 1))
    ramp = 1e-8 + (1.0 - 1e-8) * count / rampup
    decay = 1.0 / torch.sqrt(1.0 + (count - rampup_steps - steady_steps) / steady)
    out = torch.where(count < rampup_steps, ramp, torch.ones_like(count))
    return torch.where(count < rampup_steps + steady_steps, out, decay)


def make_lr_fn(lr: float, rampup_steps: int, steady_steps: int):
    """count -> learning rate (float32 tensor)."""

    def fn(count) -> torch.Tensor:
        return lr * edm_lr_multiplier(count, rampup_steps, steady_steps)

    return fn
