"""Train state and the forced weight normalization.

Counterpart of ``tinyedm_tpu/training/state.py``. Where the JAX package
threads an immutable pytree through a pure step, the port's step updates the
state in place (no second copy of params and moments): ``params`` are the
model's own ``nn.Parameter`` objects, by name, so the model always runs with
the state's weights.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch
from torch import nn

from tinyedm_tpu_torch.ops.mp import weight_normalize


@dataclasses.dataclass
class TrainState:
    step: int  # optimizer steps taken
    params: dict[str, torch.Tensor]  # trainable, by state_dict name
    constants: dict[str, torch.Tensor]  # non-trainable (Fourier freqs and phases)
    mu: dict[str, torch.Tensor]  # Adam first moments, like params
    nu: dict[str, torch.Tensor]  # Adam second moments
    count: int  # Adam's own step count (optax ScaleByAdamState.count)
    ema: tuple[dict[str, torch.Tensor], ...]  # one tree per tracked sigma_rel


def is_weight_normed(module: nn.Module) -> bool:
    """Whether ``module`` is a WN layer (``WNConv``, ``WNLinear``): its
    stored ``weight`` is normalized. A plain layer, such as a DiT linear, is
    not, whatever its weight is named."""
    from tinyedm_tpu_torch.models.layers import _WeightNormed

    return isinstance(module, _WeightNormed)


def weight_normed_names(model: nn.Module) -> tuple[str, ...]:
    """The state-dict names of the WN layers' stored weights in ``model``
    (WNConv OIHW, WNLinear (out, in)), in module order."""
    return tuple(f"{name}.weight".lstrip(".") for name, m in model.named_modules() if is_weight_normed(m))


@torch.no_grad()
def force_weight_norm(params: dict[str, torch.Tensor], names: Iterable[str]) -> None:
    """Re-normalize, in place, the stored weights ``names`` of ``params``
    (``weight_normed_names``) to unit per-output RMS
    (``normalize(normalize(w)) == normalize(w)`` up to the eps offset), as
    the reference does on each training forward."""
    for name in names:
        params[name].copy_(weight_normalize(params[name]))
