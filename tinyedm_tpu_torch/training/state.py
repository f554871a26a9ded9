"""Train state and the forced weight normalization.

Counterpart of ``tinyedm_tpu/training/state.py``. Where the JAX package
threads an immutable pytree through a pure step, the port's step updates the
state in place (no second copy of params and moments): ``params`` are the
model's own ``nn.Parameter`` objects, by name, so the model always runs with
the state's weights.
"""

from __future__ import annotations

import dataclasses

import torch

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


def is_weight_normed(name: str, tensor: torch.Tensor) -> bool:
    """The stored weights of the WN layers: every ``weight`` parameter of the
    port (WNConv OIHW, WNLinear (out, in)); gains are named ``gain``/``gain_out``
    and the Fourier constants are buffers."""
    return name.rsplit(".", 1)[-1] == "weight" and tensor.ndim in (2, 4)


@torch.no_grad()
def force_weight_norm(params: dict[str, torch.Tensor]) -> None:
    """Re-normalize, in place, every stored weight-normed weight to unit
    per-output RMS (``normalize(normalize(w)) == normalize(w)`` up to the eps
    offset), as the reference does on each training forward."""
    for name, p in params.items():
        if is_weight_normed(name, p):
            p.copy_(weight_normalize(p))
