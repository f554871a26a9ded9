"""Power-function EMA (Karras et al. 2023).

Counterpart of the tracking half of ``tinyedm_tpu/training/ema.py``:
  * sigma_rel -> gamma by the max real root of
    g^3 + 7g^2 + (16 - sr^-2) g + (12 - sr^-2) = 0
  * decay_t = (1 - 1/(t+1))^(gamma+1), in fp32
  * ema <- decay * ema + (1 - decay) * theta
  * updated every ``every_n_steps``, checked on the pre-increment step, so
    step 0 gives decay 0 and the EMA starts at theta.
EMA trees are dicts of tensors, updated in place.

Post-hoc reconstruction (EDM2, Algorithm 3): ``solve_posthoc_weights`` finds
the least-squares weights of stored EMA snapshots for the profile of any
target ``sigma_rel``, in numpy fp64 (snapshots close in step and gamma make
the Gram matrix nearly singular, so the solve never runs in fp32), and
``reconstruct_posthoc_ema`` combines the snapshot trees with them in fp32 on
the trees' own device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

MAX_SIGMA_REL = 0.2886  # the reference's validation bound


def sigma_rel_to_gamma(sigma_rel: float) -> float:
    """Max real root of the cubic relating sigma_rel to the power-EMA exponent."""
    if not (0.0 < sigma_rel <= MAX_SIGMA_REL):
        raise ValueError(
            f"EMA length (sigma_rel) must be within (0, {MAX_SIGMA_REL}], got {sigma_rel}"
        )
    t = sigma_rel**-2
    roots = np.roots([1.0, 7.0, 16.0 - t, 12.0 - t])
    return float(roots.real.max())


def gamma_to_sigma_rel(gamma: float) -> float:
    """Inverse of sigma_rel_to_gamma: t = (g^3 + 7g^2 + 16g + 12) / (g + 1)."""
    g = float(gamma)
    t = (g**3 + 7 * g**2 + 16 * g + 12) / (g + 1)
    return float(1.0 / np.sqrt(t))


def power_ema_decay(step: int, gamma: float) -> float:
    """decay = (1 - 1/(step+1))^(gamma+1) in fp32; step is the pre-increment counter."""
    one = np.float32(1.0)
    s = np.float32(step)
    return float((one - one / (s + one)) ** (np.float32(gamma) + one))


@torch.no_grad()
def ema_update(ema_params: dict[str, torch.Tensor], params: dict[str, torch.Tensor],
               decay: float) -> None:
    """ema <- ema * decay + params * (1 - decay), in place, (1 - decay) in fp32."""
    keys = list(ema_params)
    ema = [ema_params[k] for k in keys]
    one_minus = float(np.float32(1.0) - np.float32(decay))
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, torch._foreach_mul([params[k].to(ema_params[k].dtype) for k in keys],
                                                one_minus))


def maybe_ema_update(ema_params: dict[str, torch.Tensor], params: dict[str, torch.Tensor],
                     step: int, gamma: float, every_n_steps: int = 1) -> None:
    """The power-EMA update when ``step % every_n_steps == 0``, else nothing."""
    if every_n_steps <= 1 or step % every_n_steps == 0:
        ema_update(ema_params, params, power_ema_decay(step, gamma))


@dataclasses.dataclass(frozen=True)
class EMAConfig:
    """One or more tracked EMA profiles."""

    sigma_rels: tuple[float, ...] = (0.13,)
    every_n_steps: int = 1

    @property
    def gammas(self) -> tuple[float, ...]:
        return tuple(sigma_rel_to_gamma(sr) for sr in self.sigma_rels)


def _p_dot_p(t_a, gamma_a, t_b, gamma_b):
    """Inner product <p_a, p_b> of two power-EMA response profiles."""
    t_ratio = t_a / t_b
    t_exp = np.where(t_a < t_b, gamma_b, -gamma_a)
    t_max = np.maximum(t_a, t_b)
    num = (gamma_a + 1) * (gamma_b + 1) * t_ratio**t_exp
    den = (gamma_a + gamma_b + 1) * t_max
    return num / den


def solve_posthoc_weights(
    snapshot_steps: Sequence[int],
    snapshot_gammas: Sequence[float],
    target_step: int,
    target_gamma: float,
) -> np.ndarray:
    """Least-squares weights w_i such that sum_i w_i * ema_i approximates the
    EMA of exponent ``target_gamma`` at ``target_step``; snapshot i is the
    EMA of exponent ``snapshot_gammas[i]`` at ``snapshot_steps[i]``. Time is
    1-indexed: pass step + 1."""
    t_i = np.asarray(snapshot_steps, np.float64).reshape(-1, 1)
    g_i = np.asarray(snapshot_gammas, np.float64).reshape(-1, 1)
    t_r = np.asarray([target_step], np.float64).reshape(1, -1)
    g_r = np.asarray([target_gamma], np.float64).reshape(1, -1)
    a = _p_dot_p(t_i, g_i, t_i.T, g_i.T)
    b = _p_dot_p(t_i, g_i, t_r, g_r)
    return np.linalg.solve(a, b).reshape(-1)


@torch.no_grad()
def reconstruct_posthoc_ema(
    snapshots: Sequence[dict[str, torch.Tensor]],
    snapshot_steps: Sequence[int],
    snapshot_gammas: Sequence[float],
    target_sigma_rel: float,
    target_step: Optional[int] = None,
) -> dict[str, torch.Tensor]:
    """The EMA tree that a run tracking ``target_sigma_rel`` would hold at
    ``target_step`` (the latest snapshot's by default), combined from the
    snapshot trees (dicts of tensors, any device) in fp32."""
    if target_step is None:
        target_step = max(snapshot_steps)
    w = solve_posthoc_weights(
        [s + 1 for s in snapshot_steps],
        snapshot_gammas,
        target_step + 1,
        sigma_rel_to_gamma(target_sigma_rel),
    )
    out = {k: v.float() * float(w[0]) for k, v in snapshots[0].items()}
    for wi, snap in zip(w[1:], snapshots[1:]):
        for k, o in out.items():
            o.add_(snap[k].float(), alpha=float(wi))
    return out
