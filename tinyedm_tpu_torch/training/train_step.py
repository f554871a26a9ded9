"""The EDM train step.

Counterpart of ``tinyedm_tpu/training/train_step.py``: diffuse -> U-Net
forward and backward in the compute dtype with fp32 islands -> fp32 weighted
MSE -> Adam -> forced weight norm -> power-EMA update(s). The state is
updated in place (``training/state.py``); randomness (diffuser draws, then
dropout bits block by block) comes from one explicit generator.

Not ported yet (ROADMAP.md): ``label_dropout`` (CFG training),
``log_norms_per_layer`` and ``make_eval_step``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from tinyedm_tpu_torch.diffusion.diffuser import Diffuser
from tinyedm_tpu_torch.diffusion.loss import edm_training_loss
from tinyedm_tpu_torch.models.edm import EDM
from tinyedm_tpu_torch.ops.precond import edm_loss_weight
from tinyedm_tpu_torch.training.ema import EMAConfig, maybe_ema_update
from tinyedm_tpu_torch.training.lr_schedule import edm_lr_multiplier
from tinyedm_tpu_torch.training.state import TrainState, force_weight_norm


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 1e-4
    betas: tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8  # torch.optim.Adam's default
    rampup_steps: int = 0
    steady_steps: int = 1
    accum_steps: int = 1  # gradient accumulation microbatches
    log_norms: bool = False  # global pre-clip grad norm and param norm as metrics
    log_norms_per_layer: bool = False  # not ported yet
    grad_clip_norm: Optional[float] = None  # global-norm clipping; None = off
    label_dropout: float = 0.0  # not ported yet


def init_train_state(
    model: EDM, opt_cfg: OptimizerConfig, ema_cfg: Optional[EMAConfig] = None
) -> TrainState:
    """State over the model's own parameters, force-normalized in place as
    the JAX package does at init; zero Adam moments; EMA trees copied from
    the normalized weights."""
    del opt_cfg  # Adam's state does not depend on its settings
    params = dict(model.named_parameters())
    force_weight_norm(params)
    n_ema = len(ema_cfg.sigma_rels) if ema_cfg is not None else 0
    with torch.no_grad():
        return TrainState(
            step=0,
            params=params,
            constants=dict(model.named_buffers()),
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()},
            count=0,
            ema=tuple({k: p.detach().clone() for k, p in params.items()} for _ in range(n_ema)),
        )


@torch.no_grad()
def adam_update(state: TrainState, grads: list[torch.Tensor], betas: tuple[float, float],
                eps: float, lr: float) -> None:
    """optax ``scale_by_adam`` then ``-lr * update`` added to the params, in
    place: mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu, bias-corrected by
    fp32 ``1 - b**count``, update = mu^ / (sqrt(nu^) + eps)."""
    b1, b2 = betas
    keys = list(state.params)
    params = [state.params[k] for k in keys]
    mu = [state.mu[k] for k in keys]
    nu = [state.nu[k] for k in keys]
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
    state.count += 1
    one, c = np.float32(1.0), np.float32(state.count)
    bc1 = float(one - np.float32(b1) ** c)
    bc2 = float(one - np.float32(b2) ** c)
    denom = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    update = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
    torch._foreach_mul_(update, -lr)
    torch._foreach_add_(params, update)


@torch.no_grad()
def _global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


def make_grad_fn(model: EDM, diffuser: Diffuser, opt_cfg: OptimizerConfig) -> Callable:
    """grad_fn(state, images, labels, generator) -> (loss, metrics, grads):
    the step's loss and fp32 gradients in ``state.params`` order, averaged
    over ``opt_cfg.accum_steps`` microbatches."""
    if opt_cfg.label_dropout > 0.0:
        raise NotImplementedError("label_dropout is not ported yet; see ROADMAP.md")
    sigma_data = model.sigma_data
    conditional = model.conditional

    def loss_fn(images, labels, generator):
        noisy, sigma = diffuser(images, generator)
        denoised, uncertainty = model.denoise_with_aux(
            noisy, sigma, labels if conditional else None, train=True, generator=generator
        )
        weight = edm_loss_weight(sigma, sigma_data)
        return edm_training_loss(weight, denoised, images, uncertainty)

    def grad_fn(state: TrainState, images, labels, generator):
        params = list(state.params.values())
        a = opt_cfg.accum_steps
        loss = grads = metrics = None
        for i in range(a):
            mb = slice(i * images.shape[0] // a, (i + 1) * images.shape[0] // a)
            mloss, mmetrics = loss_fn(images[mb], labels[mb] if labels is not None else None,
                                      generator)
            mgrads = torch.autograd.grad(mloss, params, allow_unused=True)
            mgrads = [torch.zeros_like(p) if g is None else g for g, p in zip(mgrads, params)]
            mloss, mmetrics = mloss.detach(), {k: v.detach() for k, v in mmetrics.items()}
            if grads is None:
                loss, metrics, grads = mloss, mmetrics, mgrads
            else:
                loss = loss + mloss
                metrics = {k: metrics[k] + mmetrics[k] for k in metrics}
                torch._foreach_add_(grads, mgrads)
        if a > 1:
            torch._foreach_mul_(grads, 1.0 / a)
            loss = loss * (1.0 / a)
            if "uncertainty" in metrics:
                metrics["uncertainty"] = metrics["uncertainty"] * (1.0 / a)
        return loss, metrics, grads

    return grad_fn


def make_train_step(
    model: EDM,
    diffuser: Diffuser,
    opt_cfg: OptimizerConfig,
    ema_cfg: Optional[EMAConfig] = None,
) -> Callable:
    """train_step(state, batch, generator, sched_count) -> (state, metrics),
    ``batch`` = (images NCHW fp32 normalized, labels or None), ``sched_count``
    the count the lr schedule reads (the epoch, in the CIFAR-10 recipe: the
    caller ticks it). Updates ``state`` in place and returns it."""
    if opt_cfg.log_norms_per_layer:
        raise NotImplementedError("log_norms_per_layer is not ported yet; see ROADMAP.md")
    grad_fn = make_grad_fn(model, diffuser, opt_cfg)
    gammas = ema_cfg.gammas if ema_cfg is not None else ()
    every_n = ema_cfg.every_n_steps if ema_cfg is not None else 1

    def train_step(state: TrainState, batch, generator: Optional[torch.Generator], sched_count):
        images, labels = batch
        loss, metrics, grads = grad_fn(state, images, labels, generator)

        # pre-clip global norm, for the clip and for log_norms
        raw_gnorm = clip_scale = None
        if opt_cfg.grad_clip_norm is not None or opt_cfg.log_norms:
            raw_gnorm = _global_norm(grads)
        if opt_cfg.grad_clip_norm is not None:
            clip_scale = torch.clamp(opt_cfg.grad_clip_norm / (raw_gnorm + 1e-12), max=1.0)
            torch._foreach_mul_(grads, clip_scale)

        lr = opt_cfg.lr * edm_lr_multiplier(sched_count, opt_cfg.rampup_steps,
                                            opt_cfg.steady_steps)
        adam_update(state, grads, opt_cfg.betas, opt_cfg.eps, float(lr))
        force_weight_norm(state.params)
        # power-function EMA(s): decay and check on the pre-increment step
        for tree, gamma in zip(state.ema, gammas):
            maybe_ema_update(tree, state.params, state.step, gamma, every_n)
        state.step += 1

        out = {"train_loss": loss, "learning_rate": lr, "sse": metrics["sse"],
               "count": metrics["count"]}
        if "uncertainty" in metrics:
            out["uncertainty"] = metrics["uncertainty"]
        if opt_cfg.log_norms:
            out["grad_norm"] = raw_gnorm
            out["param_norm"] = _global_norm(state.params.values())
            if clip_scale is not None:
                out["clip_scale"] = clip_scale
        return state, out

    return train_step
