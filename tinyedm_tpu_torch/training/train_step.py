"""The EDM train step.

Counterpart of ``tinyedm_tpu/training/train_step.py``: diffuse -> U-Net
forward and backward in the compute dtype with fp32 islands -> fp32 weighted
MSE -> Adam -> forced weight norm -> power-EMA update(s). The state is
updated in place (``training/state.py``); randomness (label dropout, then
diffuser draws, then dropout bits block by block, per microbatch) comes
from one explicit generator. ``make_eval_step`` is the validation step.

Over several ranks (``parallel.mesh.ParallelPlan``) each rank takes the
gradients of its share of the batch, and one all-reduce over the data group
averages them with the step's scalars before the clip, so the clip reads the
global batch's norm; then Adam runs on the whole params (data parallel) or
on the rank's range of them, followed by one all-gather (ZeRO-1). Each data
rank draws from its own generator (the trainer's
``utils.cuda.step_generator``). Under tensor parallelism the params are the
rank's shards and the replicated params (``parallel/tensor.py``): the
backward is seeded with ``1 / model_size``, the replicated params' partial
gradients are summed over the model group in the sync, and the norms sum the
shards' squares over the model group and count a replicated param once.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Callable, Optional

import numpy as np
import torch

from tinyedm_tpu_torch.diffusion.diffuser import Diffuser
from tinyedm_tpu_torch.diffusion.guidance import drop_labels
from tinyedm_tpu_torch.diffusion.loss import edm_training_loss, weighted_sum_squared_error
from tinyedm_tpu_torch.models.edm import EDM
from tinyedm_tpu_torch.ops.precond import edm_loss_weight
from tinyedm_tpu_torch.parallel.mesh import ParallelPlan
from tinyedm_tpu_torch.training.ema import EMAConfig, maybe_ema_update
from tinyedm_tpu_torch.training.lr_schedule import edm_lr_multiplier
from tinyedm_tpu_torch.training.state import TrainState, force_weight_norm, weight_normed_names
from tinyedm_tpu_torch.utils.cuda import folded_generator
from tinyedm_tpu_torch.utils.interop import jax_group
from tinyedm_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 1e-4
    betas: tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8  # torch.optim.Adam's default
    rampup_steps: int = 0
    steady_steps: int = 1
    # what the schedule's count ticks with: "epoch" (the epoch counter) or
    # "step" (the optimizer step); the caller passes the count to the step
    scheduler_interval: str = "epoch"
    accum_steps: int = 1  # gradient accumulation microbatches
    log_norms: bool = False  # global pre-clip grad norm and param norm as metrics
    # also per depth-2 group of the JAX params tree (grad_norm/<top>.<child>,
    # param_norm/<top>.<child>): pre-clip gradients, step-input params
    log_norms_per_layer: bool = False
    grad_clip_norm: Optional[float] = None  # global-norm clipping; None = off
    # CFG training: per-sample probability that a label becomes the null
    # label -1, or that a text-conditioned sample's caption is zeroed
    # (conditional models only; 0 draws nothing)
    label_dropout: float = 0.0


def init_train_state(
    model: EDM, opt_cfg: OptimizerConfig, ema_cfg: Optional[EMAConfig] = None
) -> TrainState:
    """State over the model's own parameters, force-normalized in place as
    the JAX package does at init; zero Adam moments; EMA trees copied from
    the normalized weights."""
    del opt_cfg  # Adam's state does not depend on its settings
    params = dict(model.named_parameters())
    force_weight_norm(params, weight_normed_names(model))
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
def _adam(params: list[torch.Tensor], grads: list[torch.Tensor], mu: list[torch.Tensor],
          nu: list[torch.Tensor], count: int, betas: tuple[float, float], eps: float, lr: float) -> None:
    """optax ``scale_by_adam`` then ``-lr * update`` added to the params, in
    place, elementwise over matching lists (whole tensors or ranges of them:
    the same numbers either way): mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 +
    b2 nu, bias-corrected by fp32 ``1 - b**count``, update = mu^ / (sqrt(nu^)
    + eps)."""
    b1, b2 = betas
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
    one, c = np.float32(1.0), np.float32(count)
    bc1 = float(one - np.float32(b1) ** c)
    bc2 = float(one - np.float32(b2) ** c)
    denom = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    update = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
    torch._foreach_mul_(update, -lr)
    torch._foreach_add_(params, update)


@torch.no_grad()
def adam_update(state: TrainState, grads: list[torch.Tensor], betas: tuple[float, float],
                eps: float, lr: float) -> None:
    """Adam on the whole state (``_adam``), gradients in ``state.params``
    order; counts the step."""
    state.count += 1
    keys = list(state.params)
    _adam([state.params[k] for k in keys], grads, [state.mu[k] for k in keys], [state.nu[k] for k in keys],
          state.count, betas, eps, lr)


@torch.no_grad()
def adam_update_range(state: TrainState, grads: list[torch.Tensor], plan: ParallelPlan,
                      betas: tuple[float, float], eps: float, lr: float) -> None:
    """Adam on this rank's range of the params (ZeRO-1): ``state.mu`` and
    ``state.nu`` hold the range's pieces (``ParallelPlan.shard``); the rest
    of the params is another rank's to update. Counts the step."""
    state.count += 1
    names = [plan.names[i] for i, *_ in plan.pieces]
    _adam(plan.pieces_of(state.params), plan.pieces_of(grads), [state.mu[k] for k in names],
          [state.nu[k] for k in names], state.count, betas, eps, lr)


@torch.no_grad()
def _global_norm(tensors: list[torch.Tensor], plan: Optional[ParallelPlan] = None) -> torch.Tensor:
    if plan is not None and plan.model_size > 1:
        return torch.sqrt(plan.sq_norms(tensors, [range(len(tensors))])[0])
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


def make_grad_fn(model: EDM, diffuser: Diffuser, opt_cfg: OptimizerConfig, model_size: int = 1) -> Callable:
    """grad_fn(state, images, labels, generator) -> (loss, metrics, grads):
    ``labels`` the conditioning (class labels, a ``TextConditioning`` or
    None), sliced with the images into microbatches; the step's loss and fp32
    gradients in ``state.params`` order, averaged
    over ``opt_cfg.accum_steps`` equal microbatches (a batch they do not
    divide raises, as the JAX step's reshape does). Over a model group of
    ``model_size`` ranks the backward is seeded with ``1 / model_size``: a
    shard's gradient is then its own, a replicated param's a partial sum
    (``parallel/tensor.py``)."""
    sigma_data = model.sigma_data
    conditional = model.conditional
    label_dropout = float(opt_cfg.label_dropout) if conditional else 0.0

    def loss_fn(images, labels, generator):
        if label_dropout > 0.0 and labels is not None:
            labels = drop_labels(labels, label_dropout, generator)
        noisy, sigma = diffuser(images, generator)
        denoised, uncertainty = model.denoise_with_aux(
            noisy, sigma, labels if conditional else None, train=True, generator=generator
        )
        weight = edm_loss_weight(sigma, sigma_data)
        return edm_training_loss(weight, denoised, images, uncertainty)

    def grad_fn(state: TrainState, images, labels, generator):
        params = list(state.params.values())
        a = opt_cfg.accum_steps
        if images.shape[0] % a:
            raise ValueError(f"a batch of {images.shape[0]} does not split into {a} equal microbatches")
        m = images.shape[0] // a
        loss = grads = metrics = None
        for i in range(a):
            mb = slice(i * m, (i + 1) * m)
            with span("tinyedm.train_step.forward"):
                mloss, mmetrics = loss_fn(images[mb], labels[mb] if labels is not None else None,
                                          generator)
            with span("tinyedm.train_step.backward"):
                seed = None if model_size == 1 else torch.full_like(mloss, 1.0 / model_size)
                mgrads = torch.autograd.grad(mloss, params, grad_outputs=seed, allow_unused=True)
                mgrads = [torch.zeros_like(p) if g is None else g for g, p in zip(mgrads, params)]
                mloss, mmetrics = mloss.detach(), {k: v.detach() for k, v in mmetrics.items()}
                if grads is None:
                    loss, metrics, grads = mloss, mmetrics, mgrads
                else:
                    loss = loss + mloss
                    metrics = {k: metrics[k] + mmetrics[k] for k in metrics}
                    torch._foreach_add_(grads, mgrads)
        if a > 1:
            with span("tinyedm.train_step.backward"):
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
    plan: Optional[ParallelPlan] = None,
) -> Callable:
    """train_step(state, batch, generator, sched_count, interrupt=False) ->
    (state, metrics), ``batch`` = (images NCHW fp32 normalized, labels, a
    ``TextConditioning`` or None), ``sched_count`` the count the lr schedule reads (the epoch, in
    the CIFAR-10 recipe: the caller ticks it). Updates ``state`` in place and
    returns it.

    With a ``plan`` the batch is this rank's share: the gradients and
    scalars are averaged over the ranks (``ParallelPlan.sync``), the
    metrics are the global batch's, and ``metrics["interrupt"]`` is the
    number of ranks that passed ``interrupt=True`` (the trainer's agreed
    stop). With ``plan.zero1`` the state's moments and EMA trees are this
    rank's pieces (``ParallelPlan.shard``) and the params a view of the
    plan's flat buffer (``ParallelPlan.adopt_params``)."""
    model_size = plan.model_size if plan is not None else 1
    grad_fn = make_grad_fn(model, diffuser, opt_cfg, model_size)
    wn_names = weight_normed_names(model)
    gammas = ema_cfg.gammas if ema_cfg is not None else ()
    every_n = ema_cfg.every_n_steps if ema_cfg is not None else 1

    def train_step(state: TrainState, batch, generator: Optional[torch.Generator], sched_count,
                   interrupt: bool = False):
        with span("tinyedm.train_step"):
            images, labels = batch
            loss, metrics, grads = grad_fn(state, images, labels, generator)
            stop = None
            if plan is not None:
                means = [loss] + ([metrics["uncertainty"]] if "uncertainty" in metrics else [])
                flag = torch.full((), float(interrupt), device=loss.device)
                grads, means, sums = plan.sync(grads, means, [metrics["sse"], metrics["count"]], [flag])
                loss, metrics = means[0], {"sse": sums[0], "count": sums[1]} | (
                    {"uncertainty": means[1]} if len(means) > 1 else {})
                stop = sums[2]
            with span("tinyedm.train_step.optimizer"):
                per_layer = _per_layer_norms(state.params, grads, plan) if opt_cfg.log_norms_per_layer else {}

                # pre-clip global norm, for the clip and for log_norms
                raw_gnorm = clip_scale = None
                if opt_cfg.grad_clip_norm is not None or opt_cfg.log_norms:
                    raw_gnorm = _global_norm(grads, plan)
                if opt_cfg.grad_clip_norm is not None:
                    clip_scale = torch.clamp(opt_cfg.grad_clip_norm / (raw_gnorm + 1e-12), max=1.0)
                    torch._foreach_mul_(grads, clip_scale)

                lr = opt_cfg.lr * edm_lr_multiplier(sched_count, opt_cfg.rampup_steps,
                                                    opt_cfg.steady_steps)
                with span("tinyedm.train_step.optimizer.adam"):
                    if plan is not None and plan.zero1:
                        adam_update_range(state, grads, plan, opt_cfg.betas, opt_cfg.eps, float(lr))
                        plan.gather_params(state.params)
                    else:
                        adam_update(state, grads, opt_cfg.betas, opt_cfg.eps, float(lr))
                with span("tinyedm.train_step.optimizer.weight_norm"):
                    force_weight_norm(state.params, wn_names)
                # power-function EMA(s): decay and check on the pre-increment step;
                # under ZeRO-1 on this rank's pieces of the params
                ema_source = state.params
                if plan is not None and plan.zero1:
                    ema_source = {plan.names[i]: v for (i, *_), v in zip(plan.pieces, plan.pieces_of(state.params))}
                with span("tinyedm.train_step.optimizer.ema"):
                    for tree, gamma in zip(state.ema, gammas):
                        maybe_ema_update(tree, ema_source, state.step, gamma, every_n)
                state.step += 1

            out = {"train_loss": loss, "learning_rate": lr, "sse": metrics["sse"],
                   "count": metrics["count"]}
            if "uncertainty" in metrics:
                out["uncertainty"] = metrics["uncertainty"]
            if opt_cfg.log_norms:
                out["grad_norm"] = raw_gnorm
                out["param_norm"] = _global_norm(list(state.params.values()), plan)
                if clip_scale is not None:
                    out["clip_scale"] = clip_scale
            out.update(per_layer)
            if stop is not None:
                out["interrupt"] = stop
            return state, out

    return train_step


def _per_layer_norms(params: dict[str, torch.Tensor], grads: list[torch.Tensor],
                     plan: Optional[ParallelPlan] = None) -> dict[str, torch.Tensor]:
    """grad_norm/<group> and param_norm/<group> for every depth-2 group of
    the JAX params tree (``utils.interop.jax_group``): the JAX step's
    per-layer metric names."""
    groups = defaultdict(list)
    for i, name in enumerate(params):
        groups[jax_group(name)].append(i)
    values = list(params.values())
    out = {}
    for prefix, tensors in (("grad_norm", grads), ("param_norm", values)):
        names, members = zip(*sorted(groups.items()))
        if plan is not None and plan.model_size > 1:
            norms = list(torch.sqrt(plan.sq_norms(tensors, members)))
        else:
            norms = [_global_norm([tensors[i] for i in m]) for m in members]
        out.update({f"{prefix}/{g}": v for g, v in zip(names, norms)})
    return out


def make_eval_step(
    model: EDM,
    diffuser: Diffuser,
    use_ema: bool = False,
    ema_index: int = 0,
    n_profiles: int = 0,
) -> Callable:
    """eval_step(state, batch, seed, row_offset=0) -> {"sse", "count", ["sse_ema{i}"]}: the
    validation step. Diffuse with the training law, denoise without dropout,
    return the summed weighted error and the sample count for exact
    averaging across batches.

    ``batch`` is (images, labels) or (images, labels, mask): a per-sample
    0/1 mask lets a caller pad a batch, its pad rows weighted 0 and left out
    of the count. Sample ``i`` draws its sigma and noise from
    ``folded_generator(seed, row_offset + i)``, so a sample's draws do not
    depend on the batch shape (pad rows shift no real row's draws) nor, with
    ``row_offset`` the index of a rank's first row in the global batch, on
    the world size. The weights are the
    state's params, or with ``use_ema`` its EMA tree ``ema_index`` (through
    ``torch.func.functional_call``, no swap). ``n_profiles > 0`` also
    returns ``sse_ema{i}`` for the first ``n_profiles`` EMA trees on the
    same draws."""
    sigma_data = model.sigma_data
    conditional = model.conditional

    @torch.no_grad()
    def eval_step(state: TrainState, batch, seed: int, row_offset: int = 0) -> dict[str, torch.Tensor]:
        images, labels, *rest = batch
        mask = rest[0] if rest else None
        draws = [diffuser(images[i:i + 1], folded_generator(seed, row_offset + i, images.device))
                 for i in range(images.shape[0])]
        noisy = torch.cat([d[0] for d in draws])
        sigma = torch.cat([d[1] for d in draws])
        weight = edm_loss_weight(sigma, sigma_data)
        if mask is not None:
            m = mask.float()
            weight = weight * m
            count = m.sum()
        else:
            count = torch.tensor(float(images.shape[0]), device=images.device)
        args = (noisy, sigma, labels if conditional else None)

        def sse_with(tree: dict[str, torch.Tensor]) -> torch.Tensor:
            denoised = torch.func.functional_call(model, tree, args)
            return weighted_sum_squared_error(weight, denoised, images)[0]

        profile_sse = {i: sse_with(state.ema[i]) for i in range(n_profiles)}
        if use_ema:
            primary = profile_sse[ema_index] if ema_index in profile_sse else sse_with(state.ema[ema_index])
        else:
            primary = sse_with(state.params)
        out = {"sse": primary, "count": count}
        for i, v in profile_sse.items():
            out[f"sse_ema{i}"] = v
        return out

    return eval_step
