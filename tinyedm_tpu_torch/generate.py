"""Generation CLI: samples from random noise, written as PNGs.

Counterpart of ``tinyedm_tpu/generate.py`` with its flag names where they
apply (``--output_dir --num_samples --image_size --num_classes --num_channels
--batch_size --num_workers --num_steps --seed --mean --std --solver_dtype
--solver --S_churn --S_noise --S_min --S_max --guidance_scale
--guidance_sigma_min --guidance_sigma_max --ckpt_path --load_ema --ckpt_step --ema_index
--guide_ckpt_path --guide_ckpt_step --guide_ema_index``), plus ``--config``
(a name in ``experiments/conf/``), ``--weights`` (a file from
``utils.interop.save_weights``; without it, or a checkpoint, the weights are
a seeded init), ``--guide_weights`` (autoguidance's guide model from such a
file) and ``--device`` (the card unless ``cpu`` is asked for).
``--ckpt_path`` is a trainer's checkpoint directory (``<out_dir>/checkpoints``
of ``tinyedm_tpu_torch.train``): the model is rebuilt from the config it
carries, with the train weights or, with ``--load_ema``, the EMA tree
``--ema_index``, at ``--ckpt_step`` (the latest by default); it excludes
``--weights`` and ``--config``, and ``--guide_ckpt_path`` (loaded with the
same ``--load_ema``) excludes ``--guide_weights``; with ``--load_ema`` it
prints "EMA weights loaded.", as the JAX CLI does. ``--num_classes`` has the
JAX meaning (0: unconditional, else the class count) and must agree with the
model; left out, the model's own count is taken, and so is
``--num_channels``'s. ``--num_workers`` is taken for the JAX CLI's command
lines and unused: the noise is drawn on the device. The samplers: Heun
(default), ``--solver dpmpp2m`` (DPM-Solver++ (2M), one forward per step), and Heun with churn (``--S_churn > 0``, EDM
Algorithm 2; its noise comes from a generator seeded from ``seed ^ 0xC4A2``
and the batch index). Guidance follows the JAX CLI's rules: a scale alone is
classifier-free guidance (one stacked forward of twice the batch), with
``--guide_weights`` autoguidance; ``--guidance_sigma_min/max`` limit it to
``min < sigma <= max``. Examples:

    python -m tinyedm_tpu_torch.generate --config cifar10 --output_dir samples \
        --num_samples 128 --batch_size 128 --num_steps 32
    python -m tinyedm_tpu_torch.generate --config imagenet512 --num_classes 1000 \
        --image_size 64 --mean 5.81 3.25 0.12 -2.15 --std 4.17 4.62 3.71 3.28 \
        --output_dir latents --num_samples 32 --batch_size 32 --num_steps 32 \
        --guidance_scale 2.0 --guidance_sigma_min 0.28 --guidance_sigma_max 2.9
    python -m tinyedm_tpu_torch.generate --ckpt_path runs/cifar10/checkpoints --load_ema \
        --output_dir samples --num_samples 128 --batch_size 128
    python -m tinyedm_tpu_torch.generate --config cifar10 --output_dir churn \
        --num_samples 128 --batch_size 128 --S_churn 40 --S_min 0.05 --S_max 50 \
        --S_noise 1.003

A 4-channel (latent) sample is written as an RGBA PNG, as the JAX CLI does,
a 1-channel one as a grey PNG.

Under a process group (``parallel.mesh.init_distributed``; the CLI joins
torchrun's where ``WORLD_SIZE`` > 1), as the JAX CLI
under ``jax.process_count() > 1``, the ranks form a ``data x model`` grid
with ``--model_parallel`` ranks to a model group (default 1; a world it does
not divide raises ``ValueError``). The batch size is rounded up to a
multiple of the data size, every data rank solves its contiguous share of
each padded global batch, and of each model group only model rank 0 writes
its PNGs (``local_rows``), as the JAX CLI writes each row once. The noise,
and churn's, are the global batch's, so the files do not depend on the
grid. With ``--model_parallel N`` the weight-normed kernels are sharded over
the model group (``parallel/tensor.py``), for a model whose weights do not
fit one card: the model is loaded whole on the host, cut to the rank's
shards and moved to the card, and every forward gathers activations over the
model group. Data parallelism alone makes no collective but a barrier at the
end. Example, two cards sampling ImageNet-512 latents as one model:

    python -m torch.distributed.run --nproc_per_node 2 -m tinyedm_tpu_torch.generate \
        --config imagenet512 --num_classes 1000 --image_size 64 --mean 5.81 3.25 0.12 -2.15 \
        --std 4.17 4.62 3.71 3.28 --output_dir latents --num_samples 32 --batch_size 32 \
        --model_parallel 2
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from tinyedm_tpu_torch.configs import build_model
from tinyedm_tpu_torch.data.datamodules import RandomNoiseDataModule
from tinyedm_tpu_torch.diffusion.guidance import (
    NULL_LABEL,
    autoguidance_denoise_fn,
    cfg_denoise_fn,
)
from tinyedm_tpu_torch.diffusion.solver import (
    DeterministicSolver,
    MultistepSolver,
    StochasticSolver,
)
from tinyedm_tpu_torch.parallel.mesh import barrier, distributed, init_distributed, local_rows, make_grid
from tinyedm_tpu_torch.parallel.tensor import shard_model
from tinyedm_tpu_torch.training.callbacks import PreditionWriter
from tinyedm_tpu_torch.training.checkpoint import load_edm_from_checkpoint
from tinyedm_tpu_torch.utils.cuda import folded_generator, resolve_device
from tinyedm_tpu_torch.utils.interop import load_weights

CIFAR10_MEAN = (0.49139968, 0.48215841, 0.44653091)
CIFAR10_STD = (0.24703223, 0.24348513, 0.26158784)

CHURN_SEED = 0xC4A2  # the churn generators' seed is seed ^ CHURN_SEED, as in the JAX CLI


def device_denormalize_uint8(x: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """NCHW sample -> uint8: x*std*2 + mean, clamp [0, 1], *255, truncate
    (the PreditionWriter mapping, in fp32 on the sample's device)."""
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device).reshape(1, -1, 1, 1)
    std_t = torch.tensor(std, dtype=torch.float32, device=x.device).reshape(1, -1, 1, 1)
    y = x.float() * std_t * 2.0 + mean_t
    return (y.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def make_solver(solver: str, num_steps: int, solver_dtype: Optional[str], s_churn: float,
                s_noise: float, s_min: float, s_max: float):
    """The sampler the CLI's flags name: churn (``s_churn > 0``) is Heun's
    stochastic form and does not combine with ``dpmpp2m``."""
    if s_churn > 0:
        if solver != "heun":
            raise ValueError(
                "--S_churn is the Heun stochastic sampler (EDM Algorithm 2); "
                f"it does not compose with --solver {solver}"
            )
        return StochasticSolver(num_steps=num_steps, dtype=solver_dtype, S_churn=s_churn,
                                S_noise=s_noise, S_min=s_min, S_max=s_max)
    if solver == "dpmpp2m":
        return MultistepSolver(num_steps=num_steps, dtype=solver_dtype)
    if solver == "heun":
        return DeterministicSolver(num_steps=num_steps, dtype=solver_dtype)
    raise ValueError(f"unknown solver {solver!r} (heun | dpmpp2m)")


def guidance_plan(guidance_scale: Optional[float], conditional: bool, autoguided: bool,
                  sigma_min: float, sigma_max: float) -> tuple[Optional[float], Optional[tuple]]:
    """(scale, interval) after the JAX CLI's rules: scale 1 without a guide
    model is the conditional model (scale None: unguided, said on stdout);
    CFG needs a conditional model; a guide model or an interval needs a
    scale. The interval is None where it restricts nothing."""
    guided = guidance_scale is not None
    if guided and not autoguided and guidance_scale == 1.0:
        print("[generate] guidance_scale 1.0 = conditional model; sampling unguided (no stacked forward)")
        guided = False
    if guided and not autoguided and not conditional:
        raise ValueError("--guidance_scale needs a conditional model (or --guide_weights for autoguidance)")
    if autoguided and not guided:
        raise ValueError("a guide model (--guide_weights or --guide_ckpt_path) needs --guidance_scale")
    interval = None
    if sigma_min > 0 or sigma_max != float("inf"):
        if guidance_scale is None:
            raise ValueError(
                "--guidance_sigma_min/--guidance_sigma_max need --guidance_scale "
                "(an interval without a scale would silently sample unguided)"
            )
        interval = (sigma_min, sigma_max)
    return (guidance_scale if guided else None), interval


def _load_model(config: str, weights: Optional[str], dev: torch.device, fused: str, seed: int):
    """(config name, model): ``weights`` replace ``config`` by the name stored
    with them and the seeded init by their values."""
    state_dict = None
    if weights is not None:
        config, state_dict = load_weights(weights)
    model = build_model(config, dev, fused=fused, seed=seed)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return config, model


def _load_checkpoint_model(ckpt_path: str, step: Optional[int], load_ema: bool, ema_index: int,
                           dev: torch.device, fused: str):
    """(a name for messages, model) from a trainer's checkpoint directory."""
    _, model, _, state = load_edm_from_checkpoint(ckpt_path, step=step, load_ema=load_ema,
                                                  ema_index=ema_index, device=dev, fused=fused)
    return f"checkpoint step {state.step}", model


def generate(
    output_dir: str,
    num_samples: int,
    image_size: int,
    batch_size: int,
    *,
    config: Optional[str] = None,
    weights: Optional[str] = None,
    ckpt_path: Optional[str] = None,
    load_ema: bool = False,
    ckpt_step: Optional[int] = None,
    ema_index: int = 0,
    device: Optional[str] = None,
    num_steps: int = 32,
    mean: Sequence[float] = CIFAR10_MEAN,
    std: Sequence[float] = CIFAR10_STD,
    solver_dtype: Optional[str] = None,
    seed: int = 0,
    num_classes: Optional[int] = None,
    num_channels: Optional[int] = None,
    solver: str = "heun",
    s_churn: float = 0.0,
    s_noise: float = 1.0,
    s_min: float = 0.0,
    s_max: float = float("inf"),
    guidance_scale: Optional[float] = None,
    guide_weights: Optional[str] = None,
    guide_ckpt_path: Optional[str] = None,
    guide_ckpt_step: Optional[int] = None,
    guide_ema_index: int = 0,
    guidance_sigma_min: float = 0.0,
    guidance_sigma_max: float = float("inf"),
    fused: str = "auto",
    keep_samples: bool = False,
    model_parallel: int = 1,
) -> dict:
    """Sample ``num_samples`` images and write them as PNGs.

    ``weights`` replaces ``config`` (cifar10 by default) by the config name
    stored with them. ``ckpt_path`` (a trainer's checkpoint directory)
    replaces both: the model comes from its embedded config, with the train
    weights or, with ``load_ema``, EMA tree ``ema_index``, at ``ckpt_step``
    (the latest by default); ``guide_ckpt_path`` likewise gives the
    autoguidance model in place of ``guide_weights``.
    ``num_classes``: 0 for an unconditional model, else its class count
    (labels are drawn from that many classes); None takes the model's.
    ``num_channels`` must equal the model's channel count; None takes it.
    ``solver``, ``s_*``, ``guidance_*`` and ``guide_weights`` are the CLI's
    flags (module docstring). ``fused="off"`` runs the attention unfused
    (the comparison path), in the guide model too. ``model_parallel``: the
    ranks of a model group (module docstring). Returns the image count,
    seconds, img/s, the device's peak memory (None on the CPU) and, with
    ``keep_samples``, the fp32 NHWC samples (this rank's, under a process
    group; None where it has none)."""
    sampler = make_solver(solver, num_steps, solver_dtype, s_churn, s_noise, s_min, s_max)
    if ckpt_path is not None and (weights is not None or config is not None):
        raise ValueError("--ckpt_path excludes --weights and --config (the checkpoint carries its config)")
    if ckpt_path is None and (load_ema or ckpt_step is not None):
        raise ValueError("--load_ema and --ckpt_step need --ckpt_path")
    if guide_ckpt_path is not None and guide_weights is not None:
        raise ValueError("--guide_ckpt_path and --guide_weights exclude each other")
    grid = make_grid(model_parallel)
    dev = resolve_device(device)
    # tensor parallelism loads the whole model on the host and moves the
    # rank's shards to the card
    load_dev = torch.device("cpu") if grid.model_size > 1 else dev
    if ckpt_path is not None:
        config, model = _load_checkpoint_model(ckpt_path, ckpt_step, load_ema, ema_index, load_dev, fused)
        if load_ema:
            print("EMA weights loaded.")
    else:
        config, model = _load_model(config or "cifar10", weights, load_dev, fused, seed)
    shard_model(model, grid)
    model = model.to(dev)
    model_classes = model.embedding.num_classes if model.conditional else 0
    if num_classes is not None and num_classes != model_classes:
        raise ValueError(
            f"num_classes={num_classes} but the {config} model has "
            f"{model_classes or 'no'} classes (0 means unconditional)"
        )
    model_channels = model.denoiser.in_channels
    if num_channels is not None and num_channels != model_channels:
        raise ValueError(f"num_channels={num_channels} but the {config} model has {model_channels} channels")
    guide_source = guide_weights if guide_ckpt_path is None else guide_ckpt_path
    scale, interval = guidance_plan(guidance_scale, model.conditional, guide_source is not None,
                                    guidance_sigma_min, guidance_sigma_max)
    denoise_fn = model
    if guide_source is not None:
        if guide_ckpt_path is not None:
            guide_config, guide = _load_checkpoint_model(guide_ckpt_path, guide_ckpt_step, load_ema,
                                                         guide_ema_index, load_dev, fused)
        else:
            guide_config, guide = _load_model(config, guide_weights, load_dev, fused, seed)
        shard_model(guide, grid)
        guide = guide.to(dev)
        print(f"[generate] autoguidance with the {guide_config} model from {guide_source}")
        denoise_fn = autoguidance_denoise_fn(model, guide, scale, interval)
    elif scale == 0.0 and interval is None:
        # fully unconditional: one null-label forward, no stacked batch
        denoise_fn = lambda x, s, labels: model(x, s, torch.full_like(labels, NULL_LABEL))  # noqa: E731
    elif scale is not None:
        denoise_fn = cfg_denoise_fn(model, scale, interval)
    rank, size = grid.data_rank, grid.data_size
    if batch_size % size:
        batch_size = -(-batch_size // size) * size
        print(f"[generate] batch_size rounded up to {batch_size} (a multiple of the {size} data ranks)")
    per = batch_size // size
    datamodule = RandomNoiseDataModule(
        batch_size=batch_size,
        image_size=image_size,
        num_samples=num_samples,
        num_classes=model_classes,
        num_channels=model_channels,
        seed=seed,
    )
    writer = PreditionWriter(output_dir, "batch", mean=mean, std=std)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    samples = []
    done = 0
    t0 = time.perf_counter()
    for batch_index, (noise, labels, indices) in enumerate(datamodule.predict_batches()):
        n = len(indices)
        if n < batch_size:  # pad the tail batch: one batch shape throughout
            pad = batch_size - n
            noise = np.concatenate([noise, noise[:1].repeat(pad, 0)])
            labels = np.concatenate([labels, labels[:1].repeat(pad, 0)])
        mine = slice(rank * per, (rank + 1) * per)  # this rank's rows of the global batch
        x0 = torch.from_numpy(noise[mine]).to(dev).permute(0, 3, 1, 2).contiguous()
        lab = torch.from_numpy(labels[mine]).to(dev) if model.conditional else None
        with torch.inference_mode():
            if isinstance(sampler, StochasticSolver):
                churn = folded_generator(seed ^ CHURN_SEED, batch_index, dev)
                rows = (rank * per, batch_size) if size > 1 else None
                x = sampler.solve(denoise_fn, x0, lab, generator=churn, rows=rows)
            else:
                x = sampler.solve(denoise_fn, x0, lab)
            images = device_denormalize_uint8(x, mean, std).permute(0, 2, 3, 1)
        local, idx = local_rows(batch_size, n, indices, rank, size)
        if len(idx):
            local = torch.as_tensor(local, device=dev)
            if grid.model_rank == 0:  # a model group's ranks hold the same rows
                writer.write_batch(images[local].cpu().numpy(), idx)
            if keep_samples:
                samples.append(x[local].float().permute(0, 2, 3, 1).cpu().numpy())
        done += n
    elapsed = time.perf_counter() - t0
    barrier()  # every rank's files are written
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    rate = done / elapsed
    print(f"wrote {done} images to {output_dir} in {elapsed:.2f}s "
          f"({rate:.2f} img/s end-to-end incl. PNG IO, on {dev})")
    if peak is not None:
        print(f"[generate] peak device memory {peak / 2**30:.3f} GiB "
              f"({torch.cuda.get_device_name(dev)})")
    return {
        "images": done,
        "seconds": elapsed,
        "img_per_s": rate,
        "peak_bytes": peak,
        "samples": np.concatenate(samples) if keep_samples and samples else None,
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Sample images with Heun, DPM-Solver++(2M) or churn")
    parser.add_argument("--config", type=str, default=None, help="a name in experiments/conf/ (default cifar10)")
    parser.add_argument("--weights", type=str, default=None,
                        help="weights from save_weights (default: seeded init)")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--num_samples", type=int, required=True)
    parser.add_argument("--image_size", type=int, default=32)
    parser.add_argument("--num_classes", type=int, default=None,
                        help="0 = unconditional, else the class count (default: the model's)")
    parser.add_argument("--num_channels", type=int, default=None,
                        help="sample channels; must equal the model's (default: the model's)")
    parser.add_argument("--batch_size", type=int, required=True)
    parser.add_argument("--num_workers", type=int, default=16,
                        help="unused: the noise is drawn on the device (taken for the JAX CLI's command lines)")
    parser.add_argument("--num_steps", type=int, default=32)
    parser.add_argument("--mean", type=float, nargs="+", default=list(CIFAR10_MEAN))
    parser.add_argument("--std", type=float, nargs="+", default=list(CIFAR10_STD))
    parser.add_argument("--solver_dtype", type=str, default=None,
                        choices=[None, "float32", "bfloat16", "float64"])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--solver", type=str, default="heun", choices=["heun", "dpmpp2m"],
                        help="Heun (2n-1 forwards) or DPM-Solver++(2M) (n forwards)")
    parser.add_argument("--S_churn", type=float, default=0.0, help=">0: the stochastic (churn) Heun sampler")
    parser.add_argument("--S_noise", type=float, default=1.0)
    parser.add_argument("--S_min", type=float, default=0.0)
    parser.add_argument("--S_max", type=float, default=float("inf"))
    parser.add_argument("--guidance_scale", type=float, default=None,
                        help="alone: classifier-free guidance (cond vs null label); with "
                             "--guide_weights: autoguidance. 1 = the main model")
    parser.add_argument("--guide_weights", type=str, default=None,
                        help="autoguidance: a weaker model's weights from save_weights")
    parser.add_argument("--ckpt_path", type=str, default=None,
                        help="a trainer's checkpoint directory (excludes --weights and --config)")
    parser.add_argument("--load_ema", action="store_true", help="sample with the checkpoint's EMA weights")
    parser.add_argument("--ckpt_step", type=int, default=None, help="checkpoint step (default: latest)")
    parser.add_argument("--ema_index", type=int, default=0, help="EMA profile of a multi-profile checkpoint")
    parser.add_argument("--guide_ckpt_path", type=str, default=None,
                        help="autoguidance: the guide model's checkpoint directory")
    parser.add_argument("--guide_ckpt_step", type=int, default=None)
    parser.add_argument("--guide_ema_index", type=int, default=0)
    parser.add_argument("--guidance_sigma_min", type=float, default=0.0,
                        help="guide only while guidance_sigma_min < sigma <= guidance_sigma_max")
    parser.add_argument("--guidance_sigma_max", type=float, default=float("inf"))
    parser.add_argument("--model_parallel", type=int, default=1,
                        help="ranks of a model group: the weight-normed kernels sharded over them")
    args = parser.parse_args(argv)
    # started by torchrun (WORLD_SIZE > 1): join its process group
    joined = int(os.environ.get("WORLD_SIZE", "1")) > 1 and not distributed()
    if joined:
        on_cpu = args.device is not None and torch.device(args.device).type == "cpu"
        init_distributed(backend="gloo" if on_cpu else None)
    try:
        _main(args)
    finally:
        if joined:
            torch.distributed.destroy_process_group()


def _main(args: argparse.Namespace) -> None:
    generate(
        args.output_dir,
        args.num_samples,
        args.image_size,
        args.batch_size,
        config=args.config,
        weights=args.weights,
        ckpt_path=args.ckpt_path,
        load_ema=args.load_ema,
        ckpt_step=args.ckpt_step,
        ema_index=args.ema_index,
        device=args.device,
        num_steps=args.num_steps,
        mean=tuple(args.mean),
        std=tuple(args.std),
        solver_dtype=args.solver_dtype,
        seed=args.seed,
        num_classes=args.num_classes,
        num_channels=args.num_channels,
        solver=args.solver,
        s_churn=args.S_churn,
        s_noise=args.S_noise,
        s_min=args.S_min,
        s_max=args.S_max,
        guidance_scale=args.guidance_scale,
        guide_weights=args.guide_weights,
        guide_ckpt_path=args.guide_ckpt_path,
        guide_ckpt_step=args.guide_ckpt_step,
        guide_ema_index=args.guide_ema_index,
        guidance_sigma_min=args.guidance_sigma_min,
        guidance_sigma_max=args.guidance_sigma_max,
        model_parallel=args.model_parallel,
    )


if __name__ == "__main__":
    main()
