"""Generation CLI: Heun samples from random noise, written as PNGs.

Counterpart of ``tinyedm_tpu/generate.py`` with its flag names where they
apply (``--output_dir --num_samples --image_size --num_classes --batch_size
--num_steps --seed --mean --std --solver_dtype``), plus ``--config`` (a name
in ``tinyedm_tpu_torch/configs.py``), ``--weights`` (a file from
``utils.interop.save_weights``; without it the weights are a seeded init) and
``--device`` (the card unless ``cpu`` is asked for). ``--num_classes`` has
the JAX meaning (0: unconditional, else the class count) and must agree with
the model; left out, the model's own count is taken. Examples:

    python -m tinyedm_tpu_torch.generate --config cifar10 --output_dir samples \
        --num_samples 128 --batch_size 128 --num_steps 32
    python -m tinyedm_tpu_torch.generate --config imagenet512 --num_classes 1000 \
        --image_size 64 --mean 5.81 3.25 0.12 -2.15 --std 4.17 4.62 3.71 3.28 \
        --output_dir latents --num_samples 32 --batch_size 32 --num_steps 32

A 4-channel (latent) sample is written as an RGBA PNG, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from tinyedm_tpu_torch.configs import build_model
from tinyedm_tpu_torch.data.datamodules import RandomNoiseDataModule
from tinyedm_tpu_torch.diffusion.solver import DeterministicSolver
from tinyedm_tpu_torch.training.callbacks import PreditionWriter
from tinyedm_tpu_torch.utils.cuda import resolve_device
from tinyedm_tpu_torch.utils.interop import load_weights

CIFAR10_MEAN = (0.49139968, 0.48215841, 0.44653091)
CIFAR10_STD = (0.24703223, 0.24348513, 0.26158784)

# flags of the JAX CLI whose features later slices port (ROADMAP.md section 1)
_NOT_PORTED = (
    "ckpt_path", "load_ema", "ckpt_step", "ema_index", "model_parallel",
    "S_churn", "S_noise", "S_min", "S_max", "solver",
    "guidance_scale", "guide_ckpt_path", "guide_ckpt_step", "guide_ema_index",
    "guidance_sigma_min", "guidance_sigma_max",
)


def device_denormalize_uint8(x: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """NCHW sample -> uint8: x*std*2 + mean, clamp [0, 1], *255, truncate
    (the PreditionWriter mapping, in fp32 on the sample's device)."""
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device).reshape(1, -1, 1, 1)
    std_t = torch.tensor(std, dtype=torch.float32, device=x.device).reshape(1, -1, 1, 1)
    y = x.float() * std_t * 2.0 + mean_t
    return (y.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def generate(
    output_dir: str,
    num_samples: int,
    image_size: int,
    batch_size: int,
    *,
    config: str = "cifar10",
    weights: Optional[str] = None,
    device: Optional[str] = None,
    num_steps: int = 32,
    mean: Sequence[float] = CIFAR10_MEAN,
    std: Sequence[float] = CIFAR10_STD,
    solver_dtype: Optional[str] = None,
    seed: int = 0,
    num_classes: Optional[int] = None,
    fused: str = "auto",
    keep_samples: bool = False,
) -> dict:
    """Sample ``num_samples`` images with Heun and write them as PNGs.

    ``weights`` replaces ``config`` by the config name stored with them.
    ``num_classes``: 0 for an unconditional model, else its class count
    (labels are drawn from that many classes); None takes the model's.
    ``fused="off"`` runs the attention unfused (the comparison path).
    Returns the image count, seconds, img/s, the device's peak memory (None
    on the CPU) and, with ``keep_samples``, the fp32 NHWC samples."""
    dev = resolve_device(device)
    state_dict = None
    if weights is not None:
        config, state_dict = load_weights(weights)
    model = build_model(config, dev, fused=fused, seed=seed)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model_classes = model.embedding.num_classes if model.conditional else 0
    if num_classes is not None and num_classes != model_classes:
        raise ValueError(
            f"num_classes={num_classes} but the {config} model has "
            f"{model_classes or 'no'} classes (0 means unconditional)"
        )
    solver = DeterministicSolver(num_steps=num_steps, dtype=solver_dtype)
    datamodule = RandomNoiseDataModule(
        batch_size=batch_size,
        image_size=image_size,
        num_samples=num_samples,
        num_classes=model_classes,
        num_channels=model.denoiser.conv_in.weight.shape[1] - 1,
        seed=seed,
    )
    writer = PreditionWriter(output_dir, "batch", mean=mean, std=std)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    samples = []
    done = 0
    t0 = time.perf_counter()
    for noise, labels, indices in datamodule.predict_batches():
        n = len(indices)
        if n < batch_size:  # pad the tail batch: one batch shape throughout
            pad = batch_size - n
            noise = np.concatenate([noise, noise[:1].repeat(pad, 0)])
            labels = np.concatenate([labels, labels[:1].repeat(pad, 0)])
        x0 = torch.from_numpy(noise).to(dev).permute(0, 3, 1, 2).contiguous()
        lab = torch.from_numpy(labels).to(dev) if model.conditional else None
        with torch.inference_mode():
            x = solver.solve(model, x0, lab)
            images = device_denormalize_uint8(x, mean, std).permute(0, 2, 3, 1)
        writer.write_batch(images[:n].cpu().numpy(), indices)
        if keep_samples:
            samples.append(x[:n].float().permute(0, 2, 3, 1).cpu().numpy())
        done += n
    elapsed = time.perf_counter() - t0
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
        "samples": np.concatenate(samples) if keep_samples else None,
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Sample images with the Heun solver")
    parser.add_argument("--config", type=str, default="cifar10")
    parser.add_argument("--weights", type=str, default=None,
                        help="weights from save_weights (default: seeded init)")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--num_samples", type=int, required=True)
    parser.add_argument("--image_size", type=int, default=32)
    parser.add_argument("--num_classes", type=int, default=None,
                        help="0 = unconditional, else the class count (default: the model's)")
    parser.add_argument("--batch_size", type=int, required=True)
    parser.add_argument("--num_steps", type=int, default=32)
    parser.add_argument("--mean", type=float, nargs="+", default=list(CIFAR10_MEAN))
    parser.add_argument("--std", type=float, nargs="+", default=list(CIFAR10_STD))
    parser.add_argument("--solver_dtype", type=str, default=None,
                        choices=[None, "float32", "bfloat16", "float64"])
    parser.add_argument("--seed", type=int, default=0)
    for flag in _NOT_PORTED:
        parser.add_argument(f"--{flag}", nargs="?", const=True, default=None, help="not ported yet")
    args = parser.parse_args(argv)
    given = [f"--{flag}" for flag in _NOT_PORTED if getattr(args, flag) is not None]
    if given:
        raise NotImplementedError(
            f"{', '.join(given)}: not ported yet (guidance, churn, dpmpp2m, checkpoints "
            "and multi-GPU sampling are later slices; see ROADMAP.md section 1)"
        )
    generate(
        args.output_dir,
        args.num_samples,
        args.image_size,
        args.batch_size,
        config=args.config,
        weights=args.weights,
        device=args.device,
        num_steps=args.num_steps,
        mean=tuple(args.mean),
        std=tuple(args.std),
        solver_dtype=args.solver_dtype,
        seed=args.seed,
        num_classes=args.num_classes,
    )


if __name__ == "__main__":
    main()
