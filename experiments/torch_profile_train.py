"""Where a train step's time goes on the card, for the PyTorch port.

    python experiments/torch_profile_train.py [--config cifar10] [--steps 5] [--recompute-island]
        [--fused block] [--remat full|convs]

Builds a training recipe of tinyedm_tpu_torch (``--config cifar10``: bf16,
dropout 0.13, batch 256; ``imagenet512``: 64x64x4 latents with 1000
classes, batch 128 in 4 microbatches, the uncertainty loss, two EMA
profiles; ``mnist``: 28x28x1, 10 classes, dropout 0.1, batch 128;
``imagenet``: ImageNet-64 latents, 3 microbatches of 176, one EMA profile;
seeded weights, seeded synthetic data already on the card), with
the attention route ``--fused`` passes to ``build_training`` (``auto``, the
default: the fused attention kernels; ``block``: the whole-block kernels
where they fit), runs three warm-up steps at the recipe's full lr (the schedule's
count ticking per step where the recipe says so), then ``--steps`` timed
with CUDA events, then as many under torch.profiler.
Prints the wall time per step with the profiler off and on, samples/s, peak
device memory, the device kernel time per step, the device's idle share,
kernels launched per step, device time by kernel group and the top kernels.
``--recompute-island`` runs every block's fp32 island under
``torch.utils.checkpoint`` (the JAX package's ``remat_island``): the backward
recomputes it from the conv output, the (B, C) modulation and the saved
dropout bits instead of keeping its fp32 tensors. Same numbers, other
memory and time. ``--remat`` builds the Denoiser with ``remat=True`` and
that ``remat_policy``: every block recomputed in the backward (``full``),
or only the elementwise chains between the convs, matmuls and attention
kernels (``convs``). Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.checkpoint import checkpoint

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "experiments"))

from tinyedm_tpu_torch.configs import build_training  # noqa: E402
from tinyedm_tpu_torch.data.datamodules import SyntheticDataModule, to_device  # noqa: E402
from tinyedm_tpu_torch.models.blocks import _Block  # noqa: E402
from tinyedm_tpu_torch.training.train_step import init_train_state, make_train_step  # noqa: E402
from torch_profile_heun import card, summarize  # noqa: E402

WARMUP_STEPS = 3
# per config: image side, classes, and a count of the lr schedule at which
# the recipe's full lr applies (epochs for cifar10 and mnist, steps for the
# ImageNet latents)
PATHS = {"cifar10": (32, 10, 200), "imagenet512": (64, 1000, 10000), "mnist": (28, 10, 500),
         "imagenet": (64, 1000, 10000)}
# recipes whose step takes accumulation-count datamodule batches
# (Lightning's accumulate_grad_batches: ImageNet-64's 3 x 176)
LIGHTNING_BATCHES = {"imagenet"}


@contextlib.contextmanager
def recompute_islands():
    """Every block's fp32 island under ``torch.utils.checkpoint`` while the
    context is open (the dropout bits are drawn before it, so they are
    saved and the recompute applies the same mask)."""
    island = _Block._island

    def recomputed(self, res, gmod, bits):
        if not torch.is_grad_enabled():
            return island(self, res, gmod, bits)
        return checkpoint(island, self, res, gmod, bits, use_reentrant=False, preserve_rng_state=False)

    _Block._island = recomputed
    try:
        yield
    finally:
        _Block._island = island


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", choices=sorted(PATHS), default="cifar10")
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--recompute-island", action="store_true")
    parser.add_argument("--fused", choices=("auto", "block"), default="auto")
    parser.add_argument("--remat", choices=("off", "full", "convs"), default="off")
    args = parser.parse_args()
    with recompute_islands() if args.recompute_island else contextlib.nullcontext():
        run(args.config, args.steps, args.recompute_island, args.fused, args.remat)


def run(config: str, steps: int, recompute_island: bool, fused: str = "auto", remat: str = "off") -> None:
    smi = card()
    side, classes, sched = PATHS[config]
    knobs = {} if remat == "off" else dict(remat=True, remat_policy=remat)
    model, diffuser, opt_cfg, ema_cfg, batch, interval = build_training(config, "cuda", fused=fused, seed=0,
                                                                        knobs=knobs)
    if config in LIGHTNING_BATCHES:
        batch *= opt_cfg.accum_steps
    n_batches = WARMUP_STEPS + 2 * steps
    data = SyntheticDataModule(batch, image_size=side, num_channels=model.denoiser.conv_in.weight.shape[1] - 1,
                               num_samples=batch * n_batches, num_classes_=classes, seed=0)
    batches = iter([to_device(x, y, "cuda") for x, y in data.train_batches(0)])
    state = init_train_state(model, opt_cfg, ema_cfg)
    step = make_train_step(model, diffuser, opt_cfg, ema_cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def one_step():
        count = sched + state.step if interval == "step" else sched
        step(state, next(batches), gen, count)

    def timed(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            one_step()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    for _ in range(WARMUP_STEPS):
        one_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wall_ms = timed(steps)  # profiler off
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_ms = timed(steps)

    print(f"card: {smi}")
    print(f"{config} train step, batch {batch} ({opt_cfg.accum_steps} microbatches), bf16, "
          f"dropout {model.denoiser.encoder_blocks[0].dropout_rate}, fused={fused!r} attention, "
          f"fp32 island {'recomputed' if recompute_island else 'saved'}, remat {remat}, {steps} profiled steps: "
          f"{batch / wall_ms * 1e3:.2f} samples/s, peak {peak / 2**30:.3f} GiB")
    summarize(prof, steps, "step", wall_ms, profiled_ms)


if __name__ == "__main__":
    main()
