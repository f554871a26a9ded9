"""Where a Heun forward's time goes on the card, for the PyTorch port.

    python experiments/torch_profile_heun.py [--config cifar10] [--batch N] [--forwards 3]

Builds a model of tinyedm_tpu_torch (``--config cifar10``, batch 128 by
default, ``imagenet512``, the 64x64x4 latent model at batch 32 with seeded
labels, or ``mnist``, 28x28x1 at batch 256, the stacked batch of CFG at a
sampling batch of 128; seeded weights, gain_out = 1, bf16, fused attention)
and runs the forward a Heun step makes, at sigma = 80:
two warm-up forwards, then ``--forwards`` timed with CUDA events, then as
many under torch.profiler. Prints the wall time per forward with the
profiler off and on, the device kernel time per forward, the device's idle
share (kernel time against the wall time with the profiler off), kernels
launched per forward, device time by kernel group and the top kernels.
Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tinyedm_tpu_torch.configs import build_model  # noqa: E402

# kernel-name substrings -> group, first match wins
GROUPS = [
    ("block GEMMs (port's)", ("gemm::gemm_kernel", "gemm_tc::gemm_tc_kernel", "reduce_partials")),
    ("flash attention kernels", ("flash_",)),
    ("attention kernel", ("cosine_attention_fwd",)),
    ("attention bwd kernel", ("attn_bwd_",)),
    ("optimizer (foreach)", ("multi_tensor_apply", "foreach")),
    ("conv (cuDNN)", ("conv", "fprop", "implicit", "nchw", "nhwc", "winograd", "dgrad", "wgrad")),
    ("gemm (cuBLAS)", ("gemm", "cutlass", "sm90_")),
    ("reduction", ("reduce",)),
    ("copy / cat / layout", ("copy", "cat", "transpose", "permute")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
]


# per config: image side, default batch, classes (None: unconditional);
# mnist's default is CFG's stacked batch, twice the sampling batch of 128
PATHS = {"cifar10": (32, 128, None), "imagenet512": (64, 32, 1000), "mnist": (28, 256, 10)}


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", 0.0) or getattr(evt, "self_cuda_time_total", 0.0))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def summarize(prof, n: int, unit: str, wall_ms: float, profiled_ms: float) -> None:
    """Print device time per ``unit`` (a forward, a step) over ``n`` profiled
    units: busy time, idle share against ``wall_ms``, kernels, groups, top
    kernels."""
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise SystemExit("the profiler recorded no device time: time with CUDA events instead")
    busy_ms = sum(device_us(e) for e in kernels) / 1e3 / n
    launches = sum(e.count for e in kernels) / n
    by_group = defaultdict(float)
    for e in kernels:
        by_group[group_of(e.key)] += device_us(e) / 1e3 / n
    print(f"wall {wall_ms:.3f} ms/{unit} (profiler off), {profiled_ms:.3f} ms (profiler on); "
          f"device kernels {busy_ms:.3f} ms/{unit}; device idle share {1 - busy_ms / wall_ms:.3f} "
          f"(profiler off); {launches:.0f} kernels/{unit}")
    for group, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {group:22s} {ms:8.3f} ms/{unit}  {ms / busy_ms:6.1%} of device time")
    print(f"top kernels (device ms per {unit}, launches per {unit}):")
    for e in sorted(kernels, key=device_us, reverse=True)[:12]:
        print(f"  {device_us(e) / 1e3 / n:8.3f}  {e.count / n:5.0f}  {e.key[:110]}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", choices=sorted(PATHS), default="cifar10")
    parser.add_argument("--batch", type=int, default=None,
                        help="default: 128 (cifar10), 32 (imagenet512), 256 (mnist)")
    parser.add_argument("--forwards", type=int, default=3)
    args = parser.parse_args()
    side, default_batch, classes = PATHS[args.config]
    batch = args.batch or default_batch

    smi = card()
    model = build_model(args.config, "cuda", seed=0)
    with torch.no_grad():
        model.denoiser.gain_out.fill_(1.0)
    channels = model.denoiser.conv_in.weight.shape[1] - 1
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((batch, channels, side, side), generator=g, device="cuda") * 80.0
    sigma = torch.full((batch,), 80.0, device="cuda")
    labels = torch.randint(0, classes, (batch,), generator=g, device="cuda") if classes else None

    def forward():
        return model(x, sigma, labels)

    def timed(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            forward()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    with torch.inference_mode():
        for _ in range(2):
            forward()
        torch.cuda.synchronize()
        wall_ms = timed(args.forwards)  # profiler off
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled_ms = timed(args.forwards)

    print(f"card: {smi}")
    print(f"{args.config} EDM forward, batch {batch}, bf16, fused attention, "
          f"{args.forwards} profiled forwards")
    summarize(prof, args.forwards, "forward", wall_ms, profiled_ms)


if __name__ == "__main__":
    main()
