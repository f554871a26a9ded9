#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tinyedm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one or more lines, the first failure ending the run
with a non-zero exit code:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: nvcc builds every CUDA kernel of the paths from the sources in
   tinyedm_tpu_torch/csrc (into tinyedm_tpu_torch/build/), one nvcc per
   source, all started together;
3. fused forward kernel vs plain: the cosine-attention forward kernel
   against its plain PyTorch version at the sampling paths' shapes (CIFAR-10
   at batch 128, 4 heads of 64; ImageNet-512 at batch 32, 4 heads of 144 at
   n = 256 and of 192 at n = 64), bf16 (max abs <= 8e-3) and fp32 (atol =
   rtol = 1e-5), plus odd shapes; times of the kernel, the plain version and
   one PyTorch library call, beside the card's bound;
4. fused backward kernel vs plain: the same for the backward kernel at the
   training paths' shapes (CIFAR-10 batch 256, the ImageNet-512 microbatch of
   32), bf16 (relative L2 <= 1e-3) and fp32 (relative L2 <= 1e-5), plus odd
   shapes; the forward kernel against its plain version again at these
   shapes, with phase 3's limits;
5. flash kernels vs plain: the flash forward and backward kernels (the
   use_pallas_attention route) against flash_attention_plain and its
   backward at the ImageNet-512 widths above its attention levels (4 heads
   of 96 at n = 1024, of 48 at n = 4096) and at 4 heads of 64 (n = 1024,
   4096), batch 32 (the correctness check at n = 4096 at batch 8: the plain
   version holds (b, heads, n, n) fp32), with phase 3's and 4's limits, plus
   odd shapes (n = 1 to 2000, hd = 20 to 256); times beside SDPA's and the
   bound;
6. flash layer check: CosineAttention(use_pallas=True) in bf16 at (32, 384,
   32, 32) and (8, 192, 64, 64), forward and backward against the same
   weights with use_pallas=False (output relative L2 <= 1e-2, input gradient
   <= 2e-2), with exactly one flash forward and one flash backward call each;
7. CIFAR-10 forward: the model at full width, batch 128, bf16, seeded
   weights with gain_out = 1, fused attention against fused="off" (relative
   L2 <= 1e-2), with exactly 11 forward kernel launches;
8. CIFAR-10 Heun-32: tinyedm_tpu_torch.generate.generate() for 128 images at
   batch 128 (693 launches, 128 PNGs, img/s and peak memory), then the same
   solve with fused="off" (final fp32 samples within 2e-2 relative L2);
9. CIFAR-10 training: the recipe's train step at full width (batch 256,
   bf16, dropout 0.13, seeded synthetic images, the recipe's steady lr):
   warm-up steps, then timed steps (ms/step, samples/s, peak memory), with
   exactly 11 forward and 11 backward kernel calls per step, finite losses,
   the EMA equal to the params after step 0 and unit per-output RMS of every
   WN weight; then one step's gradients of the WN weights fused against
   fused="off" from the same state (relative L2 <= 2e-2);
10. ImageNet-512 forward: the 272.9 M-parameter latent model at batch 32,
    bf16, 1000 classes, as phase 7, with exactly 15 fused launches (7 at
    n = 256, 8 at n = 64) and no flash launch (the default topology attends
    at 16x16 and 8x8 only);
11. ImageNet-512 Heun-32: generate() for 32 latents at batch 32 with
    --num_classes 1000 (945 launches, 32 RGBA PNGs), as phase 8;
12. ImageNet-512 training: the recipe's step (batch 128 in 4 microbatches
    of 32, uncertainty loss, two EMA profiles, per-step lr count in the
    steady range), as phase 9, with 60 forward and 60 backward fused calls
    per step and finite uncertainty.

Then one JSON line of per-kernel numbers, the nvidia-smi name/power line,
and last {"ok": true, "device": {...}}. Without CUDA, or without the rest of
the repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s by type
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

HEADS = 4
FUSED_FWD = "tinyedm_tpu/ops/fused_attention.py"
# (config, batch, n, head dim, TPU kernel) of the fused kernels on each path:
# the sampling batches (forward) and the training (micro)batches (backward)
FWD_SHAPES = [
    ("cifar10", 128, 256, 64, f"{FUSED_FWD}:102"), ("cifar10", 128, 64, 64, f"{FUSED_FWD}:253"),
    ("imagenet512", 32, 256, 144, f"{FUSED_FWD}:102"), ("imagenet512", 32, 64, 192, f"{FUSED_FWD}:253"),
]
BWD_SHAPES = [
    ("cifar10", 256, 256, 64, f"{FUSED_FWD}:144"), ("cifar10", 256, 64, 64, f"{FUSED_FWD}:305"),
    ("imagenet512", 32, 256, 144, f"{FUSED_FWD}:144"), ("imagenet512", 32, 64, 192, f"{FUSED_FWD}:305"),
]
# flash shapes, 4 heads at batch 32: the ImageNet-512 channel plan at 32x32
# (C = 384) and 64x64 (C = 192), and 4 heads of 64 at n = 1024 and 4096
FLASH_SHAPES = [(1024, 96), (4096, 48), (1024, 64), (4096, 64)]
FLASH_BATCH = 32
FLASH_LAYERS = [(32, 384, 32), (8, 192, 64)]  # (batch, channels, side)
FLASH_REPLACES = {"fwd": "tinyedm_tpu/ops/attention.py:38", "bwd": "tinyedm_tpu/ops/attention.py:144"}
TOL = {"bfloat16": 8e-3, "float32": 1e-5}
BWD_TOL = {"bfloat16": 1e-3, "float32": 1e-5}  # relative L2
ODD_SHAPES = [(3, 1, 1, 64), (4, 56, 4, 64), (2, 300, 2, 32), (2, 97, 2, 128), (2, 65, 1, 256), (2, 33, 3, 20)]
FLASH_ODD = [(2, 1, 1, 256), (2, 1025, 2, 48), (1, 1100, 2, 64), (2, 2000, 1, 20),
             (1, 1100, 3, 144), (1, 1030, 1, 192), (3, 1024, 1, 33)]
KERNELS = ("cosine_attention_fwd", "cosine_attention_bwd", "flash_attention_fwd", "flash_attention_bwd")
LATENT_MEAN = (5.81, 3.25, 0.12, -2.15)  # experiments/conf/imagenet512.yaml:74-75
LATENT_STD = (4.17, 4.62, 3.71, 3.28)
# per config: (sampling batch, image side, classes, Heun batch size, kernel
# calls of one forward by token count, warm-up and timed train steps, lr
# schedule count at which the full lr applies)
PATHS = {
    "cifar10": dict(batch=128, side=32, classes=None, calls={256: 5, 64: 6},
                    warmup=3, timed=10, sched=200),
    "imagenet512": dict(batch=32, side=64, classes=1000, calls={256: 7, 64: 8},
                        warmup=2, timed=3, sched=10000),
}


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the CUDA-event time per call of ``iters``
    back-to-back calls, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def rel_l2(a, b) -> float:
    """Relative L2 distance; 0 for two zero tensors (dq and dk at n = 1)."""
    a, b = a.double(), b.double()
    ref = float(b.norm())
    if ref == 0.0:
        return 0.0 if float(a.norm()) == 0.0 else float("inf")
    return float((a - b).norm()) / ref


def _fmt(counts: dict) -> str:
    return "{" + ", ".join(f"{d} n={n}: {c}" for (d, n), c in sorted(counts.items())) + "}"


def phase_environment() -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[1 environment] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} | {smi}", flush=True)
    return smi


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from tinyedm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:  # nvcc runs outside the GIL
        paths = list(pool.map(lambda k: _build.build(k, ptxas_verbose=True), KERNELS))
    for name, path in zip(KERNELS, paths):
        _build.load_library(name)
        print(f"[2 build] {name}.cu -> {path.relative_to(ROOT)}", flush=True)
    print(f"[2 build] {len(KERNELS)} kernels in {time.perf_counter() - t0:.2f}s", flush=True)


def _qkv(b, n, heads, hd, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, n, 3 * heads * hd), generator=g, device="cuda") * 0.7
    return x.to(dtype)


def _cotangent(b, n, heads, hd, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    return (torch.randn((b, n, heads * hd), generator=g, device="cuda") * 0.5).to(dtype)


def _bound(nbytes: int, flops: int, dtype_name: str) -> tuple[float, str]:
    """The least time the card could take, in ms, and what bounds it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _check(out, ref, dtype_name: str, what: str) -> float:
    import torch

    if not torch.isfinite(out.float()).all():
        fail(f"{what}: non-finite kernel output")
    err = float((out.float() - ref.float()).abs().max())
    tol = TOL[dtype_name]
    if dtype_name == "float32":
        torch.testing.assert_close(out, ref, atol=tol, rtol=tol, msg=lambda m: f"{what}: {m}")
    elif err > tol:
        fail(f"{what}: max abs {err} > {tol}")
    return err


def _entry(name, source, replaces, err, ms, plain_ms, bound_ms, bound_by, library_ms, **extra):
    return {"name": name, "route": "cuda", "source": f"tinyedm_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, **extra}


def phase_kernel_vs_plain() -> list[dict]:
    import torch
    import torch.nn.functional as F

    from tinyedm_tpu_torch.ops import fused_attention as fa
    from tinyedm_tpu_torch.ops.mp import pixel_norm

    entries = []
    for config, b, n, hd, replaces in FWD_SHAPES:
        c = HEADS * hd
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            qkv = _qkv(b, n, HEADS, hd, dtype, seed=n + hd)
            out = fa.cosine_attention_qkv_cuda(qkv, HEADS)
            torch.cuda.synchronize()
            ref = fa.cosine_attention_qkv_plain(qkv, HEADS)
            err = _check(out, ref, name, f"{config} n={n} hd={hd} {name}")
            ms = time_ms(lambda: fa.cosine_attention_qkv_cuda(qkv, HEADS))
            plain_ms = time_ms(lambda: fa.cosine_attention_qkv_plain(qkv, HEADS), iters=5)
            x = pixel_norm(qkv.reshape(b, n, 3, HEADS, hd), dim=-1)
            q, k, v = (t.transpose(1, 2).contiguous() for t in x.unbind(2))
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            nbytes = (qkv.numel() + out.numel()) * qkv.element_size()
            flops = 4 * b * HEADS * n * n * hd
            bound_ms, bound_by = _bound(nbytes, flops, name)
            print(f"[3 fwd kernel vs plain] cosine_attention_fwd {config} b={b} n={n} C={c} "
                  f"heads={HEADS} {name}: max_abs {err:.3g} | kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)", flush=True)
            if dtype == torch.bfloat16:  # the main path's type
                entries.append(_entry(
                    f"cosine_attention_fwd[{config} n={n} hd={hd}]", "cosine_attention_fwd.cu",
                    replaces, err, ms, plain_ms, bound_ms, bound_by, library_ms,
                    config=config, n=n))
    # every head-dim bucket, ragged token counts (tails of both tiles), n=1
    for b, n, heads, hd in ODD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            qkv = _qkv(b, n, heads, hd, dtype, seed=b * n + hd)
            out = fa.cosine_attention_qkv_cuda(qkv, heads)
            torch.cuda.synchronize()
            _check(out, fa.cosine_attention_qkv_plain(qkv, heads), name, f"b={b} n={n} hd={hd} {name}")
    print("[3 fwd kernel vs plain] odd shapes (n = 1, 33, 56, 65, 97, 300; hd = 20, 32, 64, 128, 256): ok",
          flush=True)
    return entries


def _check_bwd(out, ref, dtype_name: str, what: str) -> tuple[float, float]:
    import torch

    if not torch.isfinite(out.float()).all():
        fail(f"{what}: non-finite backward kernel output")
    err = float((out.float() - ref.float()).abs().max())
    rel = rel_l2(out, ref)
    if not rel <= BWD_TOL[dtype_name]:
        fail(f"{what}: backward relative L2 {rel} > {BWD_TOL[dtype_name]}")
    return err, rel


def _sdpa_bwd_ms(q, k, v, g) -> tuple[float, float]:
    """SDPA's backward time, as its forward plus backward through autograd
    minus its forward alone (both with grad enabled), on (b, heads, n, hd)
    tensors; and the two times it is the difference of."""
    import torch
    import torch.nn.functional as F

    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    with torch.enable_grad():
        fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=5, reps=3)
        both_ms = time_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(q, k, v), (q, k, v), g), iters=5, reps=3)
    return both_ms - fwd_ms, both_ms, fwd_ms


def phase_bwd_kernel_vs_plain() -> list[dict]:
    """The backward kernel against its plain version at the training paths'
    shapes. Library time: scaled_dot_product_attention's backward on the
    pixel-normed q, k, v."""
    import torch

    from tinyedm_tpu_torch.ops import fused_attention as fa
    from tinyedm_tpu_torch.ops.mp import pixel_norm

    entries = []
    for config, b, n, hd, replaces in BWD_SHAPES:
        c = HEADS * hd
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            qkv = _qkv(b, n, HEADS, hd, dtype, seed=n + hd)
            g = _cotangent(b, n, HEADS, hd, dtype, seed=n + hd)
            o = fa.cosine_attention_qkv_cuda(qkv, HEADS)
            torch.cuda.synchronize()
            fwd_err = _check(o, fa.cosine_attention_qkv_plain(qkv, HEADS), name,
                             f"fwd {config} b={b} n={n} {name}")
            out = fa.cosine_attention_qkv_bwd_cuda(qkv, g, o, HEADS)
            torch.cuda.synchronize()
            ref = fa.cosine_attention_qkv_bwd_plain(qkv, g, o, HEADS)
            err, rel = _check_bwd(out, ref, name, f"bwd {config} n={n} {name}")
            del ref
            ms = time_ms(lambda: fa.cosine_attention_qkv_bwd_cuda(qkv, g, o, HEADS), iters=10)
            plain_ms = time_ms(lambda: fa.cosine_attention_qkv_bwd_plain(qkv, g, o, HEADS), iters=3)
            x = pixel_norm(qkv.reshape(b, n, 3, HEADS, hd), dim=-1)
            q, k, v = (t.transpose(1, 2).contiguous() for t in x.unbind(2))
            gh = g.reshape(b, n, HEADS, hd).transpose(1, 2).contiguous()
            library_ms, both_ms, sdpa_fwd_ms = _sdpa_bwd_ms(q, k, v, gh)
            nbytes = 8 * b * n * c * qkv.element_size()
            flops = 10 * b * HEADS * n * n * hd
            bound_ms, bound_by = _bound(nbytes, flops, name)
            print(f"[4 bwd kernel vs plain] cosine_attention_bwd {config} b={b} n={n} C={c} "
                  f"heads={HEADS} {name}: max_abs {err:.3g} rel_l2 {rel:.3g} | kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, sdpa bwd {library_ms:.4f} ms ({both_ms:.4f} - "
                  f"{sdpa_fwd_ms:.4f}), bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
                  f"{flops / 1e9:.2f} GFLOP); forward kernel vs plain max_abs {fwd_err:.3g}", flush=True)
            if dtype == torch.bfloat16:  # the main path's type
                fwd_kernel_ms = time_ms(lambda: fa.cosine_attention_qkv_cuda(qkv, HEADS))
                fwd_bound, fwd_by = _bound(4 * b * n * c * qkv.element_size(),
                                           4 * b * HEADS * n * n * hd, name)
                print(f"[4 bwd kernel vs plain] (the forward kernel at this batch: {fwd_kernel_ms:.4f} ms, "
                      f"bound {fwd_bound:.4f} ms by {fwd_by})", flush=True)
                entries.append(_entry(
                    f"cosine_attention_bwd[{config} n={n} hd={hd}]", "cosine_attention_bwd.cu",
                    replaces, err, ms, plain_ms, bound_ms, bound_by, library_ms,
                    config=config, n=n))
    for b, n, heads, hd in ODD_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            qkv = _qkv(b, n, heads, hd, dtype, seed=b * n + hd)
            g = _cotangent(b, n, heads, hd, dtype, seed=b * n + hd)
            o = fa.cosine_attention_qkv_cuda(qkv, heads)
            out = fa.cosine_attention_qkv_bwd_cuda(qkv, g, o, heads)
            torch.cuda.synchronize()
            _check_bwd(out, fa.cosine_attention_qkv_bwd_plain(qkv, g, o, heads), name,
                       f"bwd b={b} n={n} hd={hd} {name}")
    print("[4 bwd kernel vs plain] odd shapes (n = 1, 33, 56, 65, 97, 300; hd = 20, 32, 64, 128, 256): ok",
          flush=True)
    return entries


def _flash_inputs(b, n, heads, hd, dtype, seed):
    """q, k, v as the model hands them over (the views of one (b, n, 3,
    heads, hd) tensor) and a cotangent g."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, n, 3, heads, hd), generator=gen, device="cuda").to(dtype)
    g = torch.randn((b, n, heads, hd), generator=gen, device="cuda").to(dtype)
    return (*x.unbind(2), g)


def _check_flash(q, k, v, g, name: str, what: str) -> tuple[float, float, float]:
    """Both flash kernels against the plain versions: (forward max abs,
    backward max abs, worst backward relative L2 over dq, dk, dv)."""
    import torch

    from tinyedm_tpu_torch.ops import attention as fl

    out, stats = fl.flash_attention_fwd_cuda(q, k, v)
    torch.cuda.synchronize()
    fwd_err = _check(out, fl.flash_attention_plain(q, k, v), name, f"flash fwd {what}")
    grads = fl.flash_attention_bwd_cuda(q, k, v, g, stats)
    torch.cuda.synchronize()
    errs = [_check_bwd(d, r, name, f"flash bwd {what} {label}")
            for d, r, label in zip(grads, fl.flash_attention_bwd_plain(q, k, v, g), ("dq", "dk", "dv"))]
    return fwd_err, max(e for e, _ in errs), max(r for _, r in errs)


def phase_flash_kernels() -> list[dict]:
    """The flash kernels against their plain versions; times at batch 32 of
    the kernels, the plain versions and SDPA on the same q, k, v."""
    import torch
    import torch.nn.functional as F

    from tinyedm_tpu_torch.ops import attention as fl

    entries = []
    for n, hd in FLASH_SHAPES:
        check_b = FLASH_BATCH if n <= 1024 else 8
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            q, k, v, g = _flash_inputs(check_b, n, HEADS, hd, dtype, seed=n + hd)
            fwd_err, bwd_err, bwd_rel = _check_flash(q, k, v, g, name, f"b={check_b} n={n} hd={hd} {name}")
            print(f"[5 flash vs plain] b={check_b} n={n} heads={HEADS} hd={hd} {name}: forward max_abs "
                  f"{fwd_err:.3g}, backward max_abs {bwd_err:.3g} worst rel_l2 {bwd_rel:.3g}", flush=True)
            if dtype != torch.bfloat16:  # times in the main path's type
                continue
            b = FLASH_BATCH
            if check_b != b:
                del q, k, v, g
                torch.cuda.empty_cache()
                q, k, v, g = _flash_inputs(b, n, HEADS, hd, dtype, seed=n + hd)
            out, stats = fl.flash_attention_fwd_cuda(q, k, v)
            heavy = n * n * hd >= 4096 * 4096 * 48
            iters, reps = (1, 3) if heavy else (3, 3)
            fwd_ms = time_ms(lambda: fl.flash_attention_fwd_cuda(q, k, v), iters=iters, reps=reps)
            fwd_plain = time_ms(lambda: fl.flash_attention_plain(q, k, v), iters=1, reps=3)
            bwd_ms = time_ms(lambda: fl.flash_attention_bwd_cuda(q, k, v, g, stats), iters=iters, reps=reps)
            bwd_plain = time_ms(lambda: fl.flash_attention_bwd_plain(q, k, v, g), iters=1, reps=3)
            qh, kh, vh, gh = (t.transpose(1, 2).contiguous() for t in (q, k, v, g))
            fwd_sdpa = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), iters=5, reps=3)
            bwd_sdpa, _, _ = _sdpa_bwd_ms(qh, kh, vh, gh)
            del qh, kh, vh, gh
            io = b * n * HEADS * hd * q.element_size()
            fwd_bound, fwd_by = _bound(4 * io, 4 * b * HEADS * n * n * hd, name)
            bwd_bound, bwd_by = _bound(7 * io, 10 * b * HEADS * n * n * hd, name)
            print(f"[5 flash vs plain] b={b} n={n} heads={HEADS} hd={hd} {name}: forward kernel "
                  f"{fwd_ms:.4f} ms, plain {fwd_plain:.4f} ms, sdpa {fwd_sdpa:.4f} ms, bound "
                  f"{fwd_bound:.4f} ms ({fwd_by}); backward kernel {bwd_ms:.4f} ms, plain "
                  f"{bwd_plain:.4f} ms, sdpa bwd {bwd_sdpa:.4f} ms, bound {bwd_bound:.4f} ms ({bwd_by})",
                  flush=True)
            if (n, hd) in ((1024, 96), (4096, 48)):  # the ImageNet-512 widths
                for d, err, ms, plain_ms, bound_ms, bound_by, lib_ms in (
                    ("fwd", fwd_err, fwd_ms, fwd_plain, fwd_bound, fwd_by, fwd_sdpa),
                    ("bwd", bwd_err, bwd_ms, bwd_plain, bwd_bound, bwd_by, bwd_sdpa),
                ):
                    entries.append(_entry(
                        f"flash_attention_{d}[b={b} n={n} hd={hd}]", f"flash_attention_{d}.cu",
                        FLASH_REPLACES[d], err, ms, plain_ms, bound_ms, bound_by, lib_ms, n=n))
            del q, k, v, g, out, stats
            torch.cuda.empty_cache()
    for b, n, heads, hd in FLASH_ODD:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            _check_flash(*_flash_inputs(b, n, heads, hd, dtype, seed=b * n + hd), name,
                         f"b={b} n={n} heads={heads} hd={hd} {name}")
    print(f"[5 flash vs plain] odd shapes (n = 1, 1024, 1025, 1030, 1100, 2000; hd = 20, 33, 48, 64, "
          f"144, 192, 256): ok", flush=True)
    return entries


def phase_flash_layer() -> dict[tuple[str, int], int]:
    """CosineAttention(use_pallas=True) against use_pallas=False on the same
    weights, forward and backward; returns the flash calls of the layers'
    use_pallas runs."""
    import torch

    from tinyedm_tpu_torch.models.edm import init_weights
    from tinyedm_tpu_torch.models.layers import CosineAttention
    from tinyedm_tpu_torch.ops import attention as fl

    calls = {}
    for b, c, side in FLASH_LAYERS:
        n = side * side
        flash = CosineAttention(c, HEADS, dtype=torch.bfloat16, use_pallas=True)
        init_weights(flash, torch.Generator().manual_seed(c))
        flash = flash.cuda()
        ref = CosineAttention(c, HEADS, dtype=torch.bfloat16).cuda()
        ref.load_state_dict(flash.state_dict())
        gen = torch.Generator(device="cuda").manual_seed(side)
        x = torch.randn((b, c, side, side), generator=gen, device="cuda").to(torch.bfloat16)
        g = torch.randn((b, c, side, side), generator=gen, device="cuda").to(torch.bfloat16)
        results = []
        for module in (flash, ref):
            xr = x.clone().requires_grad_(True)
            fl.launch_counts.clear()
            out = module(xr)
            (dx,) = torch.autograd.grad(out, xr, g)
            torch.cuda.synchronize()
            results.append((out.detach(), dx, dict(fl.launch_counts)))
        (out, dx, counts), (rout, rdx, rcounts) = results
        if counts != {("flash_fwd", n): 1, ("flash_bwd", n): 1} or rcounts:
            fail(f"flash layer at n={n} launched {counts} (reference {rcounts}), "
                 "expected one flash forward and one flash backward call")
        if not (torch.isfinite(out.float()).all() and torch.isfinite(dx.float()).all()):
            fail(f"flash layer at n={n}: non-finite output or gradient")
        out_err, dx_err = rel_l2(out, rout), rel_l2(dx, rdx)
        print(f"[6 flash layer] CosineAttention({c}, {HEADS} heads, bf16, use_pallas=True) at "
              f"({b}, {c}, {side}, {side}), n={n}: calls {_fmt(counts)}; against use_pallas=False "
              f"output rel L2 {out_err:.3g} (<= 1e-2), input gradient {dx_err:.3g} (<= 2e-2)", flush=True)
        if not (out_err <= 1e-2 and dx_err <= 2e-2):
            fail(f"flash layer at n={n}: output {out_err} or input gradient {dx_err} off the limits")
        calls.update(counts)
        del flash, ref, results, out, dx, rout, rdx
        torch.cuda.empty_cache()
    return calls


def _seeded_models(config: str):
    """The config's model with seeded weights and gain_out = 1 (at its init
    value 0 the output is c_skip * x whatever the network computes), in its
    fused and unfused attention forms with the same weights."""
    import torch

    from tinyedm_tpu_torch.configs import build_model, model_from_config

    fused = build_model(config, "cuda", seed=0)
    with torch.no_grad():
        fused.denoiser.gain_out.fill_(1.0)
    with torch.device("cuda"):
        unfused = model_from_config(config, fused="off").eval()
    unfused.load_state_dict(fused.state_dict())
    return fused, unfused


def _flash_calls() -> dict:
    from tinyedm_tpu_torch.ops import attention as fl

    return {k: v for k, v in fl.launch_counts.items() if v}


def _clear_counts() -> None:
    from tinyedm_tpu_torch.ops import attention as fl
    from tinyedm_tpu_torch.ops import fused_attention as fa

    fa.launch_counts.clear()
    fl.launch_counts.clear()


def phase_forward(tag: str, config: str, fused, unfused) -> None:
    import torch

    from tinyedm_tpu_torch.ops import fused_attention as fa

    p = PATHS[config]
    b, side = p["batch"], p["side"]
    channels = fused.denoiser.conv_in.weight.shape[1] - 1
    g = torch.Generator(device="cuda").manual_seed(1)
    sigma = torch.exp(torch.randn((b,), generator=g, device="cuda") * 1.2 - 1.2)
    x = torch.randn((b, channels, side, side), generator=g, device="cuda")
    x = x * (0.5**2 + sigma**2).sqrt().reshape(-1, 1, 1, 1)
    labels = None
    if p["classes"]:
        labels = torch.randint(0, p["classes"], (b,), generator=g, device="cuda")
    with torch.inference_mode():
        _clear_counts()
        out = fused(x, sigma, labels)
        torch.cuda.synchronize()
        counts, flash = dict(fa.launch_counts), _flash_calls()
        ref = unfused(x, sigma, labels)
    expected = {("fwd", n): c for n, c in p["calls"].items()}
    if counts != expected or flash:
        fail(f"one {config} forward launched {counts} and flash {flash}, expected {expected} and none")
    if out.shape != x.shape or not torch.isfinite(out).all():
        fail(f"forward output {tuple(out.shape)} not finite or not {tuple(x.shape)}")
    err = rel_l2(out, ref)
    print(f"[{tag} forward] {config} EDM b={b} bf16: {sum(counts.values())} launches {_fmt(counts)}, "
          f"flash launches 0 (the default topology attends at 16x16 and 8x8 only, n <= 256); "
          f"fused vs unfused rel L2 {err:.3g} (<= 1e-2)", flush=True)
    if not err <= 1e-2:
        fail(f"fused vs unfused forward rel L2 {err} > 1e-2")


def phase_heun(tag: str, config: str, fused) -> dict[tuple[str, int], int]:
    import torch

    from tinyedm_tpu_torch.generate import generate
    from tinyedm_tpu_torch.ops import fused_attention as fa
    from tinyedm_tpu_torch.utils.interop import save_weights

    p = PATHS[config]
    b = p["batch"]
    latent = {} if config == "cifar10" else dict(mean=LATENT_MEAN, std=LATENT_STD)
    with tempfile.TemporaryDirectory() as tmp:
        weights = Path(tmp) / f"{config}_seed0.pt"
        save_weights(fused, weights, config)
        kwargs = dict(weights=str(weights), device="cuda", num_steps=32, seed=0, keep_samples=True,
                      num_classes=p["classes"] or 0, **latent)
        _clear_counts()
        result = generate(str(Path(tmp) / "fused"), b, p["side"], b, **kwargs)
        counts, flash = dict(fa.launch_counts), _flash_calls()
        pngs = sorted((Path(tmp) / "fused").glob("*.png"))
        color_types = {png.read_bytes()[25] for png in pngs}  # IHDR's color type byte
        ref = generate(str(Path(tmp) / "off"), b, p["side"], b, fused="off", **kwargs)
    expected = {("fwd", n): c * 63 for n, c in p["calls"].items()}
    if counts != expected or flash:
        fail(f"Heun-32 launched {counts} and flash {flash}, expected {expected} and none")
    want_color = 6 if config == "imagenet512" else 2  # RGBA latents, RGB images
    if len(pngs) != b or color_types != {want_color}:
        fail(f"Heun-32 wrote {len(pngs)} PNGs of color types {color_types}, expected {b} of {want_color}")
    samples = torch.from_numpy(result["samples"])
    if not torch.isfinite(samples).all():
        fail("Heun-32 samples not finite")
    err = rel_l2(samples, torch.from_numpy(ref["samples"]))
    print(f"[{tag} heun-32] {config}: {b} samples at batch {b}: {sum(counts.values())} launches "
          f"{_fmt(counts)}, {len(pngs)} PNGs (color type {want_color}), {result['img_per_s']:.2f} img/s "
          f"({result['seconds']:.3f} s), peak {result['peak_bytes'] / 2**30:.3f} GiB; unfused solve "
          f"{ref['img_per_s']:.2f} img/s; fused vs unfused samples rel L2 {err:.3g} (<= 2e-2)", flush=True)
    if not err <= 2e-2:
        fail(f"fused vs unfused Heun-32 samples rel L2 {err} > 2e-2")
    return counts


def phase_train(tag: str, config: str) -> dict[tuple[str, int], int]:
    """The config's recipe train step at full width on seeded synthetic
    data; returns the kernel calls of the warm-up and timed steps."""
    import torch

    from tinyedm_tpu_torch.configs import build_training, model_from_config
    from tinyedm_tpu_torch.data.datamodules import SyntheticDataModule, to_device
    from tinyedm_tpu_torch.ops import fused_attention as fa
    from tinyedm_tpu_torch.training.state import is_weight_normed
    from tinyedm_tpu_torch.training.train_step import (
        init_train_state,
        make_grad_fn,
        make_train_step,
    )

    p = PATHS[config]
    model, diffuser, opt_cfg, ema_cfg, batch, interval = build_training(config, "cuda", seed=0)
    a = opt_cfg.accum_steps
    steps = p["warmup"] + p["timed"]
    channels = model.denoiser.conv_in.weight.shape[1] - 1
    data = SyntheticDataModule(batch, image_size=p["side"], num_channels=channels,
                               num_samples=batch * steps, num_classes_=p["classes"] or 10, seed=0)
    batches = [to_device(x, y, "cuda") for x, y in data.train_batches(0)]  # set-up, not timed

    def count(i: int) -> int:  # the lr schedule's count: per step or per epoch
        return p["sched"] + i if interval == "step" else p["sched"]

    state = init_train_state(model, opt_cfg, ema_cfg)
    step = make_train_step(model, diffuser, opt_cfg, ema_cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    metrics_seen = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _clear_counts()
    t_warm = time.perf_counter()
    for i in range(p["warmup"]):
        state, metrics = step(state, batches[i], gen, count(i))
        metrics_seen.append(metrics)
        if i == 0 and not all(torch.equal(tree[k], prm) for tree in state.ema
                              for k, prm in state.params.items()):
            fail("an EMA tree differs from the params after step 0 (decay 0)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(p["warmup"], steps):
        state, metrics = step(state, batches[i], gen, count(i))
        metrics_seen.append(metrics)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts, flash = dict(fa.launch_counts), _flash_calls()
    peak = torch.cuda.max_memory_allocated()
    expected = {(d, n): a * c * steps for n, c in p["calls"].items() for d in ("fwd", "bwd")}
    if counts != expected or flash:
        fail(f"{steps} train steps made {counts} and flash {flash}, expected {expected} and none")
    losses = torch.stack([m["train_loss"] for m in metrics_seen]).float().cpu()
    if not torch.isfinite(losses).all():
        fail(f"non-finite train loss: {losses.tolist()}")
    uncertainty = ""
    if model.u is not None:
        u = torch.stack([m["uncertainty"] for m in metrics_seen]).float().cpu()
        if not torch.isfinite(u).all():
            fail(f"non-finite uncertainty: {u.tolist()}")
        uncertainty = f", uncertainty {u[0]:.4g} .. {u[-1]:.4g}"
    for k, prm in state.params.items():
        if is_weight_normed(k, prm):
            rms = prm.detach().reshape(prm.shape[0], -1).pow(2).mean(dim=1).sqrt()
            if not torch.allclose(rms, torch.ones_like(rms), atol=1e-3):
                fail(f"{k}: per-output RMS {rms.min().item()}..{rms.max().item()} after the step, not 1")
    ms = 1e3 * seconds / p["timed"]
    print(f"[{tag} train] {config} recipe b={batch} ({a} x {batch // a}) bf16, {len(state.ema)} EMA "
          f"profile(s), lr schedule count {count(0)} ({interval}): {p['warmup']} warm-up steps in "
          f"{time.perf_counter() - t_warm - seconds:.3f} s, {p['timed']} timed steps {ms:.3f} ms/step, "
          f"{batch / ms * 1e3:.2f} samples/s, peak {peak / 2**30:.3f} GiB; calls {_fmt(counts)}, flash 0; "
          f"losses {losses[0]:.4f} .. {losses[-1]:.4f}{uncertainty}", flush=True)

    # one step's gradients, fused against fused="off", from the same state
    with torch.device("cuda"):
        unfused = model_from_config(config, fused="off").eval()
    unfused.load_state_dict(model.state_dict())
    ustate = dataclasses.replace(state, params=dict(unfused.named_parameters()))
    grads, ugrads = (
        make_grad_fn(m, diffuser, opt_cfg)(
            st, *batches[-1], torch.Generator(device="cuda").manual_seed(1)
        )[2]
        for m, st in ((model, state), (unfused, ustate))
    )
    # the WN weights' gradients (all but a few dozen of the values): the
    # scalar gains' gradients are few and large, and would decide a global norm
    names = [k for k, prm in state.params.items() if is_weight_normed(k, prm)]
    pairs = [(g, u) for k, g, u in zip(state.params, grads, ugrads) if k in names]
    err = rel_l2(torch.cat([g.reshape(-1) for g, _ in pairs]), torch.cat([u.reshape(-1) for _, u in pairs]))
    worst = max(rel_l2(g, u) for g, u in pairs)
    print(f"[{tag} train] one step's gradients of the {len(names)} WN weights "
          f"({sum(g.numel() for g, _ in pairs)} values), fused vs unfused attention: rel L2 {err:.3g} "
          f"(<= 2e-2), worst single weight {worst:.3g}; all {len(grads)} parameters "
          f"{rel_l2(torch.cat([g.reshape(-1) for g in grads]), torch.cat([u.reshape(-1) for u in ugrads])):.3g}",
          flush=True)
    if not err <= 2e-2:
        fail(f"fused vs unfused WN weight gradients rel L2 {err} > 2e-2")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    if not (ROOT / "tinyedm_tpu_torch" / "csrc").is_dir():
        fail(f"tinyedm_tpu_torch/ not found beside {Path(__file__).name}: run it from the repository")
    sys.path.insert(0, str(ROOT))
    from tinyedm_tpu_torch.utils.cuda import resolve_device

    resolve_device("cuda")  # fp32 without TF32
    t0 = time.perf_counter()
    smi = phase_environment()
    phase_build()
    fwd_entries = phase_kernel_vs_plain()
    bwd_entries = phase_bwd_kernel_vs_plain()
    flash_entries = phase_flash_kernels()
    layer_calls = phase_flash_layer()
    heun_counts, train_counts = {}, {}
    for tags, config in ((("7", "8", "9"), "cifar10"), (("10", "11", "12"), "imagenet512")):
        fused, unfused = _seeded_models(config)
        phase_forward(tags[0], config, fused, unfused)
        del unfused
        heun_counts[config] = phase_heun(tags[1], config, fused)
        del fused
        torch.cuda.empty_cache()
        train_counts[config] = phase_train(tags[2], config)
        torch.cuda.empty_cache()
    # fused kernels: launches of one Heun-32 batch (forward) or of the
    # training run (backward) of their config, with the calls per train step
    for e in fwd_entries + bwd_entries:
        direction = "bwd" if "bwd" in e["name"] else "fwd"
        config, n = e.pop("config"), e.pop("n")
        steps = PATHS[config]["warmup"] + PATHS[config]["timed"]
        e["launches"] = (heun_counts if direction == "fwd" else train_counts)[config][direction, n]
        e["launches_per_train_step"] = train_counts[config][direction, n] // steps
        e["path"] = f"{config} Heun-32 batch" if direction == "fwd" else f"{config} training run"
    # flash kernels: the layer check's calls; the models' paths launch none
    for e in flash_entries:
        direction = "flash_bwd" if "bwd" in e["name"] else "flash_fwd"
        e["launches"] = layer_calls[direction, e.pop("n")]
        e["launches_model_paths"] = 0
        e["path"] = "flash layer check (CosineAttention use_pallas=True)"
    entries = fwd_entries + bwd_entries + flash_entries
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f}s", flush=True)
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
