#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tinyedm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one or more lines, the first failure ending the run
with a non-zero exit code:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: nvcc builds every CUDA kernel of the path from the sources in
   tinyedm_tpu_torch/csrc (into tinyedm_tpu_torch/build/), one nvcc per
   source, all started together;
3. forward kernel vs plain: the forward kernel against its plain PyTorch
   version at the sampling path's shapes (batch 128), bf16 (max abs <= 8e-3)
   and fp32 (atol = rtol = 1e-5), plus odd shapes; times of the kernel, the
   plain version and one PyTorch library call, beside the card's bound;
4. backward kernel vs plain: the same for the backward kernel at the
   training path's shapes (batch 256), bf16 (relative L2 <= 1e-3) and fp32
   (relative L2 <= 1e-5), plus odd shapes; the forward kernel against its
   plain version again at these shapes, with phase 3's limits;
5. one forward: the CIFAR-10 EDM at full width, batch 128, bf16, seeded
   weights with gain_out = 1, the fused attention against fused="off"
   (relative L2 <= 1e-2), with exactly 11 forward kernel launches;
6. Heun-32: tinyedm_tpu_torch.generate.generate() for 128 images at batch
   128 (693 launches, 128 PNGs, img/s and peak memory), then the same solve
   with fused="off" (final fp32 samples within 2e-2 relative L2);
7. training: the CIFAR-10 recipe's train step at full width (batch 256,
   bf16, dropout 0.13, seeded synthetic images, the recipe's steady lr):
   warm-up steps, then timed steps (ms/step, samples/s, peak memory), with
   exactly 11 forward and 11 backward kernel calls per step, finite losses,
   the EMA equal to the params after step 0 and unit per-output RMS of every
   WN weight; then one step's gradients of the WN weights fused against
   fused="off" from the same state and generator (relative L2 <= 2e-2).

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

BATCH = 128  # the sampling path's batch
TRAIN_BATCH = 256  # the training recipe's batch
HEADS = 4
CHANNELS = 256
PATH_TOKENS = {256: "tinyedm_tpu/ops/fused_attention.py:102", 64: "tinyedm_tpu/ops/fused_attention.py:253"}
BWD_TOKENS = {256: "tinyedm_tpu/ops/fused_attention.py:144", 64: "tinyedm_tpu/ops/fused_attention.py:305"}
TOL = {"bfloat16": 8e-3, "float32": 1e-5}
BWD_TOL = {"bfloat16": 1e-3, "float32": 1e-5}  # relative L2
ODD_SHAPES = [(3, 1, 1, 64), (4, 56, 4, 64), (2, 300, 2, 32), (2, 97, 2, 128), (2, 65, 1, 256), (2, 33, 3, 20)]
KERNELS = ("cosine_attention_fwd", "cosine_attention_bwd")
WARMUP_STEPS = 3
TIMED_STEPS = 10
STEADY_EPOCH = 200  # the recipe's lr schedule count at which the full lr applies


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
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


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


def phase_kernel_vs_plain() -> list[dict]:
    import torch
    import torch.nn.functional as F

    from tinyedm_tpu_torch.ops import fused_attention as fa
    from tinyedm_tpu_torch.ops.mp import pixel_norm

    hd = CHANNELS // HEADS
    entries = []
    for n, replaces in PATH_TOKENS.items():
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            qkv = _qkv(BATCH, n, HEADS, hd, dtype, seed=n)
            out = fa.cosine_attention_qkv_cuda(qkv, HEADS)
            torch.cuda.synchronize()
            ref = fa.cosine_attention_qkv_plain(qkv, HEADS)
            err = _check(out, ref, name, f"n={n} {name}")
            ms = time_ms(lambda: fa.cosine_attention_qkv_cuda(qkv, HEADS))
            plain_ms = time_ms(lambda: fa.cosine_attention_qkv_plain(qkv, HEADS), iters=5)
            x = pixel_norm(qkv.reshape(BATCH, n, 3, HEADS, hd), dim=-1)
            q, k, v = (t.transpose(1, 2).contiguous() for t in x.unbind(2))
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            nbytes = (qkv.numel() + out.numel()) * qkv.element_size()
            flops = 4 * BATCH * HEADS * n * n * hd
            bound_ms, bound_by = _bound(nbytes, flops, name)
            print(f"[3 fwd kernel vs plain] cosine_attention_fwd b={BATCH} n={n} C={CHANNELS} "
                  f"heads={HEADS} {name}: max_abs {err:.3g} | kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)", flush=True)
            if dtype == torch.bfloat16:  # the main path's type
                entries.append({
                    "name": f"cosine_attention_fwd[n={n}]",
                    "route": "cuda",
                    "source": "tinyedm_tpu_torch/csrc/cosine_attention_fwd.cu",
                    "replaces": replaces,
                    "launches": None,
                    "max_abs_err": err,
                    "ms": ms,
                    "plain_ms": plain_ms,
                    "bound_ms": bound_ms,
                    "bound_by": bound_by,
                    "library_ms": library_ms,
                })
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


def phase_bwd_kernel_vs_plain() -> list[dict]:
    """The backward kernel against its plain version at the training path's
    shapes. Library time: scaled_dot_product_attention forward plus backward
    through autograd on the pixel-normed q, k, v, minus its forward alone
    (both with grad enabled), i.e. SDPA's backward."""
    import torch
    import torch.nn.functional as F

    from tinyedm_tpu_torch.ops import fused_attention as fa
    from tinyedm_tpu_torch.ops.mp import pixel_norm

    hd = CHANNELS // HEADS
    entries = []
    for n, replaces in BWD_TOKENS.items():
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            qkv = _qkv(TRAIN_BATCH, n, HEADS, hd, dtype, seed=n)
            g = _cotangent(TRAIN_BATCH, n, HEADS, hd, dtype, seed=n)
            o = fa.cosine_attention_qkv_cuda(qkv, HEADS)
            torch.cuda.synchronize()
            fwd_err = _check(o, fa.cosine_attention_qkv_plain(qkv, HEADS), name,
                             f"fwd b={TRAIN_BATCH} n={n} {name}")
            out = fa.cosine_attention_qkv_bwd_cuda(qkv, g, o, HEADS)
            torch.cuda.synchronize()
            ref = fa.cosine_attention_qkv_bwd_plain(qkv, g, o, HEADS)
            err, rel = _check_bwd(out, ref, name, f"bwd n={n} {name}")
            del ref
            ms = time_ms(lambda: fa.cosine_attention_qkv_bwd_cuda(qkv, g, o, HEADS), iters=10)
            plain_ms = time_ms(lambda: fa.cosine_attention_qkv_bwd_plain(qkv, g, o, HEADS), iters=3)
            x = pixel_norm(qkv.reshape(TRAIN_BATCH, n, 3, HEADS, hd), dim=-1)
            q, k, v = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in x.unbind(2))
            gh = g.reshape(TRAIN_BATCH, n, HEADS, hd).transpose(1, 2).contiguous()
            with torch.enable_grad():
                fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
                both_ms = time_ms(lambda: torch.autograd.grad(
                    F.scaled_dot_product_attention(q, k, v), (q, k, v), gh))
            library_ms = both_ms - fwd_ms
            nbytes = 8 * TRAIN_BATCH * n * CHANNELS * qkv.element_size()
            flops = 10 * TRAIN_BATCH * HEADS * n * n * hd
            bound_ms, bound_by = _bound(nbytes, flops, name)
            print(f"[4 bwd kernel vs plain] cosine_attention_bwd b={TRAIN_BATCH} n={n} C={CHANNELS} "
                  f"heads={HEADS} {name}: max_abs {err:.3g} rel_l2 {rel:.3g} | kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, sdpa bwd {library_ms:.4f} ms ({both_ms:.4f} - "
                  f"{fwd_ms:.4f}), bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
                  f"{flops / 1e9:.2f} GFLOP); forward kernel vs plain max_abs {fwd_err:.3g}", flush=True)
            if dtype == torch.bfloat16:  # the main path's type
                fwd_kernel_ms = time_ms(lambda: fa.cosine_attention_qkv_cuda(qkv, HEADS))
                fwd_bound, fwd_by = _bound(4 * TRAIN_BATCH * n * CHANNELS * qkv.element_size(),
                                           4 * TRAIN_BATCH * HEADS * n * n * hd, name)
                print(f"[4 bwd kernel vs plain] (the forward kernel at this batch: {fwd_kernel_ms:.4f} ms, "
                      f"bound {fwd_bound:.4f} ms by {fwd_by})", flush=True)
                entries.append({
                    "name": f"cosine_attention_bwd[n={n}]",
                    "route": "cuda",
                    "source": "tinyedm_tpu_torch/csrc/cosine_attention_bwd.cu",
                    "replaces": replaces,
                    "launches": None,
                    "max_abs_err": err,
                    "ms": ms,
                    "plain_ms": plain_ms,
                    "bound_ms": bound_ms,
                    "bound_by": bound_by,
                    "library_ms": library_ms,
                })
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


def _seeded_models():
    """The CIFAR-10 model with seeded weights and gain_out = 1 (at its init
    value 0 the output is c_skip * x whatever the network computes), in its
    fused and unfused attention forms with the same weights."""
    import torch

    from tinyedm_tpu_torch.configs import build_model

    fused = build_model("cifar10", "cuda", seed=0)
    with torch.no_grad():
        fused.denoiser.gain_out.fill_(1.0)
    unfused = build_model("cifar10", "cuda", fused="off", seed=0)
    unfused.load_state_dict(fused.state_dict())
    return fused, unfused


def phase_forward(fused, unfused) -> None:
    import torch

    from tinyedm_tpu_torch.ops import fused_attention as fa

    g = torch.Generator(device="cuda").manual_seed(1)
    sigma = torch.exp(torch.randn((BATCH,), generator=g, device="cuda") * 1.2 - 1.2)
    x = torch.randn((BATCH, 3, 32, 32), generator=g, device="cuda") * (0.5**2 + sigma**2).sqrt().reshape(-1, 1, 1, 1)
    with torch.inference_mode():
        fa.launch_counts.clear()
        out = fused(x, sigma)
        torch.cuda.synchronize()
        counts = dict(fa.launch_counts)
        ref = unfused(x, sigma)
    if counts != {("fwd", 256): 5, ("fwd", 64): 6}:
        fail(f"one forward launched {counts}, expected 5 forward calls at n=256 and 6 at n=64")
    if out.shape != x.shape or not torch.isfinite(out).all():
        fail(f"forward output {tuple(out.shape)} not finite or not {tuple(x.shape)}")
    err = rel_l2(out, ref)
    print(f"[5 one forward] CIFAR-10 EDM b={BATCH} bf16: 11 launches {_fmt(counts)}, "
          f"fused vs unfused rel L2 {err:.3g} (<= 1e-2)", flush=True)
    if not err <= 1e-2:
        fail(f"fused vs unfused forward rel L2 {err} > 1e-2")


def phase_heun(fused) -> dict[tuple[str, int], int]:
    import torch

    from tinyedm_tpu_torch.generate import generate
    from tinyedm_tpu_torch.ops import fused_attention as fa
    from tinyedm_tpu_torch.utils.interop import save_weights

    with tempfile.TemporaryDirectory() as tmp:
        weights = Path(tmp) / "cifar10_seed0.pt"
        save_weights(fused, weights, "cifar10")
        kwargs = dict(weights=str(weights), device="cuda", num_steps=32, seed=0, keep_samples=True)
        fa.launch_counts.clear()
        result = generate(str(Path(tmp) / "fused"), BATCH, 32, BATCH, **kwargs)
        counts = dict(fa.launch_counts)
        pngs = len(list((Path(tmp) / "fused").glob("*.png")))
        ref = generate(str(Path(tmp) / "off"), BATCH, 32, BATCH, fused="off", **kwargs)
    if counts != {("fwd", 256): 5 * 63, ("fwd", 64): 6 * 63}:
        fail(f"Heun-32 launched {counts}, expected 315 forward calls at n=256 and 378 at n=64")
    if pngs != BATCH:
        fail(f"Heun-32 wrote {pngs} PNGs, expected {BATCH}")
    samples = torch.from_numpy(result["samples"])
    if not torch.isfinite(samples).all():
        fail("Heun-32 samples not finite")
    err = rel_l2(samples, torch.from_numpy(ref["samples"]))
    print(f"[6 heun-32] {BATCH} images at batch {BATCH}: {sum(counts.values())} launches {_fmt(counts)}, "
          f"{pngs} PNGs, {result['img_per_s']:.2f} img/s ({result['seconds']:.3f} s), "
          f"peak {result['peak_bytes'] / 2**30:.3f} GiB; unfused solve {ref['img_per_s']:.2f} img/s; "
          f"fused vs unfused samples rel L2 {err:.3g} (<= 2e-2)", flush=True)
    if not err <= 2e-2:
        fail(f"fused vs unfused Heun-32 samples rel L2 {err} > 2e-2")
    return counts


def phase_train() -> dict[tuple[str, int], int]:
    """The CIFAR-10 recipe's train step at full width on seeded synthetic
    images; returns the kernel calls of the warm-up and timed steps."""
    import torch

    from tinyedm_tpu_torch.configs import build_training
    from tinyedm_tpu_torch.data.datamodules import SyntheticDataModule, to_device
    from tinyedm_tpu_torch.ops import fused_attention as fa
    from tinyedm_tpu_torch.training.state import is_weight_normed
    from tinyedm_tpu_torch.training.train_step import (
        init_train_state,
        make_grad_fn,
        make_train_step,
    )

    model, diffuser, opt_cfg, ema_cfg, batch = build_training("cifar10", "cuda", seed=0)
    if batch != TRAIN_BATCH:
        fail(f"the recipe's batch is {batch}, expected {TRAIN_BATCH}")
    steps = WARMUP_STEPS + TIMED_STEPS
    data = SyntheticDataModule(batch, num_samples=batch * steps, seed=0)
    batches = [to_device(x, y, "cuda") for x, y in data.train_batches(0)]  # set-up, not timed
    state = init_train_state(model, opt_cfg, ema_cfg)
    step = make_train_step(model, diffuser, opt_cfg, ema_cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launch_counts.clear()
    t_warm = time.perf_counter()
    for i in range(WARMUP_STEPS):
        state, metrics = step(state, batches[i], gen, STEADY_EPOCH)
        losses.append(metrics["train_loss"])
        if i == 0 and not all(torch.equal(state.ema[0][k], p) for k, p in state.params.items()):
            fail("the EMA differs from the params after step 0 (decay 0)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(WARMUP_STEPS, steps):
        state, metrics = step(state, batches[i], gen, STEADY_EPOCH)
        losses.append(metrics["train_loss"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(fa.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    expected = {("fwd", 256): 5 * steps, ("fwd", 64): 6 * steps,
                ("bwd", 256): 5 * steps, ("bwd", 64): 6 * steps}
    if counts != expected:
        fail(f"{steps} train steps made {counts}, expected 11 forward and 11 backward calls per step")
    losses = torch.stack(losses).float().cpu()
    if not torch.isfinite(losses).all():
        fail(f"non-finite train loss: {losses.tolist()}")
    for k, p in state.params.items():
        if is_weight_normed(k, p):
            rms = p.detach().reshape(p.shape[0], -1).pow(2).mean(dim=1).sqrt()
            if not torch.allclose(rms, torch.ones_like(rms), atol=1e-3):
                fail(f"{k}: per-output RMS {rms.min().item()}..{rms.max().item()} after the step, not 1")
    ms = 1e3 * seconds / TIMED_STEPS
    print(f"[7 train] CIFAR-10 recipe b={batch} bf16 dropout 0.13, lr schedule count {STEADY_EPOCH}: "
          f"{WARMUP_STEPS} warm-up steps in {time.perf_counter() - t_warm - seconds:.3f} s, "
          f"{TIMED_STEPS} timed steps {ms:.3f} ms/step, {batch / ms * 1e3:.2f} samples/s, peak "
          f"{peak / 2**30:.3f} GiB; calls {_fmt(counts)}; losses {losses[0]:.4f} .. {losses[-1]:.4f}",
          flush=True)

    # one step's gradients, fused against fused="off", from the same state
    unfused, *_ = build_training("cifar10", "cuda", fused="off", seed=0)
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
    names = [k for k, p in state.params.items() if is_weight_normed(k, p)]
    pairs = [(g, u) for k, g, u in zip(state.params, grads, ugrads) if k in names]
    err = rel_l2(torch.cat([g.reshape(-1) for g, _ in pairs]), torch.cat([u.reshape(-1) for _, u in pairs]))
    worst = max(rel_l2(g, u) for g, u in pairs)
    print(f"[7 train] one step's gradients of the {len(names)} WN weights "
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
    entries = phase_kernel_vs_plain()
    bwd_entries = phase_bwd_kernel_vs_plain()
    fused, unfused = _seeded_models()
    phase_forward(fused, unfused)
    del unfused
    heun_counts = phase_heun(fused)
    del fused
    train_counts = phase_train()
    steps = WARMUP_STEPS + TIMED_STEPS
    # forward: launches of one Heun-32 batch; backward: of the training run;
    # both with the calls per train step beside them
    for e in entries + bwd_entries:
        direction = "bwd" if "bwd" in e["name"] else "fwd"
        n = int(e["name"].split("=")[1].rstrip("]"))
        counts = heun_counts if direction == "fwd" else train_counts
        e["launches"] = counts[direction, n]
        e["launches_per_train_step"] = train_counts[direction, n] // steps
    entries += bwd_entries
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f}s", flush=True)
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
