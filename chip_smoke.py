#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tinyedm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line, the first failure ending the run with a
non-zero exit code:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: nvcc builds every CUDA kernel of the path from the sources in
   tinyedm_tpu_torch/csrc (into tinyedm_tpu_torch/build/);
3. kernel vs plain: each kernel against its plain PyTorch version at the
   CIFAR-10 path's shapes, bf16 (max abs <= 8e-3) and fp32 (atol = rtol =
   1e-5), plus odd shapes; times of the kernel, the plain version and one
   PyTorch library call, beside the card's bound for the same work;
4. one forward: the CIFAR-10 EDM at full width, batch 128, bf16, seeded
   weights with gain_out = 1, the fused attention against fused="off"
   (relative L2 <= 1e-2), with exactly 11 kernel launches;
5. Heun-32: tinyedm_tpu_torch.generate.generate() for 128 images at batch
   128 (693 launches, 128 PNGs, img/s and peak memory), then the same solve
   with fused="off" (final fp32 samples within 2e-2 relative L2).

Then one JSON line of per-kernel numbers, the nvidia-smi name/power line,
and last {"ok": true, "device": {...}}. Without CUDA, or without the rest of
the repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

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

BATCH = 128
HEADS = 4
CHANNELS = 256
PATH_TOKENS = {256: "tinyedm_tpu/ops/fused_attention.py:102", 64: "tinyedm_tpu/ops/fused_attention.py:253"}
TOL = {"bfloat16": 8e-3, "float32": 1e-5}


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
    from tinyedm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build("cosine_attention_fwd", ptxas_verbose=True)
    _build.load_library("cosine_attention_fwd")
    print(f"[2 build] cosine_attention_fwd.cu -> {path.relative_to(ROOT)} "
          f"in {time.perf_counter() - t0:.2f}s", flush=True)


def _qkv(b, n, heads, hd, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, n, 3 * heads * hd), generator=g, device="cuda") * 0.7
    return x.to(dtype)


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
            t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[name]
            bound_ms = 1e3 * max(t_bytes, t_ops)
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            print(f"[3 kernel vs plain] cosine_attention_fwd b={BATCH} n={n} C={CHANNELS} "
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
    for b, n, heads, hd in [(3, 1, 1, 64), (4, 56, 4, 64), (2, 300, 2, 32), (2, 97, 2, 128),
                            (2, 65, 1, 256), (2, 33, 3, 20)]:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            qkv = _qkv(b, n, heads, hd, dtype, seed=b * n + hd)
            out = fa.cosine_attention_qkv_cuda(qkv, heads)
            torch.cuda.synchronize()
            _check(out, fa.cosine_attention_qkv_plain(qkv, heads), name, f"b={b} n={n} hd={hd} {name}")
    print("[3 kernel vs plain] odd shapes (n = 1, 33, 56, 65, 97, 300; hd = 20, 32, 64, 128, 256): ok",
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
    if counts != {256: 5, 64: 6}:
        fail(f"one forward launched {counts}, expected {{256: 5, 64: 6}}")
    if out.shape != x.shape or not torch.isfinite(out).all():
        fail(f"forward output {tuple(out.shape)} not finite or not {tuple(x.shape)}")
    err = rel_l2(out, ref)
    print(f"[4 one forward] CIFAR-10 EDM b={BATCH} bf16: 11 launches {counts}, "
          f"fused vs unfused rel L2 {err:.3g} (<= 1e-2)", flush=True)
    if not err <= 1e-2:
        fail(f"fused vs unfused forward rel L2 {err} > 1e-2")


def phase_heun(fused) -> dict[int, int]:
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
    if counts != {256: 5 * 63, 64: 6 * 63}:
        fail(f"Heun-32 launched {counts}, expected {{256: 315, 64: 378}}")
    if pngs != BATCH:
        fail(f"Heun-32 wrote {pngs} PNGs, expected {BATCH}")
    samples = torch.from_numpy(result["samples"])
    if not torch.isfinite(samples).all():
        fail("Heun-32 samples not finite")
    err = rel_l2(samples, torch.from_numpy(ref["samples"]))
    print(f"[5 heun-32] {BATCH} images at batch {BATCH}: {sum(counts.values())} launches {counts}, "
          f"{pngs} PNGs, {result['img_per_s']:.2f} img/s ({result['seconds']:.3f} s), "
          f"peak {result['peak_bytes'] / 2**30:.3f} GiB; unfused solve {ref['img_per_s']:.2f} img/s; "
          f"fused vs unfused samples rel L2 {err:.3g} (<= 2e-2)", flush=True)
    if not err <= 2e-2:
        fail(f"fused vs unfused Heun-32 samples rel L2 {err} > 2e-2")
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
    fused, unfused = _seeded_models()
    phase_forward(fused, unfused)
    del unfused
    counts = phase_heun(fused)
    for e in entries:
        e["launches"] = counts[int(e["name"].split("=")[1].rstrip("]"))]
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f}s", flush=True)
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
