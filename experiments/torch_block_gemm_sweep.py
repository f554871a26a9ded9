"""The bf16 whole-block attention backward's tensor-core GEMMs, on the card:
how their sums round, and what their launch choices cost.

    python experiments/torch_block_gemm_sweep.py [--splits 16,32,64,128]

Builds variants of ``csrc/attention_block_bwd.cu``, each from a copy of
``tinyedm_tpu_torch/csrc`` with a few lines of ``gemm_tc.cuh`` replaced (the
copies and their libraries go to ``tinyedm_tpu_torch/build/block_sweep/``):

- ``base``: the shipped GEMM, each mma step's products summed from zero
  on the tensor cores and added to the fp32 sums with one rounded add;
- ``one_accumulator``: the sums carried in the mma accumulators across a
  whole split of k;
- ``stages_2``, ``stages_4``: a ring of 2 or 4 k tiles in place of 3;
- ``bk_64``: k tiles of 64 in place of 32;
- ``one_block``: registers not capped at 128 a thread, so that one block
  takes an SM.

Each variant runs at ``chip_smoke.py``'s backward shapes (CIFAR-10 b 256, n 256 and 64,
C 256) and at C 768 (b 2, n 64, three seeds), and prints: the share of the
recomputed qkv's bf16 values that differ from the fp64 product rounded to
bf16 (and, beside it, the share for the plain version's fp32 product), the
relative L2 of dx, dWqkv and dWout to the plain version, and at the
CIFAR-10 shapes the device time per call (torch.profiler, 10 calls) in
turns: all variants, then all again in reverse order. ``--splits`` adds the
base variant with other counts of the weight gradients' split reduction
(the wrapper's, as ``fused_attention.attention_block_bwd_cuda`` counts them: one per 1024
rows, at most 64).

Needs a CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from tinyedm_tpu_torch.ops import fused_attention as fa  # noqa: E402
from tinyedm_tpu_torch.ops._build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc  # noqa: E402
from tinyedm_tpu_torch.utils.cuda import resolve_device  # noqa: E402

GEMM = "gemm_tc.cuh"
# variant -> (source file, text, replacement) edits of the copied sources
VARIANTS = {
    "base": [],
    "one_accumulator": [
        (GEMM, "mma::mma_bf16(t0, af", "mma::mma_bf16(acc[mi][2 * nj], af"),
        (GEMM, "mma::mma_bf16(t1, af", "mma::mma_bf16(acc[mi][2 * nj + 1], af"),
        (GEMM, "acc[mi][2 * nj][i] = __fadd_rn(acc[mi][2 * nj][i], t0[i]);", "(void)t0;"),
        (GEMM, "acc[mi][2 * nj + 1][i] = __fadd_rn(acc[mi][2 * nj + 1][i], t1[i]);", "(void)t1;"),
    ],
    "stages_2": [(GEMM, "constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    "stages_4": [(GEMM, "constexpr int kStages = 3;", "constexpr int kStages = 4;")],
    "bk_64": [(GEMM, "constexpr int kBK = 32;", "constexpr int kBK = 64;")],
    "one_block": [(GEMM, "__launch_bounds__(kThreads, 2)\n    gemm_tc_kernel(",
                   "__launch_bounds__(kThreads)\n    gemm_tc_kernel(")],
}
SWEEP = BUILD_DIR / "block_sweep"


def build(variant: str) -> ctypes.CDLL:
    d = SWEEP / variant
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d)
    for name, old, new in VARIANTS[variant]:
        text = (d / name).read_text()
        if old not in text:
            raise ValueError(f"{variant}: {old!r} not in {name}")
        (d / name).write_text(text.replace(old, new))
    out = d / "libattention_block_bwd.so"
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(out), str(d / "attention_block_bwd.cu")],
                   check=True)
    dll = ctypes.CDLL(str(out))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.attention_block_bwd.argtypes = [ptr] * 13 + [i32] * 6 + [f32] * 3 + [ptr]
    return dll


def run(dll, x, wq, wo, g, heads: int, splits: int):
    """The library's block backward with scratch held here: -> (dx, dWqkv,
    dWout, the recomputed qkv)."""
    b, n, c = x.shape
    hd = c // heads
    dev = x.device
    dx = torch.empty_like(x)
    dwqkv = torch.empty((c, 3 * c), dtype=torch.float32, device=dev)
    dwout = torch.empty((c, c), dtype=torch.float32, device=dev)
    qkv, dqkv = (torch.empty((b, n, 3 * c), dtype=x.dtype, device=dev) for _ in range(2))
    y, dy = (torch.empty_like(x) for _ in range(2))
    stats = torch.empty((2, b, heads, n), dtype=torch.float32, device=dev)
    partials = torch.empty((splits, c, 3 * c), dtype=torch.float32, device=dev)
    ts = fa._residual_constants(x.dtype)[2]
    err = dll.attention_block_bwd(
        *(t.data_ptr() for t in (x, wq, wo, g, dx, dwqkv, dwout, qkv, y, dy, dqkv, stats, partials)),
        splits, b, n, heads, hd, 1, float(np.float32(1 / math.sqrt(hd))),
        float(np.float32(math.sqrt(hd))), ts, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"attention_block_bwd: error {err}")
    return dx, dwqkv, dwout, qkv


def device_ms(fn, iters: int = 10) -> dict[str, float]:
    """Device time per call by kernel (its name without namespaces and
    arguments), from the profiler."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        t = ev.cuda_time_total if t is None else t
        if t > 0:
            name = re.sub(r"^void |\(anonymous namespace\)::|\w+::|\(.*$", "", ev.key)
            out[name] = out.get(name, 0.0) + t / iters / 1e3
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--splits", default="", help="comma-separated split counts for the base variant")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    resolve_device("cuda")
    print(cs.phase_environment(), flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:  # nvcc runs outside the GIL
        libs = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    # (label, library, splits or None for the wrapper's)
    routes = [(v, libs[v], None) for v in VARIANTS]
    routes += [(f"base splits={s}", libs["base"], int(s)) for s in args.splits.split(",") if s]
    shapes = [(256, 256, cs.HEADS, cs.BLOCK_C, 0), (256, 64, cs.HEADS, cs.BLOCK_C, 0)]
    shapes += [(2, 64, 4, 768, seed) for seed in range(3)]
    for b, n, heads, c, seed in shapes:
        x, wq, wo, g = cs._block_inputs(b, n, c, torch.bfloat16, seed=b * n + c + seed)
        refs = fa.attention_block_bwd_plain(x, wq, wo, g, heads)
        qkv64 = (x.double() @ wq.double()).to(x.dtype)
        plain_flips = float((torch.matmul(x.float(), wq.float()).to(x.dtype) != qkv64).float().mean())
        wrapper_splits = min(64, -(-b * n // 1024))  # as the wrapper counts them
        print(f"b={b} n={n} heads={heads} C={c} seed={seed}: plain fp32 qkv flips {plain_flips:.3g}",
              flush=True)
        times = {}
        for label, dll, splits in routes + routes[::-1]:
            splits = splits or wrapper_splits

            def call():
                return run(dll, x, wq, wo, g, heads, splits)

            if label not in times:
                *grads, qkv = call()
                torch.cuda.synchronize()
                flips = float((qkv != qkv64).float().mean())
                rels = [cs.rel_l2(d, r) for d, r in zip(grads, refs)]
                print(f"  {label}: qkv flips {flips:.3g}; rel L2 dx {rels[0]:.3g} dWqkv {rels[1]:.3g} "
                      f"dWout {rels[2]:.3g}", flush=True)
                times[label] = []
            if b >= 256:
                times[label].append(device_ms(call))
        if b >= 256:
            for label, ts in times.items():
                print(f"  {label}: device ms per call "
                      + " | ".join(f"{sum(t.values()):.4f}" for t in ts), flush=True)
            parts = ", ".join(f"{k} {v:.4f}" for k, v in sorted(times["base"][0].items()))
            print(f"  base by kernel: {parts}", flush=True)
        del x, wq, wo, g, refs, qkv64
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
