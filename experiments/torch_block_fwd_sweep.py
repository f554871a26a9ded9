"""The bf16 whole-block attention forward on the card: its variants' times
and how their sums round.

    python experiments/torch_block_fwd_sweep.py

Builds variants of ``csrc/attention_block_fwd.cu``, each from a copy of
``tinyedm_tpu_torch/csrc`` with a few lines replaced (the copies and their
libraries go to ``tinyedm_tpu_torch/build/block_fwd_sweep/``):

- ``A``: as shipped: the qkv GEMM and the out GEMM on ``gemm_tc.cuh``
  (64-row tiles where a block's range of k is at most 256, else 128-row
  ones), the attention core between them;
- ``A rows_128``, ``A rows_64``: the GEMMs always on 128-row, or always on
  64-row tiles; ``A grid``: 64-row tiles where 128-row ones give fewer
  blocks than two per SM; ``A rows_64 3perSM``: always 64-row tiles,
  registers capped for three blocks per SM;
- ``B``: qkv kept on chip, ``experiments/torch_block_fwd_onchip.cuh``: one
  block per (sample, head) computes its q, k and v into shared memory and
  runs the attention core there; the out GEMM as in A. Where it does not
  fit (hd > 64, n > 256) B runs A.

Each runs at ``chip_smoke.py``'s forward shapes (CIFAR-10 b 128, n 256 and
64, C 256, 4 heads) and, for the numerics, at C 768 (b 2, n 64; 4 heads of
192, where B runs A, and 12 heads of 64; three seeds), and prints the
relative L2 and the largest difference in bf16 ulps of max(1, |ref|) to
the plain version, and at the CIFAR-10 shapes the device time per call
(torch.profiler, 10 calls) in turns: all variants, then all again in
reverse order. The A tilings also run the block backward at its CIFAR-10
shapes (b 256), since it shares the GEMM.

Needs a CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

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

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from experiments.torch_block_gemm_sweep import device_ms  # noqa: E402
from experiments.torch_block_gemm_sweep import run as run_bwd  # noqa: E402
from tinyedm_tpu_torch.ops import fused_attention as fa  # noqa: E402
from tinyedm_tpu_torch.ops._build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc  # noqa: E402
from tinyedm_tpu_torch.utils.cuda import resolve_device  # noqa: E402

GEMM, FWD = "gemm_tc.cuh", "attention_block_fwd.cu"
ONCHIP = Path(__file__).resolve().parent / "torch_block_fwd_onchip.cuh"
POLICY = "if (k_chunk <= 8 * kBK)"
# 64-row tiles where 128-row ones would give fewer blocks than two per SM
GRID_RULE = """int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if ((long long)((M + kBM<4> - 1) / kBM<4>) * ((N + kBN - 1) / kBN) * splits < 2LL * sms)"""
QKV_AND_CORE = """  cudaError_t err = gemm_tc::product<T, false, false, gemm::kRound>(
      x, c, 1.f, wqkv, 3 * c, 1.f, m, 3 * c, c, 1, qkv, nullptr, 0.f, 0.f, stream);
  if (err != cudaSuccess) return err;
  err = cosine_attention::attention_fwd<T>(qkv, y, b, n, heads, hd, scale, stream);
  if (err != cudaSuccess) return err;
"""
ONCHIP_OR_A = """  cudaError_t err = cudaErrorNotSupported;
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    err = block_fwd_onchip::launch(x, wqkv, y, b, n, heads, hd, scale, stream);
  if (err == cudaErrorNotSupported) {
    err = gemm_tc::product<T, false, false, gemm::kRound>(
        x, c, 1.f, wqkv, 3 * c, 1.f, m, 3 * c, c, 1, qkv, nullptr, 0.f, 0.f, stream);
    if (err != cudaSuccess) return err;
    err = cosine_attention::attention_fwd<T>(qkv, y, b, n, heads, hd, scale, stream);
  }
  if (err != cudaSuccess) return err;
"""
# variant -> (source file, text, replacement) edits of the copied sources
VARIANTS = {
    "A": [],
    "A rows_128": [(GEMM, POLICY, "if (false)")],
    "A rows_64": [(GEMM, POLICY, "if (true)")],
    "A grid": [(GEMM, POLICY, GRID_RULE)],
    "A rows_64 3perSM": [(GEMM, POLICY, "if (true)"),
                         (GEMM, "__launch_bounds__(kThreads, 2)\n    gemm_tc_kernel(",
                          "__launch_bounds__(kThreads, kMI == 4 ? 2 : 3)\n    gemm_tc_kernel(")],
    "B": [(FWD, '#include "gemm_tc.cuh"', '#include "gemm_tc.cuh"\n#include "torch_block_fwd_onchip.cuh"'),
          (FWD, QKV_AND_CORE, ONCHIP_OR_A)],
}
TILINGS = tuple(v for v in VARIANTS if v.startswith("A"))  # also built and timed in the backward
SWEEP = BUILD_DIR / "block_fwd_sweep"
BWD_SHAPES = [(256, 256), (256, 64)]


def _nvcc_build(d: Path, name: str) -> ctypes.CDLL:
    out = d / f"lib{name}.so"
    done = subprocess.run([_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out), str(d / f"{name}.cu")],
                          capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed on {d.name}/{name}.cu:\n{done.stdout}{done.stderr}")
    entry = ""  # registers and spills of the tensor-core GEMMs and of B's kernel
    for line in (done.stdout + done.stderr).splitlines():
        found = re.search(r"Compiling entry function '(\w+)'", line)
        if found:
            entry = found.group(1) if re.search("gemm_tc_kernel|onchip", line) else ""
        elif entry and re.search(r"spill stores|Used \d+ registers", line):
            print(f"  ptxas {d.name}/{name} {entry[-60:]}: {line.strip()}", flush=True)
    return ctypes.CDLL(str(out))


def build(variant: str) -> dict[str, ctypes.CDLL]:
    d = SWEEP / variant.replace(" ", "_")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d)
    shutil.copy(ONCHIP, d)
    for name, old, new in VARIANTS[variant]:
        text = (d / name).read_text()
        if old not in text:
            raise ValueError(f"{variant}: {old!r} not in {name}")
        (d / name).write_text(text.replace(old, new))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = {"fwd": _nvcc_build(d, "attention_block_fwd")}
    libs["fwd"].attention_block_fwd.argtypes = [ptr] * 6 + [i32] * 5 + [f32] * 3 + [ptr]
    if variant in TILINGS:
        libs["bwd"] = _nvcc_build(d, "attention_block_bwd")
        libs["bwd"].attention_block_bwd.argtypes = [ptr] * 13 + [i32] * 6 + [f32] * 3 + [ptr]
    return libs


def run_fwd(dll, x, wq, wo, heads: int):
    """The library's block forward with scratch held here."""
    b, n, c = x.shape
    hd = c // heads
    qkv = torch.empty((b, n, 3 * c), dtype=x.dtype, device=x.device)
    y, out = torch.empty_like(x), torch.empty_like(x)
    t, s, _ = fa._residual_constants(x.dtype)
    err = dll.attention_block_fwd(
        *(v.data_ptr() for v in (x, wq, wo, qkv, y, out)), b, n, heads, hd, 1,
        float(np.float32(1 / math.sqrt(hd))), t, s, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"attention_block_fwd: error {err}")
    return out


def ulps(out, ref) -> float:
    """The largest difference in bf16 ulps of max(1, |ref|)."""
    diff = (out.float() - ref.float()).abs() / ref.float().abs().clamp(min=1.0)
    return float(diff.max()) / 2.0**-7


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    resolve_device("cuda")
    print(cs.phase_environment(), flush=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:  # nvcc runs outside the GIL
        libs = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    shapes = [(128, 256, cs.HEADS, cs.BLOCK_C, 0), (128, 64, cs.HEADS, cs.BLOCK_C, 0)]
    shapes += [(2, 64, heads, 768, seed) for heads in (4, 12) for seed in range(3)]
    for b, n, heads, c, seed in shapes:
        x, wq, wo, _ = cs._block_inputs(b, n, c, torch.bfloat16, seed=b * n + c + seed)
        ref = fa.attention_block_plain(x, wq, wo, heads)
        print(f"forward b={b} n={n} heads={heads} C={c} seed={seed}", flush=True)
        times = {}
        for label in list(VARIANTS) + list(VARIANTS)[::-1]:
            def call():
                return run_fwd(libs[label]["fwd"], x, wq, wo, heads)

            if label not in times:
                out = call()
                torch.cuda.synchronize()
                print(f"  {label}: rel L2 {cs.rel_l2(out, ref):.3g}, max {ulps(out, ref):.3g} ulps, "
                      f"finite {bool(torch.isfinite(out.float()).all())}", flush=True)
                times[label] = []
            if b >= 128:
                times[label].append(device_ms(call))
        if b >= 128:
            for label, ts in times.items():
                print(f"  {label}: device ms per call " + " | ".join(f"{sum(t.values()):.4f}" for t in ts),
                      flush=True)
            for label in times:
                parts = ", ".join(f"{k} {v:.4f}" for k, v in sorted(times[label][0].items()))
                print(f"  {label} by kernel: {parts}", flush=True)
        del x, wq, wo, ref
        torch.cuda.empty_cache()
    # the backward shares gemm_tc.cuh: the three tilings there
    for b, n in BWD_SHAPES:
        c = cs.BLOCK_C
        x, wq, wo, g = cs._block_inputs(b, n, c, torch.bfloat16, seed=n + b)
        refs = fa.attention_block_bwd_plain(x, wq, wo, g, cs.HEADS)
        splits = min(64, -(-b * n // 1024))
        print(f"backward b={b} n={n} C={c}", flush=True)
        times = {}
        order = list(TILINGS)
        for label in order + order[::-1]:
            def call():
                return run_bwd(libs[label]["bwd"], x, wq, wo, g, cs.HEADS, splits)

            if label not in times:
                *grads, _ = call()
                torch.cuda.synchronize()
                rels = [cs.rel_l2(d, r) for d, r in zip(grads, refs)]
                print(f"  {label}: rel L2 dx {rels[0]:.3g} dWqkv {rels[1]:.3g} dWout {rels[2]:.3g}", flush=True)
                times[label] = []
            times[label].append(device_ms(call))
        for label, ts in times.items():
            print(f"  {label}: device ms per call " + " | ".join(f"{sum(t.values()):.4f}" for t in ts),
                  flush=True)
        for label in times:
            parts = ", ".join(f"{k} {v:.4f}" for k, v in sorted(times[label][0].items()))
            print(f"  {label} by kernel: {parts}", flush=True)
        del x, wq, wo, g, refs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
