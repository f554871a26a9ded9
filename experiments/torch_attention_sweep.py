"""Where the bf16 fused cosine-attention kernels' time goes, on the card.

    python experiments/torch_attention_sweep.py [--variants base,no_norm,...]

Builds variants of ``csrc/cosine_attention_{fwd,bwd}.cu``, each from a copy
of ``tinyedm_tpu_torch/csrc`` with a few source lines replaced (the copies
and their libraries go to ``tinyedm_tpu_torch/build/sweep/``), runs each at
the sampling (forward) and training (backward) shapes of ``chip_smoke.py``
and prints the device time per call of every kernel, from torch.profiler
over 20 calls (10 for the backward), in turns: all variants, then all again
in reverse order. Two kinds of variant:

- launch policies (``rows_128``, ``rows_64``: query rows per block of the
  forward and of pass (a); ``two_per_sm``: key chunks small enough for
  two blocks on an SM at every head dim; ``qtile_32``, ``qtile_64``: query
  tiles of pass (b)):
  other block shapes or key chunks, same results, checked against the
  plain versions at chip_smoke.py's gates;
- diagnostics (``no_norm``, ``no_exp``, ``no_products``): a piece of the
  work left out (the pixel norm of staged rows, the exp of the logits, the
  tensor-core products), so their results are wrong and not checked; the
  time they save is what that piece costs.

Needs a CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import math
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

FWD, BWD = "cosine_attention_fwd.cuh", "cosine_attention_bwd.cuh"
# variant -> (source file, text, replacement) edits of the copied sources
VARIANTS = {
    "base": [],
    "rows_128": [(FWD, "block_rows(n, max_threads<HDB>() / 2);", "block_rows(n, 128);"),
                 (BWD, "block_rows(n, max_threads<HDB>() / 2), chunk",
                  "block_rows(n, 128), chunk")],
    "rows_64": [(FWD, "block_rows(n, max_threads<HDB>() / 2);", "block_rows(n, 64);"),
                (BWD, "block_rows(n, max_threads<HDB>() / 2), chunk", "block_rows(n, 64), chunk")],
    "two_per_sm": [(FWD, "HDB <= 64 ? kTwoPerSm : kOnePerSm, &chunk);", "kTwoPerSm, &chunk);"),
                   (BWD, "const size_t budget = HDB <= 64 ? kTwoPerSm : kOnePerSm;",
                    "const size_t budget = kTwoPerSm;")],
    "qtile_32": [(BWD, "dkv_bytes(64) <= (size_t)kTwoPerSm ? 64 : 32", "32")],
    "qtile_64": [(BWD, "dkv_bytes(64) <= (size_t)kTwoPerSm ? 64 : 32", "64")],
    "no_norm": [(FWD, "normalize_row(row, row, hdp, scale);", "(void)row;"),
                (BWD, "normalize_row(", "if (0) normalize_row("),
                (BWD, "scale_row(", "if (0) scale_row(")],
    "no_exp": [(FWD, "expf(__fmul_rn(", "(__fmul_rn("), (BWD, "expf(__fmul_rn(", "(__fmul_rn(")],
    "no_products": [(FWD, "    if (!active) continue;", "    continue;"),
                    (BWD, "    if (!active) continue;", "    continue;")],
}
DIAGNOSTIC = {"no_norm", "no_exp", "no_products"}
LIBS = ("cosine_attention_fwd", "cosine_attention_bwd")


def build(variant: str, lib: str) -> ctypes.CDLL:
    out = BUILD_DIR / "sweep" / variant / f"lib{lib}.so"
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(out), str(out.parent / f"{lib}.cu")],
                   check=True)
    dll = ctypes.CDLL(str(out))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if lib == "cosine_attention_fwd":
        dll.cosine_attention_fwd.argtypes = [ptr] * 2 + [i32] * 6 + [f32, ptr]
    else:
        dll.cosine_attention_bwd.argtypes = [ptr] * 5 + [i32] * 6 + [f32] * 2 + [ptr]
    return dll


def copy_sources(variant: str) -> None:
    d = BUILD_DIR / "sweep" / variant
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d)
    for name, old, new in VARIANTS[variant]:
        text = (d / name).read_text()
        if old not in text:
            raise ValueError(f"{variant}: {old!r} not in {name}")
        (d / name).write_text(text.replace(old, new))


def fwd(dll, qkv):
    b, n, c3 = qkv.shape
    hd = c3 // 3 // cs.HEADS
    out = torch.empty((b, n, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    err = dll.cosine_attention_fwd(qkv.data_ptr(), out.data_ptr(), b, n, cs.HEADS, hd, 1, 0,
                                   float(np.float32(1 / math.sqrt(hd))),
                                   torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"cosine_attention_fwd: error {err}")
    return out


def bwd(dll, qkv, g, o):
    b, n, c3 = qkv.shape
    hd = c3 // 3 // cs.HEADS
    d = torch.empty_like(qkv)
    stats = torch.empty((2, b, cs.HEADS, n), dtype=torch.float32, device=qkv.device)
    err = dll.cosine_attention_bwd(qkv.data_ptr(), g.data_ptr(), o.data_ptr(), d.data_ptr(),
                                   stats.data_ptr(), b, n, cs.HEADS, hd, 1, 0,
                                   float(np.float32(1 / math.sqrt(hd))),
                                   float(np.float32(math.sqrt(hd))),
                                   torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"cosine_attention_bwd: error {err}")
    return d


def device_ms(fn, iters: int) -> dict[str, float]:
    """Device time per call by kernel (the name's last component), from the profiler."""
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
        if t > 0 and "_tc_kernel" in ev.key:
            out[ev.key.split("<")[0].split("::")[-1]] = t / iters / 1e3
    return out


def fmt(times: dict[str, float]) -> str:
    parts = " + ".join(f"{k} {v:.4f}" for k, v in sorted(times.items()))
    return f"{parts} = {sum(times.values()):.4f}"


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--variants", default=",".join(VARIANTS))
    args = parser.parse_args()
    variants = args.variants.split(",")
    if "base" not in variants:
        variants.insert(0, "base")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    resolve_device("cuda")
    print(cs.phase_environment(), flush=True)
    for v in variants:
        copy_sources(v)
    jobs = [(v, lib) for v in variants for lib in LIBS]
    with ThreadPoolExecutor(min(8, len(jobs))) as pool:  # nvcc runs outside the GIL
        libs = dict(zip(jobs, pool.map(lambda j: build(*j), jobs)))
    for (config, b, n, hd, _), (_, bb, _, _, _) in zip(cs.FWD_SHAPES, cs.BWD_SHAPES):
        qkv = cs._qkv(b, n, cs.HEADS, hd, torch.bfloat16, seed=n + hd)
        ref = fa.cosine_attention_qkv_plain(qkv, cs.HEADS)
        times = {}
        for v in variants + variants[::-1]:
            dll = libs[v, "cosine_attention_fwd"]
            if v not in DIAGNOSTIC:
                cs._check(fwd(dll, qkv), ref, "bfloat16", f"{v} fwd {config} n={n}")
            times.setdefault(v, []).append(device_ms(lambda: fwd(dll, qkv), 20))
        for v, ts in times.items():
            print(f"fwd {config} b={b} n={n} hd={hd} {v}: " + " | ".join(map(fmt, ts)), flush=True)
        qkv = cs._qkv(bb, n, cs.HEADS, hd, torch.bfloat16, seed=n + hd)
        g = cs._cotangent(bb, n, cs.HEADS, hd, torch.bfloat16, seed=n + hd)
        o = fa.cosine_attention_qkv_cuda(qkv, cs.HEADS)
        ref = fa.cosine_attention_qkv_bwd_plain(qkv, g, o, cs.HEADS)
        times = {}
        for v in variants + variants[::-1]:
            dll = libs[v, "cosine_attention_bwd"]
            if v not in DIAGNOSTIC:
                cs._check_bwd(bwd(dll, qkv, g, o), ref, "bfloat16", f"{v} bwd {config} n={n}")
            times.setdefault(v, []).append(device_ms(lambda: bwd(dll, qkv, g, o), 10))
        for v, ts in times.items():
            print(f"bwd {config} b={bb} n={n} hd={hd} {v}: " + " | ".join(map(fmt, ts)), flush=True)
        del ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
