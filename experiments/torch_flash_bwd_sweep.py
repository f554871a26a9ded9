"""Where the bf16 tensor-core flash backward's time goes, on the card.

    python experiments/torch_flash_bwd_sweep.py [--variants base,no_lo,...]

Builds variants of ``csrc/flash_attention_bwd.cu``, each from a copy of
``tinyedm_tpu_torch/csrc`` with a few source lines replaced (the copies and
their libraries go to ``tinyedm_tpu_torch/build/flash_sweep/``), runs each
at ``chip_smoke.py``'s ImageNet-512 widths (b 32, 4 heads; n 1024, hd 96 and
n 4096, hd 48) and prints the device time per call of its two kernels, pass
(a) (dq) and pass (b) (dk, dv), from torch.profiler over 3 calls, in turns:
all variants, then all again in reverse order. ``base`` and ``step_add``
compute the function; for them it also prints the worst relative L2 of dq,
dk and dv to ``flash_attention_bwd_plain`` (at batch 8 at n 4096, as
``chip_smoke.py`` checks); for every variant, ptxas's registers and spills
of the tensor-core kernels. The other variants are diagnostics: a piece of
the work left out, so their results are wrong and not checked; the time
they save is what that piece costs.

- ``step_add``: each k16 step's dq, dk or dv products (hi and lo) summed
  from zero on the tensor cores and added to the fp32 sums with one
  correctly rounded add, as ``gemm_tc.cuh`` does, instead of carried across
  the whole sweep in the mma accumulators;
- ``no_lo``: the lo halves of the hi + lo pairs of p and ds left out (the
  dq, dk and dv products run once, on hi);
- ``no_exp``: the exp of the logits left out;
- ``no_delta``: pass (a)'s first sweep over the keys (delta) left out.

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
from tinyedm_tpu_torch.ops import attention as fl  # noqa: E402
from tinyedm_tpu_torch.ops._build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc  # noqa: E402
from tinyedm_tpu_torch.utils.cuda import resolve_device  # noqa: E402

SRC = "flash_attention_bwd.cu"
# variant -> (text, replacement) edits of the copied flash_attention_bwd.cu
VARIANTS = {
    "base": [],
    "step_add": [("""    mma::mma_bf16(acc[2 * d2], hi, bf[0], bf[1]);
    mma::mma_bf16(acc[2 * d2 + 1], hi, bf[2], bf[3]);
    mma::mma_bf16(acc[2 * d2], lo, bf[0], bf[1]);
    mma::mma_bf16(acc[2 * d2 + 1], lo, bf[2], bf[3]);
""", """    float t0[4] = {}, t1[4] = {};
    mma::mma_bf16(t0, hi, bf[0], bf[1]);
    mma::mma_bf16(t1, hi, bf[2], bf[3]);
    mma::mma_bf16(t0, lo, bf[0], bf[1]);
    mma::mma_bf16(t1, lo, bf[2], bf[3]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * d2][i] = __fadd_rn(acc[2 * d2][i], t0[i]);
      acc[2 * d2 + 1][i] = __fadd_rn(acc[2 * d2 + 1][i], t1[i]);
    }
""")],
    "no_lo": [("    mma::mma_bf16(acc[2 * d2], lo, bf[0], bf[1]);\n", ""),
              ("    mma::mma_bf16(acc[2 * d2 + 1], lo, bf[2], bf[3]);\n", "")],
    "no_exp": [("div_rn(expf(", "div_rn((")],
    "no_delta": [("for (int it = 0; it < 2 * tiles; ++it) {", "for (int it = tiles; it < 2 * tiles; ++it) {")],
}
CORRECT = ("base", "step_add")  # the variants that compute the function
SHAPES = [(1024, 96), (4096, 48)]


def build(variant: str) -> ctypes.CDLL:
    d = BUILD_DIR / "flash_sweep" / variant
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d)
    text = (d / SRC).read_text()
    for old, new in VARIANTS[variant]:
        if old not in text:
            raise ValueError(f"{variant}: {old!r} not in {SRC}")
        text = text.replace(old, new)
    (d / SRC).write_text(text)
    out = d / "libflash_attention_bwd.so"
    done = subprocess.run([_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out), str(d / SRC)],
                          capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"{variant}: nvcc failed\n{done.stdout}{done.stderr}")
    report, kernel = [], None  # ptxas's spills and registers of the tensor-core kernels
    for line in (done.stdout + done.stderr).splitlines():
        if "Compiling entry function" in line:
            kernel = m.group(1) if (m := re.search(r"(flash_bwd_\w+_tc_kernelILi\d+)", line)) else None
        elif kernel and re.search(r"spill stores|Used \d+ registers", line):
            report.append(f"{kernel}: {line.split('ptxas info    :')[-1].strip()}")
    dll = ctypes.CDLL(str(out))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.flash_attention_bwd.argtypes = [ptr] * 9 + [i32] * 4 + [i64] * 2 + [i32, i32, ctypes.c_float, ptr]
    return dll, report


def bwd(dll, q, k, v, g, stats):
    """The library's backward on the views of one (b, n, 3, heads, hd) tensor."""
    b, n, heads, hd = q.shape
    dq, dk, dv = (torch.empty((b, n, heads, hd), dtype=q.dtype, device=q.device) for _ in range(3))
    delta = torch.empty((b, heads, n), dtype=torch.float32, device=q.device)
    st = q.stride()
    err = dll.flash_attention_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                                  stats.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                                  dv.data_ptr(), b, n, heads, hd, st[0], st[1], 1, 0,
                                  float(np.float32(1 / math.sqrt(hd))),
                                  torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd: error {err}")
    return dq, dk, dv


def device_ms(fn, iters: int = 3) -> dict[str, float]:
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
    with ThreadPoolExecutor(len(variants)) as pool:  # nvcc runs outside the GIL
        built = dict(zip(variants, pool.map(build, variants)))
    libs = {variant: dll for variant, (dll, _) in built.items()}
    for variant, (_, report) in built.items():
        for line in report:
            print(f"ptxas {variant} {line}", flush=True)
    for n, hd in SHAPES:
        check_b = cs.FLASH_BATCH if n <= 1024 else 8
        q, k, v, g = cs._flash_inputs(check_b, n, cs.HEADS, hd, torch.bfloat16, seed=n + hd)
        _, stats = fl.flash_attention_fwd_cuda(q, k, v)
        ref = fl.flash_attention_bwd_plain(q, k, v, g)
        for variant in (x for x in variants if x in CORRECT):
            got = bwd(libs[variant], q, k, v, g, stats)
            rel = max(cs.rel_l2(d, r) for d, r in zip(got, ref))
            print(f"flash bwd b={check_b} n={n} hd={hd} {variant}: worst rel_l2 to plain {rel:.4g}", flush=True)
        del q, k, v, g, stats, ref, got
        torch.cuda.empty_cache()
        q, k, v, g = cs._flash_inputs(cs.FLASH_BATCH, n, cs.HEADS, hd, torch.bfloat16, seed=n + hd)
        _, stats = fl.flash_attention_fwd_cuda(q, k, v)
        times = {}
        for variant in variants + variants[::-1]:
            times.setdefault(variant, []).append(
                device_ms(lambda: bwd(libs[variant], q, k, v, g, stats)))
        for variant, ts in times.items():
            parts = " | ".join(" + ".join(f"{name} {ms:.4f}" for name, ms in sorted(t.items()))
                               + f" = {sum(t.values()):.4f}" for t in ts)
            print(f"flash bwd b={cs.FLASH_BATCH} n={n} hd={hd} {variant}: {parts}", flush=True)
        del q, k, v, g, stats
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
