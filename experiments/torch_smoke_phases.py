"""Run the workflow phases of chip_smoke.py alone on the card.

    python experiments/torch_smoke_phases.py [9] [12] [24] [25] [26] [28] [29] [30] [32] [33] [34] [36] [37] [38] [39] [41]

Phases 1 (environment) and 2 (the kernels' build), the bare train steps
that phases 24, 25, 26, 34 and 39 are read against (12: ImageNet-512, 23:
ImageNet-64, 9: CIFAR-10; only when one of them is named), then the phases
named (all but 9 and 12 by default): 9 and 12, those bare train steps alone
(CIFAR-10 and ImageNet-512, with their kernels' launches); 24, the CIFAR-10
run loop through the CLI; 25,
ImageNet-64 through the CLI at 3 x 176; 26, ImageNet-512 through the CLI on
a latpack store with its decoded previews (31), followed by 27, post-hoc
EMA over its checkpoints and sampling from it; 28, FID on CIFAR-10; 29, the
SD VAE at full width; 30, latent extraction through the CLI; 32, reference
(Lightning) checkpoints at full width; 33, remat, the bf16 island and
fused="on"; 34, data parallelism and ZeRO-1 over ranks, followed by 35,
train --multihost under torch.distributed.run and generate on two ranks
(phase 24's loop, beside which 34 and 39 print, runs here only when named);
36, tensor parallelism over ranks sharing the card, followed by 40, the
collective-audit CLI's function (run in 36 (a)'s ranks); 37, the reference
API on the card; 38, validate_learning's two runs and rows 2 and 4 at its
shapes; 39, the soak at the CIFAR-10 recipe, stopped and resumed; 41,
weight_norm_cast and its backward against their plain versions, their times,
and the launches in Heun-2 solves and CIFAR-10 train steps. Each
phase prints its lines and gates as in chip_smoke.py, and its seconds.
Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tinyedm_tpu_torch.utils.cuda import resolve_device  # noqa: E402


def main(phases: list[str]) -> None:
    print(subprocess.run("df -h /tmp .; free -g; nproc", shell=True, capture_output=True, text=True).stdout,
          flush=True)
    resolve_device("cuda")  # fp32 without TF32
    t0 = time.perf_counter()
    smi = cs.phase_environment()
    cs.phase_build()
    bare = {}
    if "26" in phases:
        bare["26"] = cs.phase_train("12", "imagenet512")
        torch.cuda.empty_cache()
    if "25" in phases:
        bare["25"] = cs.phase_train("23", "imagenet", eval_profiles=1)
        torch.cuda.empty_cache()
    if {"24", "34", "39"} & set(phases):
        bare["34"] = cs.phase_train("9", "cifar10")
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as vae_tmp:
        vae_files = cs.write_vae_files(Path(vae_tmp))
        for name in phases:
            t = time.perf_counter()
            if name in ("9", "12"):
                print(cs.phase_train(name, {"9": "cifar10", "12": "imagenet512"}[name]))
            elif name == "24":
                print(cs.phase_run_loop(smi, bare["34"]))
            elif name == "25":
                print(cs.phase_imagenet64_cli(smi, bare["25"]))
            elif name == "26":
                with tempfile.TemporaryDirectory() as tmp:
                    run = cs.phase_imagenet512_cli(smi, bare["26"], Path(tmp), vae_files)
                    print(run["per_step"])
                    t27 = time.perf_counter()
                    cs.phase_posthoc(smi, run["run"], run["steps"], Path(tmp))
                    print(f"[phases] phase 27 {time.perf_counter() - t27:.1f} s", flush=True)
            elif name == "28":
                cs.phase_fid(smi)
            elif name == "29":
                cs.phase_vae(smi, vae_files)
            elif name == "30":
                with tempfile.TemporaryDirectory() as tmp:
                    cs.phase_extract(smi, vae_files, Path(tmp))
            elif name == "32":
                with tempfile.TemporaryDirectory() as tmp:
                    cs.phase_reference_checkpoints(smi, Path(tmp))
            elif name == "33":
                print(cs.phase_knobs(smi))
            elif name == "34":
                cs.phase_data_parallel(smi, None, bare["34"])
            elif name == "36":
                _, ranks = cs.phase_tensor_parallel(smi)
                t40 = time.perf_counter()
                cs.phase_collective_audit(smi, ranks)
                print(f"[phases] phase 40 {time.perf_counter() - t40:.1f} s", flush=True)
            elif name == "37":
                cs.phase_api(smi)
            elif name == "38":
                print(cs.phase_validate_learning(smi))
            elif name == "39":
                cs.phase_soak(smi, bare["34"], None)
            elif name == "41":
                print(cs.phase_weight_norm())
            else:
                raise SystemExit(f"unknown phase {name} (9, 12, 24, 25, 26, 28, 29, 30, 32, 33, 34, 36, 37, 38, 39 or 41)")
            torch.cuda.empty_cache()
            print(f"[phases] phase {name} {time.perf_counter() - t:.1f} s", flush=True)
    print(f"[phases] done in {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["25", "26", "28", "29", "30", "32", "33", "34"])
