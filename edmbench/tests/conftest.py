"""Fixtures of the benchmark's tests: a throwaway layout with a test-sized
configuration and two cells, made only of new files and entries, and the
look for a card (inside a fixture, never at import)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from edmbench.harness import ROOT, Layout

# the port's smoke model (experiments/conf/smoke.yaml): 16x16x3, 10 classes,
# widths 32-64, every block type, attention at 8x8 with 2 heads
SMOKE = {
    "name": "smoke",
    "source": "https://github.com/YichengDWu/tinyedm/blob/main/experiments/conf/smoke.yaml",
    "image_size": 16,
    "embedding": {"fourier_dim": 16, "embedding_dim": 32, "num_classes": 10},
    "denoiser": {
        "in_channels": 3, "out_channels": 3, "sigma_data": 0.5, "embedding_dim": 32,
        "encoder_block_types": ["Enc", "EncD", "EncA"],
        "decoder_block_types": ["DecA", "Dec", "DecU", "Dec", "Dec"],
        "encoder_out_channels": [32, 64, 64],
        "decoder_out_channels": [64, 64, 32, 32, 32],
        "skip_connections": [True, True, False, True, True],
        "num_heads": 2, "dropout_rate": 0.1, "dtype": "bfloat16",
    },
    "use_uncertainty": True,
    "training": {
        "batch_size": 8, "accum_steps": 2, "diffuser": {"P_mean": -0.4, "P_std": 1.0}, "lr": 0.01,
        "betas": [0.9, 0.999], "eps": 1e-08, "rampup_steps": 10, "steady_steps": 100,
        "scheduler_interval": "step", "full_lr_count": 20, "ema_lengths": [0.05, 0.13], "every_n_steps": 1,
    },
    "sampling": {"mean": [0.5, 0.5, 0.5], "std": [0.25, 0.25, 0.25]},
    "assumed": {}, "reduced": {},
}
# (cell, kind, params, the real cell whose limits it is held to)
SMOKE_CELLS = [
    ("smoke.train.b8", "train", {"batch": 8, "pool": 4, "check_steps": 3, "trace_units": 2},
     "cifar10.train.b256"),
    ("smoke.heun4.b4", "heun", {"batch": 4, "num_steps": 4, "pool": 2, "check_rows": 4,
                                "check_batches": 2, "trace_units": 1}, "cifar10.heun32.b128"),
]
RATE = {"train": "train_samples_per_s", "heun": "sample_img_per_s"}


def add_cell(root: Path, bench: dict, name: str, config: str, kind: str, params: dict, limits: dict) -> None:
    """A cell as a later change adds one: its file and its entries."""
    rate = RATE[kind]
    cell = {"config": config, "traffic": name.split(".", 1)[1], "kind": kind, "chips": 1,
            "why": "a test-sized cell", "rate_metric": rate, "params": params, "limits": limits}
    (root / "edmbench" / "workloads" / f"{name}.json").write_text(json.dumps(cell))
    bench["workloads"].append({k: cell[k] for k in ("config", "traffic", "chips", "why")} | {"name": name})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and rate in (m["name"], m.get("moves")):
            m["workloads"].append(name)


@pytest.fixture(scope="session")
def smoke_layout(tmp_path_factory) -> Layout:
    """A copy of the benchmark with the smoke configuration and its two
    cells added as new files and entries (no file of the copy edited but
    ``BENCHMARK.json``, as a later change would add its entries)."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "edmbench", root / "edmbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (root / "edmbench" / "configs" / "smoke.json").write_text(json.dumps(SMOKE))
    bench["configs"].append({"name": "smoke", "source": SMOKE["source"], "file": "edmbench/configs/smoke.json",
                             "reduced": [], "why": "test size"})
    for name, kind, params, like in SMOKE_CELLS:
        add_cell(root, bench, name, "smoke", kind, params, Layout().cell(like)["limits"])
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return Layout(root)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's attention kernels have no CPU mode")
    return torch.device("cuda", 0)
