"""What every cell shares: finding its files by name, seeds, the port's
model built from a configuration file, and the comparisons of ``correct``.

Every piece is found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``workloads/<cell>.json``, ``traffic/<kind>.py``
(the kind the cell file names) and ``metrics/<metric>.py``, all under
``edmbench/`` of the checkout. Nothing here knows a cell, a kind or a metric.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import math
import statistics
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parent.parent


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where the benchmark's files live: ``root`` holds ``BENCHMARK.json``
    and ``edmbench/``."""

    root: Path = ROOT

    @property
    def bench(self) -> Path:
        return self.root / "edmbench"

    def benchmark(self) -> dict:
        return json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        return _json(self.bench / "workloads" / f"{name}.json")

    def config(self, name: str) -> dict:
        return _json(self.bench / "configs" / f"{name}.json")

    def kind(self, name: str) -> ModuleType:
        return load_module(self.bench / "traffic" / f"{name}.py")

    def metric(self, name: str) -> ModuleType:
        return load_module(self.bench / "metrics" / f"{name}.py")


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    return json.loads(path.read_text())


def load_module(path: Path) -> ModuleType:
    """A module of the benchmark by its file, whose name may hold dots."""
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark module: {path}")
    spec = importlib.util.spec_from_file_location("edmbench._by_path." + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def derive_seed(seed: int, *tags) -> int:
    """A 63-bit seed for ``seed`` and ``tags``: one stream per purpose."""
    digest = hashlib.blake2b(repr((int(seed),) + tags).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def port_model(cfg: dict, device, weights: dict):
    """The port's EDM for ``cfg``, built under the meta device, placed on
    ``device`` uninitialized and filled with ``weights`` (strictly: every
    name the port's modules give a tensor must be there)."""
    import torch

    from tinyedm_tpu_torch.models.edm import EDM
    from tinyedm_tpu_torch.models.layers import Embedding
    from tinyedm_tpu_torch.models.unet import Denoiser

    den = dict(cfg["denoiser"])
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[den.pop("dtype")]
    with torch.device("meta"):
        model = EDM(Embedding(**cfg["embedding"]), Denoiser(**den, dtype=dtype),
                    use_uncertainty=bool(cfg.get("use_uncertainty")))
    model = model.to_empty(device=device)
    model.load_state_dict(weights)
    return model


@dataclasses.dataclass
class Check:
    """One number that ``correct`` compares, with its limit: the run is
    correct where every value is finite and at most its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def checks_from(values: dict[str, float], limits: dict[str, float]) -> list[Check]:
    missing = set(limits) - set(values)
    if missing:
        raise KeyError(f"limits name numbers the check does not read: {sorted(missing)}")
    return [Check(k, float(values[k]), float(limits[k])) for k in limits]


def leaf_gaps(prog: dict[str, float], ref: dict[str, float], keep: list[str]) -> list[float]:
    """Each kept leaf's gap between the program's norm and the reference's,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    med = statistics.median(ref[k] for k in keep)
    return [abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep]


def train_gaps(prog, ref) -> dict[str, float]:
    """The training numbers of ``correct`` (both sides ``reference.train.
    Readings``):

    - ``loss_gap``: the first step's summed loss, relative. The later steps'
      losses follow parameters that Adam's first, sign-like updates have
      moved apart wherever a gradient is near zero; the sum, where the
      step's mean would not, also reads a batch that lost rows;
    - ``grad_gap``: the worst leaf's gap of the first gradient's norm;
    - ``change_gap``, ``ema_gap``: the worst leaf's gap of the norm of the
      parameters' change, and of each EMA profile's, over the steps.

    Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out: they move by round-off alone."""
    med = statistics.median(ref.grad_norms.values())
    keep = [k for k, v in ref.grad_norms.items() if v >= 1e-3 * med]
    return {
        "loss_gap": abs(prog.sse[0] - ref.sse[0]) / abs(ref.sse[0]),
        "grad_gap": max(leaf_gaps(prog.grad_norms, ref.grad_norms, keep)),
        "change_gap": max(leaf_gaps(prog.change_norms, ref.change_norms, keep)),
        "ema_gap": max(max(leaf_gaps(p, r, keep)) for p, r in zip(prog.ema_change_norms, ref.ema_change_norms)),
    }


def sample_gaps(x_prog, x_ref, u8_prog, u8_ref) -> dict[str, float]:
    """The sampling numbers of ``correct`` over the checked images (first
    dim): the worst image's relative L2 gap of the sample, and the worst
    image's mean absolute gap of its uint8 values, in counts."""
    import torch

    n = x_ref.shape[0]
    d = (x_prog.float() - x_ref.float()).reshape(n, -1)
    rel = torch.linalg.vector_norm(d, dim=1) / torch.linalg.vector_norm(x_ref.float().reshape(n, -1), dim=1)
    u8 = (u8_prog.int() - u8_ref.int()).abs().reshape(n, -1).float().mean(dim=1)
    return {"x_gap": float(rel.max()), "u8_gap": float(u8.max())}
