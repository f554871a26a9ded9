"""Package-level checks of the port: no JAX anywhere in it, configs equal to
the YAML files they copy, and the CIFAR-10 model's size."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyedm_tpu.config.registry import load_config
from tinyedm_tpu.models.edm import EDM as JaxEDM
from tinyedm_tpu.models.layers import Embedding as JaxEmbedding
from tinyedm_tpu.models.unet import Denoiser as JaxDenoiser
from tinyedm_tpu_torch.configs import CONFIGS, build_model

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "flax", "tinyedm_tpu", "experiments"}
# what the machine with the card lacks: never imported by the port, and
# wandb only inside a function (MetricLogger's guarded import)
ABSENT_ON_THE_CARD = {"yaml", "PIL", "orbax", "torchvision", "tf_keras", "safetensors", "diffusers",
                      "lightning", "pytorch_lightning", "omegaconf"}
MODULE_LEVEL_ONLY = {"wandb"}


def _port_sources():
    return sorted((ROOT / "tinyedm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _import_roots(nodes) -> set[str]:
    roots = set()
    for node in nodes:
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def _imported_roots(path: Path) -> set[str]:
    return _import_roots(ast.walk(ast.parse(path.read_text(), str(path))))


def _module_level_roots(path: Path) -> set[str]:
    """Imports at module level (in ``if``/``try`` blocks too), not in functions."""
    def walk(body):
        for node in body:
            yield node
            if isinstance(node, (ast.If, ast.Try, ast.With)):
                for field in ("body", "orelse", "finalbody", "handlers"):
                    yield from walk(getattr(node, field, []))
            elif isinstance(node, ast.ExceptHandler):
                yield from walk(node.body)
    return _import_roots(walk(ast.parse(path.read_text(), str(path)).body))


NEW_MODULES = ("diffusion/protocols.py", "validate_learning.py", "soak.py", "soak_reference_pngs.py")


def test_port_imports_no_jax():
    sources = _port_sources()
    assert len(sources) > 15 and all(p.exists() for p in sources)
    assert all(ROOT / "tinyedm_tpu_torch" / m in sources for m in NEW_MODULES)
    bad = {str(p.relative_to(ROOT)): sorted(_imported_roots(p) & (FORBIDDEN | ABSENT_ON_THE_CARD))
           for p in sources}
    bad.update({str(p.relative_to(ROOT)) + " (module level)": sorted(_module_level_roots(p) & MODULE_LEVEL_ONLY)
                for p in sources})
    assert not {k: v for k, v in bad.items() if v}
    logging = ROOT / "tinyedm_tpu_torch" / "utils" / "logging.py"
    assert "wandb" in _imported_roots(logging) and "wandb" not in _module_level_roots(logging)


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, tinyedm_tpu_torch, tinyedm_tpu_torch.generate, "
        "tinyedm_tpu_torch.utils.interop, tinyedm_tpu_torch.training.train_step, "
        "tinyedm_tpu_torch.data.datamodules, tinyedm_tpu_torch.diffusion.loss, "
        "tinyedm_tpu_torch.train, tinyedm_tpu_torch.training.trainer, tinyedm_tpu_torch.utils.profiling, "
        "tinyedm_tpu_torch.data.latpack, tinyedm_tpu_torch.posthoc_ema, tinyedm_tpu_torch.eval_fid, "
        "tinyedm_tpu_torch.utils.fid, tinyedm_tpu_torch.utils.inception, tinyedm_tpu_torch.data.vae, "
        "tinyedm_tpu_torch.data.extract_latents, tinyedm_tpu_torch.data.images, "
        "tinyedm_tpu_torch.data.resample, tinyedm_tpu_torch.utils.safetensors, "
        "tinyedm_tpu_torch.diffusion.protocols, tinyedm_tpu_torch.validate_learning, tinyedm_tpu_torch.soak, "
        "tinyedm_tpu_torch.soak_reference_pngs\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "{'jax', 'flax', 'tinyedm_tpu', 'experiments', 'yaml', 'PIL', 'orbax', 'wandb', 'torchvision', 'tf_keras', "
        "'safetensors', 'diffusers', 'lightning', 'pytorch_lightning', 'omegaconf'})\n"
        "assert not bad, bad\n"
        # nothing is built or loaded at import: nvJPEG only at the first JPEG
        "from tinyedm_tpu_torch.ops import _build\n"
        "assert not _build._loaded, _build._loaded\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


@pytest.mark.parametrize("name,yaml", [("cifar10", "cifar10.yaml"), ("smoke", "smoke.yaml")])
def test_config_equals_yaml(name, yaml):
    model = load_config(ROOT / "experiments" / "conf" / yaml)["model"]
    expected = {
        part: {k: v for k, v in model[part].items() if k != "_target_"}
        for part in ("embedding", "denoiser")
    }
    assert CONFIGS[name] == expected


def _jax_param_count(name: str) -> int:
    cfg = CONFIGS[name]
    den = {k: v for k, v in cfg["denoiser"].items() if k not in ("dtype", "dropout_rate")}
    model = JaxEDM(embedding=JaxEmbedding(**cfg["embedding"]), denoiser=JaxDenoiser(**den))
    x = jnp.zeros((1, 32, 32, 3))
    shapes = jax.eval_shape(
        lambda: model.init({"params": jax.random.PRNGKey(0)}, x, jnp.ones((1,)), jnp.zeros((1,), jnp.int32))
    )
    return sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes["params"]))


@pytest.mark.parametrize("name", ["cifar10", "smoke"])
def test_param_count_matches_jax(name):
    model = build_model(name, "cpu")
    n = sum(p.numel() for p in model.parameters())
    assert n == _jax_param_count(name)
    if name == "cifar10":
        assert round(n / 1e6, 2) == 35.62
        assert model.denoiser.dtype == torch.bfloat16 and not model.conditional


def test_seeded_build_is_reproducible():
    a = build_model("smoke", "cpu", seed=3).state_dict()
    b = build_model("smoke", "cpu", seed=3).state_dict()
    c = build_model("smoke", "cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["denoiser.conv_in.weight"], c["denoiser.conv_in.weight"])
    assert float(a["denoiser.gain_out"]) == 0.0
    assert float(a["denoiser.encoder_blocks.0.gain"]) == 1.0
