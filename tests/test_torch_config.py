"""The port's YAML reader, config registry and EDMSpec against the JAX package.

- ``config.yaml_subset`` equals ``yaml.safe_load`` on all five
  ``experiments/conf/*.yaml`` and on scalar edge cases (exact equality,
  NaN equal to NaN), and raises ``ValueError`` naming the line on what it
  does not read (anchors, aliases, tags, block scalars, flow mappings,
  block sequences, tabs, multi-line scalars, the YAML 1.1 number forms).
- ``load_config`` and ``apply_overrides`` give the JAX registry's trees
  (exact equality), overrides that move an interpolation source included.
  An unresolvable ``${x.y}`` raises ``ValueError`` in the port where the
  JAX registry raises ``KeyError``: the documented divergence.
- ``instantiate`` of each recipe's ``model`` block gives an ``EDMSpec`` whose
  optimizer and EMA configs equal ``configs.build_training``'s (exact), and
  whose model is ``configs.model_from_config``'s;
  ``deinstantiate`` round-trips in the port, and the JAX ``instantiate``
  accepts the port's deinstantiated spec and builds the JAX spec of the YAML.
"""

from __future__ import annotations

import math
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch
import yaml

from tinyedm_tpu.config import registry as jax_registry
from tinyedm_tpu_torch import configs
from tinyedm_tpu_torch.config import registry, yaml_subset
from tinyedm_tpu_torch.config.registry import ModuleSpec
from tinyedm_tpu_torch.data.latpack import PackedLatentsDataModule
from tinyedm_tpu_torch.diffusion.solver import DeterministicSolver
from tinyedm_tpu_torch.models.edm import EDM
from tinyedm_tpu_torch.models.layers import Embedding
from tinyedm_tpu_torch.training.callbacks import FIDCallback, GenerateCallback, LatentsGenerateCallback
from tinyedm_tpu_torch.training.experiment import EDMSpec

CONF = Path(__file__).resolve().parent.parent / "experiments" / "conf"
NAMES = ("cifar10", "imagenet", "imagenet512", "mnist", "smoke")


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("name", NAMES)
def test_reader_equals_safe_load_on_configs(name):
    text = (CONF / f"{name}.yaml").read_text()
    assert yaml_subset.loads(text) == yaml.safe_load(text)


SCALARS = [
    "80.0", "80.", "1e-3", "1.0e-3", "1.0e+3", "1.0e3", "-.5", ".5", "0", "-3", "+4", "-0.0", "0.",
    "true", "False", "TRUE", "yes", "No", "on", "OFF", "null", "~", "Null", "", ".inf", "-.Inf",
    ".NaN", "bfloat16", "${model.embedding.embedding_dim}", "runs/${name}/x", "a:b", "a#b",
    "x # comment", "'quoted ''one'''", '"double \\"two\\" \\t"', "'80.0'", "[1, 2.5, true, null, 'a,b', x]",
    "[]", "[Enc, EncD]", "[False, True] # c", "  7  ",
]


@pytest.mark.parametrize("raw", SCALARS)
def test_reader_scalars_equal_safe_load(raw):
    ours, theirs = yaml_subset.parse_value(raw), yaml.safe_load(raw)
    if isinstance(theirs, list):
        assert len(ours) == len(theirs) and all(map(_same, ours, theirs))
    else:
        assert _same(ours, theirs)
    assert _same(yaml_subset.loads(f"k: {raw}\n")["k"], theirs) or isinstance(theirs, list)


REFUSED = [
    ("a: &x 1\n", "anchor"), ("a: *x\n", "alias"), ("a: !!str 1\n", "tag"), ("a: |\n  t\n", "block scalar"),
    ("a: >\n  t\n", "block scalar"), ("a: {b: 1}\n", "flow mapping"), ("a:\n  - 1\n", "block sequence"),
    ("a:\n\tb: 1\n", "tab"), ("a: b\n  c\n", "multi-line"), ("---\na: 1\n", "document"),
    ("a: 007\n", "YAML 1.1"), ("a: 0x1f\n", "YAML 1.1"), ("a: 1_000\n", "YAML 1.1"), ("a: 1:30\n", "YAML 1.1"),
    ("a: 2024-01-01\n", "YAML 1.1"), ("a: [[1]]\n", "nested"), ("a: [1, 2\n", "unterminated"),
    ("a: x: y\n", "mapping inside"),
]


@pytest.mark.parametrize("doc,what", REFUSED)
def test_reader_refuses_what_it_does_not_read(doc, what):
    with pytest.raises(ValueError, match=f"line \\d+: .*{what}"):
        yaml_subset.loads("ok: 1\n" + doc)


@pytest.mark.parametrize("name", NAMES)
def test_load_config_equals_jax(name):
    path = CONF / f"{name}.yaml"
    assert registry.load_config(path) == jax_registry.load_config(path)
    assert registry.load_config(path, resolve=False) == jax_registry.load_config(path, resolve=False)


@pytest.mark.parametrize("name", NAMES)
def test_apply_overrides_equals_jax(name):
    overrides = [
        "model.embedding.embedding_dim=96",  # an interpolation source
        "trainer.max_epochs=3",
        "model.lr=0.5",
        "model.lr_note=1e-3",  # a new key; a string in both
        "model.denoiser.dropout_rate=0.",
        "callbacks.generate_callback.every_n_epochs=1",
        "datamodule.data_dir=/tmp/${seed}/x",
        "trainer.tags=[a, 2, true]",
    ]
    path = CONF / f"{name}.yaml"
    ours = registry.apply_overrides(registry.load_config(path, resolve=False), overrides)
    theirs = jax_registry.apply_overrides(jax_registry.load_config(path, resolve=False), overrides)
    assert ours == theirs
    assert ours["model"]["denoiser"]["embedding_dim"] == 96
    assert ours["datamodule"]["data_dir"] == "/tmp/42/x"


def test_override_through_a_scalar_raises_as_in_jax():
    for reg in (registry, jax_registry):
        with pytest.raises(ValueError, match="is not a mapping"):
            reg.apply_overrides({"seed": 1}, ["seed.x=2"])


def test_unresolvable_interpolation_raises_value_error_not_key_error():
    cfg = {"a": {"b": 1}, "c": "${x.y}", "d": "runs/${a.missing}/z"}
    with pytest.raises(KeyError):  # the JAX registry's bare KeyError
        jax_registry._resolve_interpolations(cfg, cfg)
    with pytest.raises(ValueError, match=r"'\$\{x.y\}'.*\$\{x.y\}.*'x' not found"):
        registry.apply_overrides(dict(cfg), [])
    with pytest.raises(ValueError, match=r"runs/\$\{a.missing\}/z.*'missing' not found"):
        registry.apply_overrides({"a": {"b": 1}, "d": "runs/${a.missing}/z"}, [])


def test_resolve_target_maps_names_and_aliases():
    assert registry.resolve_target("tinyedm_tpu.training.experiment.EDMSpec") is EDMSpec
    assert registry.resolve_target("tinyedm.EDM") is EDMSpec
    assert registry.resolve_target("tinyedm.Embedding") is Embedding
    assert registry.resolve_target("tinyedm.DeterministicSolver") is DeterministicSolver
    assert registry.resolve_target("tinyedm.callbacks.GenerateCallback") is GenerateCallback
    assert registry.resolve_target(
        "tinyedm_tpu.training.callbacks.LatentsGenerateCallback") is LatentsGenerateCallback
    assert registry.resolve_target("tinyedm_tpu.data.latpack.PackedLatentsDataModule") is PackedLatentsDataModule
    assert registry.resolve_target("tinyedm_tpu.training.callbacks.FIDCallback") is FIDCallback
    cfg = registry.load_config(CONF / "imagenet512.yaml")
    dm = registry.instantiate(cfg["datamodule"])
    assert isinstance(dm, PackedLatentsDataModule)
    assert (dm.batch_size, dm.num_workers, dm.data_file) == (128, 8, "datasets/imagenet512/latents.latpack")


def _spec(name: str, **overrides) -> EDMSpec:
    cfg = registry.load_config(CONF / f"{name}.yaml")
    accum = cfg["trainer"]["accumulate_grad_batches"]
    return registry.instantiate(cfg["model"], accum_steps=accum, **overrides)


@pytest.mark.parametrize("name", sorted(configs.TRAINING))
def test_spec_configs_equal_build_training(name, monkeypatch):
    spec = _spec(name)
    assert isinstance(spec, EDMSpec) and isinstance(spec.denoiser, ModuleSpec)
    assert (spec.embedding.cls, spec.denoiser.cls) == configs.classes(name)
    assert spec.denoiser.dtype is torch.bfloat16
    monkeypatch.setattr(configs, "build_model", lambda *args, **kwargs: None)  # the configs only
    _, diffuser, opt_cfg, ema_cfg, _, interval = configs.build_training(name, "cpu")
    assert spec.build_optimizer_config() == opt_cfg
    assert spec.build_ema_config() == ema_cfg
    assert spec.diffuser == diffuser and spec.scheduler_interval == interval
    cfg = configs.CONFIGS[name]
    emb = {k: v for k, v in spec.embedding.kwargs.items()}
    den = {k: list(v) if isinstance(v, tuple) else v for k, v in spec.denoiser.kwargs.items()}
    assert emb == cfg["embedding"]
    expected = {**cfg["denoiser"], "dtype": torch.bfloat16}
    assert {k: den[k] for k in expected if k in den} == {k: expected[k] for k in expected if k in den}


def test_spec_builds_the_configs_model():
    spec = _spec("smoke")
    with torch.device("meta"):
        ours = spec.build_model()
        ref = configs.model_from_config("smoke")
    assert isinstance(ours, EDM)
    assert [(k, p.shape, p.dtype) for k, p in ours.state_dict().items()] == [
        (k, p.shape, p.dtype) for k, p in ref.state_dict().items()]
    assert ours.conditional and spec.conditional and not _spec("cifar10").conditional


@pytest.mark.parametrize("name", NAMES)
def test_deinstantiate_round_trips_and_jax_accepts_it(name):
    spec = _spec(name, log_norms=True)
    cfg = registry.deinstantiate(spec)
    assert cfg["_target_"] == "tinyedm_tpu.training.experiment.EDMSpec"
    assert cfg["denoiser"]["_target_"] == "tinyedm_tpu.models.unet.Denoiser"
    assert cfg["denoiser"]["dtype"] == "bfloat16"
    assert registry.instantiate(cfg) == spec
    jax_spec = jax_registry.instantiate(cfg)
    yaml_cfg = jax_registry.load_config(CONF / f"{name}.yaml")
    accum = yaml_cfg["trainer"]["accumulate_grad_batches"]
    assert jax_spec == jax_registry.instantiate(yaml_cfg["model"], accum_steps=accum, log_norms=True)
    assert jax_spec.denoiser.dtype == jnp.bfloat16


def test_spec_checks_match_jax():
    base = registry.load_config(CONF / "smoke.yaml")["model"]
    for bad, match in (({"use_ema": True, "ema_length": None}, "ema_length"),
                       ({"label_dropout": 1.0}, "label_dropout"),
                       ({"val_ema_index": 1}, "val_ema_index")):
        for reg in (registry, jax_registry):
            with pytest.raises(ValueError, match=match):
                reg.instantiate({**base, **bad})
    spec = registry.instantiate({**base, "sigma_data": 0.7})
    assert spec.denoiser.sigma_data == 0.7


def test_solver_dtype_string_becomes_a_torch_dtype():
    solver = registry.instantiate({"_target_": "tinyedm_tpu.diffusion.solver.DeterministicSolver",
                                   "num_steps": 3, "dtype": "float64"})
    assert solver.dtype is torch.float64 and solver.torch_dtype is torch.float64
    assert registry.deinstantiate(solver)["dtype"] == "float64"
