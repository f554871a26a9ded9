"""Config system: ``_target_`` object trees, interpolation and the inverse map.

Counterpart of ``tinyedm_tpu/config/registry.py``, with the same YAML files
and the same semantics: dicts that carry ``_target_`` are instantiated
recursively (through lists too), ``${a.b.c}`` interpolations resolve against
the root config (a whole-string one keeps the referenced value's type, an
embedded one is substituted as a string), ``dtype`` strings become torch
dtypes, and ``deinstantiate`` reflects an object tree back into a config.

Targets keep the JAX package's names, so one config serves both packages:
``resolve_target`` maps ``tinyedm_tpu.<module>.<Name>`` onto
``tinyedm_tpu_torch.<module>.<Name>`` by string (the JAX package is never
imported), after the reference aliases ``tinyedm.*``. ``deinstantiate`` maps
the port's names back, so a port checkpoint's config instantiates in the JAX
package too.

A target whose class is an ``nn.Module`` is not built here: a module owns
its weights, so ``instantiate`` returns a ``ModuleSpec`` that keeps the
keywords, and the owner builds it (``EDMSpec.build_model``).

YAML is read by ``config.yaml_subset`` (the machine with the card has no
YAML parser). One divergence from the JAX registry: an interpolation that
does not resolve raises ``ValueError`` naming the config string and the
missing path, where the JAX registry raises a bare ``KeyError``.
"""

from __future__ import annotations

import dataclasses
import importlib
import inspect
import re
from pathlib import Path
from typing import Any, Mapping

import torch
from torch import nn

from tinyedm_tpu_torch.config import yaml_subset

_TARGET_KEY = "_target_"
_JAX_PACKAGE = "tinyedm_tpu"
_PORT_PACKAGE = "tinyedm_tpu_torch"

_DTYPE_NAMES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float64": torch.float64,
}
_DTYPE_TO_NAME = {v: k for k, v in _DTYPE_NAMES.items()}

# reference-API target aliases (tinyedm.* -> tinyedm_tpu.*), as in the JAX registry
TARGET_ALIASES = {
    "tinyedm.EDM": "tinyedm_tpu.training.experiment.EDMSpec",
    "tinyedm.Diffuser": "tinyedm_tpu.diffusion.diffuser.Diffuser",
    "tinyedm.Embedding": "tinyedm_tpu.models.layers.Embedding",
    "tinyedm.Denoiser": "tinyedm_tpu.models.unet.Denoiser",
    "tinyedm.DenoiserWrapper": "tinyedm_tpu.models.unet.DenoiserWrapper",
    # the port's transformer denoiser (models/dit.py), which the JAX package lacks
    "tinyedm.DiTEmbedding": "tinyedm_tpu.models.dit.DiTEmbedding",
    "tinyedm.DiTDenoiser": "tinyedm_tpu.models.dit.DiTDenoiser",
    # and the text-to-image transformer (models/flux.py), which it lacks too
    "tinyedm.FluxEmbedding": "tinyedm_tpu.models.flux.FluxEmbedding",
    "tinyedm.FluxDenoiser": "tinyedm_tpu.models.flux.FluxDenoiser",
    "tinyedm.DeterministicSolver": "tinyedm_tpu.diffusion.solver.DeterministicSolver",
    "tinyedm.callbacks.GenerateCallback": "tinyedm_tpu.training.callbacks.GenerateCallback",
    "tinyedm.callbacks.LatentsGenerateCallback": "tinyedm_tpu.training.callbacks.LatentsGenerateCallback",
    "tinyedm.PreditionWriter": "tinyedm_tpu.training.callbacks.PreditionWriter",
    "tinyedm.datamodules.MNISTDataModule": "tinyedm_tpu.data.datamodules.MNISTDataModule",
    "tinyedm.datamodules.CIFAR10DataModule": "tinyedm_tpu.data.datamodules.CIFAR10DataModule",
    "tinyedm.datamodules.ImageNetLatentsDataModule": "tinyedm_tpu.data.datamodules.ImageNetLatentsDataModule",
    "tinyedm.datamodules.RandomNoiseDataModule": "tinyedm_tpu.data.datamodules.RandomNoiseDataModule",
}


def port_name(target: str) -> str:
    """The port's dotted name for a config target (aliases resolved)."""
    target = TARGET_ALIASES.get(target, target)
    if target.split(".")[0] == _JAX_PACKAGE:
        return _PORT_PACKAGE + target[len(_JAX_PACKAGE):]
    return target


def config_name(port_target: str) -> str:
    """The config (JAX package) name of a port class's dotted name."""
    if port_target.split(".")[0] == _PORT_PACKAGE:
        return _JAX_PACKAGE + port_target[len(_PORT_PACKAGE):]
    return port_target


def resolve_target(target: str) -> Any:
    """Import the port object that a config's dotted target names."""
    name = port_name(target)
    module_name, _, attr = name.rpartition(".")
    if not module_name:
        raise ValueError(f"invalid _target_: {target!r}")
    module = importlib.import_module(module_name)
    if not hasattr(module, attr):
        raise NotImplementedError(f"{target}: the port's {module_name} has no {attr} (not ported)")
    return getattr(module, attr)


@dataclasses.dataclass(frozen=True)
class ModuleSpec:
    """The keywords of an ``nn.Module`` target, built on demand: reading an
    attribute gives the keyword, else the constructor's default."""

    cls: type
    kwargs: dict

    def build(self, **overrides: Any) -> nn.Module:
        return self.cls(**{**self.kwargs, **overrides})

    def replace(self, **changes: Any) -> "ModuleSpec":
        return ModuleSpec(self.cls, {**self.kwargs, **changes})

    def __getattr__(self, name: str) -> Any:
        if name in ("cls", "kwargs") or name.startswith("__"):
            raise AttributeError(name)
        if name in self.kwargs:
            return self.kwargs[name]
        param = inspect.signature(self.cls).parameters.get(name)
        if param is None or param.default is inspect.Parameter.empty:
            raise AttributeError(f"{self.cls.__name__} spec has no {name!r}")
        return param.default


_INTERP_RE = re.compile(r"^\$\{([a-zA-Z0-9_.]+)\}$")
_EMBED_RE = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


def _lookup(root: Mapping[str, Any], path: str, where: str) -> Any:
    cur: Any = root
    for part in path.split("."):
        if not isinstance(cur, Mapping) or part not in cur:
            raise ValueError(f"config string {where!r}: interpolation ${{{path}}} does not resolve "
                             f"({part!r} not found)")
        cur = cur[part]
    return cur


def _resolve_interpolations(node: Any, root: Mapping[str, Any]) -> Any:
    if isinstance(node, str):
        m = _INTERP_RE.match(node)
        if m:
            # a whole-string interpolation keeps the referenced value's type
            return _resolve_interpolations(_lookup(root, m.group(1), node), root)
        if "${" in node:
            # embedded ("runs/${name}"): substitute the value as a string
            return _EMBED_RE.sub(
                lambda mm: str(_resolve_interpolations(_lookup(root, mm.group(1), node), root)), node
            )
        return node
    if isinstance(node, Mapping):
        return {k: _resolve_interpolations(v, root) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_resolve_interpolations(v, root) for v in node)
    return node


def load_config(path: str | Path, resolve: bool = True) -> dict:
    """Load a YAML experiment config; resolves ``${...}`` unless
    ``resolve=False`` (when overrides follow: an overridden interpolation
    source must reach its references, so ``apply_overrides`` resolves)."""
    cfg = yaml_subset.loads(Path(path).read_text())
    return _resolve_interpolations(cfg, cfg) if resolve else cfg


def apply_overrides(cfg: dict, overrides: list[str]) -> dict:
    """Dotted overrides ``a.b.c=value`` (the value read as YAML), then
    interpolation."""
    for ov in overrides:
        key, _, raw = ov.partition("=")
        value = yaml_subset.parse_value(raw)
        cur = cfg
        parts = key.split(".")
        for i, p in enumerate(parts[:-1]):
            if not isinstance(cur, Mapping):
                raise ValueError(
                    f"override {ov!r}: {'.'.join(parts[:i])!r} is not a mapping (found {type(cur).__name__})"
                )
            cur = cur.setdefault(p, {})
        if not isinstance(cur, Mapping):
            raise ValueError(
                f"override {ov!r}: {'.'.join(parts[:-1])!r} is not a mapping (found {type(cur).__name__})"
            )
        cur[parts[-1]] = value
    return _resolve_interpolations(cfg, cfg)


def instantiate(cfg: Any, **overrides: Any) -> Any:
    """Recursively build the object tree described by a ``_target_`` config."""
    if isinstance(cfg, Mapping):
        if _TARGET_KEY in cfg:
            cls = resolve_target(cfg[_TARGET_KEY])
            kwargs = {k: instantiate(v) for k, v in cfg.items() if k != _TARGET_KEY}
            kwargs.update(overrides)
            if "dtype" in kwargs and isinstance(kwargs["dtype"], str):
                kwargs["dtype"] = _DTYPE_NAMES[kwargs["dtype"]]
            # YAML has no tuples: shallow lists become tuples, as in the JAX registry
            kwargs = {k: tuple(v) if isinstance(v, list) else v for k, v in kwargs.items()}
            if isinstance(cls, type) and issubclass(cls, nn.Module):
                return ModuleSpec(cls, kwargs)
            return cls(**kwargs)
        return {k: instantiate(v) for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return type(cfg)(instantiate(v) for v in cfg)
    return cfg


def _target_of(cls: type) -> str:
    return config_name(f"{cls.__module__}.{cls.__qualname__}")


def deinstantiate(obj: Any) -> Any:
    """Reflect an object tree back into a ``_target_`` config dict with the
    config's (JAX package) target names. Inverse of ``instantiate``."""
    if isinstance(obj, ModuleSpec):
        out: dict[str, Any] = {_TARGET_KEY: _target_of(obj.cls)}
        out.update({k: deinstantiate(v) for k, v in obj.kwargs.items()})
        return out
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {_TARGET_KEY: _target_of(type(obj))}
        for f in dataclasses.fields(obj):
            if f.init:
                out[f.name] = deinstantiate(getattr(obj, f.name))
        return out
    if isinstance(obj, Mapping):
        return {k: deinstantiate(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return [deinstantiate(v) for v in obj]
    if isinstance(obj, torch.dtype) and obj in _DTYPE_TO_NAME:
        return _DTYPE_TO_NAME[obj]
    return obj
