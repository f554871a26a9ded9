"""The port's model and training recipes, read from ``experiments/conf/``.

Each ``experiments/conf/<name>.yaml`` is a recipe named by its file's stem,
and the only written copy of it: a new configuration is a YAML file (and,
for a new architecture, its module and registry alias), nothing here.
``CONFIGS[name]`` is the recipe's ``model`` block, its ``embedding`` and
``denoiser`` keywords with interpolations resolved and ``_target_`` dropped;
a U-Net recipe that leaves the topology to the Denoiser's defaults (as
``imagenet512.yaml`` does) gets ``models/topology.py``'s five lists written
out, and a recipe whose targets name other classes than the U-Net's
``Embedding`` and ``Denoiser`` carries them as ``classes``, as the DiT's
``DiTEmbedding`` and ``DiTDenoiser`` (``models/dit.py``). ``TRAINING[name]``
is the training recipe around it. Both are plain dicts, read once at
import. The models are built by ``training/experiment.py::build_edm`` and
the training configs by the recipe's ``EDMSpec``, as the training CLI
builds them.
"""

from __future__ import annotations

from typing import Optional

import torch

from tinyedm_tpu_torch.config.registry import ModuleSpec, instantiate, load_config, resolve_target
from tinyedm_tpu_torch.diffusion.diffuser import Diffuser
from tinyedm_tpu_torch.models import topology
from tinyedm_tpu_torch.models.edm import EDM, init_weights
from tinyedm_tpu_torch.models.layers import Embedding
from tinyedm_tpu_torch.models.unet import Denoiser
from tinyedm_tpu_torch.train import CONFIG_PATH
from tinyedm_tpu_torch.training.ema import EMAConfig
from tinyedm_tpu_torch.training.experiment import build_edm
from tinyedm_tpu_torch.training.train_step import OptimizerConfig
from tinyedm_tpu_torch.utils.cuda import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the Denoiser's topology keywords and their defaults
_TOPOLOGY = {
    "encoder_block_types": topology.default_encoder_block_types,
    "decoder_block_types": topology.default_decoder_block_types,
    "encoder_out_channels": topology.default_encoder_out_channels,
    "decoder_out_channels": topology.default_decoder_out_channels,
    "skip_connections": topology.default_skip_connections,
}
# the model block's training keys that TRAINING keeps where a recipe gives them
# (Adam's betas and eps are EDMSpec's and OptimizerConfig's defaults)
_TRAINING_KEYS = ("use_uncertainty", "lr", "steady_steps", "rampup_steps", "scheduler_interval",
                  "label_dropout", "use_ema", "ema_length", "ema_lengths", "every_n_steps")


def _keywords(block: dict) -> dict:
    return {k: v for k, v in block.items() if k != "_target_"}


def _recipe(cfg: dict) -> tuple[dict, dict]:
    """(CONFIGS entry, TRAINING entry) of a loaded YAML recipe."""
    model = cfg["model"]
    entry = {"embedding": _keywords(model["embedding"]), "denoiser": _keywords(model["denoiser"])}
    cls = (resolve_target(model["embedding"]["_target_"]), resolve_target(model["denoiser"]["_target_"]))
    if cls == (Embedding, Denoiser):
        for key, default in _TOPOLOGY.items():
            entry["denoiser"].setdefault(key, list(default()))
    else:
        entry["classes"] = cls
    training = {
        "seed": cfg["seed"],
        "batch_size": cfg["datamodule"]["batch_size"],
        "accumulate_grad_batches": cfg["trainer"]["accumulate_grad_batches"],
        "diffuser": _keywords(model["diffuser"]),
        **{k: model[k] for k in _TRAINING_KEYS if k in model},
    }
    return entry, training


_YAML = {path.stem: load_config(path) for path in sorted(CONFIG_PATH.glob("*.yaml"))}
CONFIGS: dict[str, dict] = {}
TRAINING: dict[str, dict] = {}
for _name, _cfg in _YAML.items():
    CONFIGS[_name], TRAINING[_name] = _recipe(_cfg)


def build_model(
    name: str,
    device: Optional[str | torch.device] = None,
    dtype: Optional[torch.dtype] = None,
    *,
    fused: str = "auto",
    seed: int = 0,
    knobs: Optional[dict] = None,
) -> EDM:
    """The named config's EDM in eval mode on ``device`` (the card unless
    ``"cpu"`` is asked for), with weights drawn from ``seed``.

    ``dtype`` overrides the config's compute dtype and ``knobs`` adds
    Denoiser keywords (``remat``, ``remat_policy``, ``mod_fp32``,
    ``scan_blocks``). The config's dropout rate and ``use_pallas_attention``
    are built in; dropout runs only in a forward with ``train=True``. A DiT
    config takes no ``fused`` route and no knobs: its attention has one
    route."""
    dev = resolve_device(device)
    model = model_from_config(name, dtype, fused=fused, knobs=knobs)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def classes(name: str) -> tuple[type, type]:
    """The named config's embedding and denoiser classes: its ``classes``,
    else the U-Net's."""
    return CONFIGS[name].get("classes", (Embedding, Denoiser))


def model_from_config(name: str, dtype: Optional[torch.dtype] = None, *,
                      fused: str = "auto", knobs: Optional[dict] = None) -> EDM:
    """The named config's EDM with its parameters allocated but not drawn:
    under ``torch.device("meta")`` it allocates nothing, which is how a
    caller counts the parameters of a model too large to draw on the CPU."""
    cfg = CONFIGS[name]
    den_kwargs = dict(cfg["denoiser"])
    config_dtype = _DTYPES[den_kwargs.pop("dtype")]
    embedding_cls, denoiser_cls = classes(name)
    return build_edm(ModuleSpec(embedding_cls, cfg["embedding"]), ModuleSpec(denoiser_cls, den_kwargs),
                     use_uncertainty=TRAINING.get(name, {}).get("use_uncertainty", False),
                     fused=fused, dtype=dtype or config_dtype, knobs=knobs, name=name)


def build_training(
    name: str,
    device: Optional[str | torch.device] = None,
    dtype: Optional[torch.dtype] = None,
    *,
    fused: str = "auto",
    seed: int = 0,
    knobs: Optional[dict] = None,
) -> tuple[EDM, Diffuser, OptimizerConfig, Optional[EMAConfig], int, str]:
    """(model, diffuser, optimizer config, EMA config, batch size, schedule
    interval) of the named config's training recipe; the model as
    ``build_model`` makes it, the rest from the recipe's ``EDMSpec`` as the
    training CLI builds it. The interval says what the lr schedule's count
    ticks with, which the caller passes to the train step: ``"epoch"`` or
    ``"step"``. The EMA tracks every profile of ``ema_lengths`` where the
    recipe gives them, else ``ema_length``."""
    t = TRAINING[name]
    spec = instantiate(_YAML[name]["model"], accum_steps=t["accumulate_grad_batches"])
    model = build_model(name, device, dtype, fused=fused, seed=seed, knobs=knobs)
    return (model, spec.diffuser, spec.build_optimizer_config(), spec.build_ema_config(), t["batch_size"],
            spec.scheduler_interval)
