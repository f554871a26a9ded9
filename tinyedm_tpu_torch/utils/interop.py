"""Weights and train states across the two packages, and the port's weight files.

``from_jax_variables`` carries a JAX ``{"params", "constants"}`` tree (as
numpy arrays) into the port's ``state_dict``: flax module names map to the
port's attribute names (``encoder_blocks_3`` -> ``encoder_blocks.3``,
ScaleLong's ``WNConv_0`` -> ``conv_0``, ClassEmbedding's and UncertaintyNet's
``WNLinear_0`` -> ``linear``, UncertaintyNet's ``WNLinear_1`` ->
``linear_out``, leaf ``w`` -> ``weight``), conv kernels go HWIO -> OIHW and
linears stay ``(out, in)``. The qkv output channels keep the JAX order
``(3, heads, hd)``. ``train_state_from_jax`` carries a whole JAX
``TrainState`` the same way. Reading orbax checkpoints and the reference
torch layout is not done here.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from tinyedm_tpu_torch.training.state import TrainState

_NAMES = {
    "embedding", "denoiser", "fourier_embed", "sigma_embed", "class_embed",
    "conv_in", "conv_out", "conv_1x1", "conv_3x3_1", "conv_3x3_2", "embed",
    "attention", "qkv_conv", "out_conv", "cat_factor", "u",
}
_RENAMED = {
    "WNConv_0": "conv_0", "WNConv_1": "conv_1", "WNLinear_0": "linear",
    "WNLinear_1": "linear_out", "w": "weight",
}
# modules that hold a weight-normed leaf "w" directly; every other module
# name is a container
_WN_LAYERS = {
    "sigma_embed", "conv_in", "conv_out", "conv_1x1", "conv_3x3_1", "conv_3x3_2", "embed",
    "qkv_conv", "out_conv", "WNConv_0", "WNConv_1", "WNLinear_0", "WNLinear_1",
}
_LEAVES = {"gain", "gain_out", "freqs", "phases"}
_JAX_NAMES = {v: k for k, v in _RENAMED.items()}
_INDEXED = re.compile(r"^(encoder_blocks|decoder_blocks)_(\d+)$")


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def _port_key(path: tuple) -> str:
    parts = []
    for i, name in enumerate(path):
        is_leaf = i == len(path) - 1
        m = _INDEXED.match(name)
        if m:
            parts += [m.group(1), m.group(2)]
        elif name == "w" and not (is_leaf and i > 0 and path[i - 1] in _WN_LAYERS):
            raise KeyError(f"JAX leaf {'/'.join(path)} has no counterpart in the port (w)")
        elif name in _RENAMED:
            parts.append(_RENAMED[name])
        elif name in _NAMES or (is_leaf and name in _LEAVES):
            parts.append(name)
        else:
            raise KeyError(f"JAX leaf {'/'.join(path)} has no counterpart in the port ({name!r})")
    return ".".join(parts)


def jax_group(port_key: str) -> str:
    """The depth-2 group ``<top>.<child>`` of the JAX params tree that holds
    the port parameter ``port_key`` (``denoiser.encoder_blocks.3.conv_1x1.weight``
    -> ``denoiser.encoder_blocks_3``, ``u.linear.weight`` -> ``u.WNLinear_0``):
    the names of the JAX train step's per-layer norms."""
    top, *rest = port_key.split(".")
    if not rest:
        return top
    child = rest[0]
    if child in ("encoder_blocks", "decoder_blocks"):
        return f"{top}.{child}_{rest[1]}"
    return f"{top}.{_JAX_NAMES.get(child, child)}"


def from_jax_variables(
    variables_np: Mapping, model: Optional[nn.Module] = None
) -> dict[str, torch.Tensor]:
    """JAX ``{"params": ..., "constants": ...}`` (numpy leaves) -> the port's
    ``state_dict``. Raises on a leaf with no counterpart; given ``model``,
    also on any of its keys left unfilled and on any shape mismatch."""
    unknown = set(variables_np) - {"params", "constants"}
    if unknown:
        raise KeyError(f"unexpected variable collections {sorted(unknown)}")
    sd = {}
    for collection in ("params", "constants"):
        for path, arr in _flatten(variables_np.get(collection, {})).items():
            key = _port_key(path)
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            if key in sd:
                raise KeyError(f"two JAX leaves map to {key}")
            sd[key] = torch.tensor(np.asarray(arr, dtype=np.float32))
    if model is not None:
        expected = model.state_dict()
        missing = sorted(set(expected) - set(sd))
        extra = sorted(set(sd) - set(expected))
        if missing or extra:
            raise KeyError(f"port keys left unfilled: {missing}; JAX leaves with no port key: {extra}")
        for key, value in expected.items():
            if tuple(value.shape) != tuple(sd[key].shape):
                raise ValueError(
                    f"{key}: JAX shape {tuple(sd[key].shape)} != port shape {tuple(value.shape)}"
                )
    return sd


def train_state_from_jax(jax_state, model: Optional[nn.Module] = None) -> TrainState:
    """A JAX ``TrainState`` with numpy leaves (``jax.tree_util.tree_map(
    np.asarray, state)``) as the port's: params and constants through
    ``from_jax_variables``, the Adam ``mu``, ``nu`` and count of its
    ``opt_state`` (optax ``ScaleByAdamState``), every EMA tree, and the step.

    Given ``model``, the params and constants are loaded into it and the
    state's ``params`` are the model's own parameters, so that the model
    trains from the JAX state; without it they are plain tensors."""
    opt = jax_state.opt_state
    if model is None:
        params = from_jax_variables({"params": jax_state.params})
        constants = from_jax_variables({"constants": jax_state.constants})
        device = torch.device("cpu")
    else:
        model.load_state_dict(
            from_jax_variables({"params": jax_state.params, "constants": jax_state.constants}, model)
        )
        params = dict(model.named_parameters())
        constants = dict(model.named_buffers())
        device = next(model.parameters()).device

    def tree(t: Mapping) -> dict[str, torch.Tensor]:
        out = from_jax_variables({"params": t})
        if set(out) != set(params):
            raise KeyError(f"tree keys differ from the params': {sorted(set(out) ^ set(params))}")
        return {k: out[k].to(device) for k in params}

    return TrainState(
        step=int(jax_state.step),
        params=params,
        constants=constants,
        mu=tree(opt.mu),
        nu=tree(opt.nu),
        count=int(opt.count),
        ema=tuple(tree(e) for e in jax_state.ema),
    )


def save_weights(model: nn.Module, path: str | Path, config: str) -> None:
    """``torch.save`` of the model's ``state_dict`` with its config name."""
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"config": config, "state_dict": state}, str(path))


def load_weights(path: str | Path) -> tuple[str, dict[str, torch.Tensor]]:
    """(config name, state_dict) of a file written by ``save_weights``."""
    blob = torch.load(str(path), map_location="cpu", weights_only=True)
    return blob["config"], blob["state_dict"]
