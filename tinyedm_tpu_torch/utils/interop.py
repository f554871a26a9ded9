"""Weights and train states across the two packages, and the port's weight files.

``from_jax_variables`` carries a JAX ``{"params", "constants"}`` tree (as
numpy arrays) into the port's ``state_dict``: flax module names map to the
port's attribute names (``encoder_blocks_3`` -> ``encoder_blocks.3``,
ScaleLong's ``WNConv_0`` -> ``conv_0``, ClassEmbedding's and UncertaintyNet's
``WNLinear_0`` -> ``linear``, UncertaintyNet's ``WNLinear_1`` ->
``linear_out``, leaf ``w`` -> ``weight``), conv kernels go HWIO -> OIHW and
linears stay ``(out, in)``. The qkv output channels keep the JAX order
``(3, heads, hd)``. ``train_state_from_jax`` carries a whole JAX
``TrainState`` the same way; a ``scan_blocks=True`` tree (runs of blocks
stacked under ``{side}_scan_{start}``) is unstacked first
(``migrate_params_from_scanned``). Reading orbax checkpoints is not done
here: ``experiments/orbax_to_torch_state.py`` converts them where JAX is.

The reference (Lightning) layout, the counterpart of
``tinyedm_tpu/utils/interop.py`` under the same function names: the
reference's ``state_dict`` differs from the port's in names (ScaleLong's
``conv_0``/``conv_1`` are ``layer1``/``layer2``, UncertaintyNet's
``linear``/``linear_out`` are ``linear1``/``linear2``) and in the qkv conv's
output channels, which the reference orders ``(heads, hd, 3)``; every other
tensor is copied. ``import_torch_checkpoint`` and ``export_torch_checkpoint``
read and write Lightning ``.ckpt`` files (EMA as the reference's flat tuple,
Adam as a ``torch.optim.Adam`` state dict); run them as

    python -m tinyedm_tpu_torch.utils.interop import --torch_ckpt last.ckpt \
        --config experiments/conf/cifar10.yaml --out_dir runs/imported [--load_ema]
    python -m tinyedm_tpu_torch.utils.interop export --ckpt_dir runs/cifar10/checkpoints \
        --out exported.ckpt [--step N] [--ema_index I]

(the bare form without ``import`` works too). A ``.ckpt`` is read with
``torch.load(weights_only=True)``: the Lightning container classes of
``LOADED_AS_DICT`` load as dicts, and any other class raises ``ValueError``
naming it.
"""

from __future__ import annotations

import pickle
import re
from pathlib import Path
from typing import Any, Mapping, Optional, Sequence

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
        tree = migrate_params_from_scanned(variables_np.get(collection, {}))
        for path, arr in _flatten(tree).items():
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
    mu, nu, count = _adam_moments(jax_state.opt_state)
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
        mu=tree(mu),
        nu=tree(nu),
        count=int(count),
        ema=tuple(tree(e) for e in jax_state.ema),
    )


def _adam_moments(opt_state) -> tuple[Any, Any, Any]:
    """(mu, nu, count) of an optax ``scale_by_adam`` state: live
    (``ScaleByAdamState(count, mu, nu)``) or as orbax restores it without a
    target (the namedtuple as a ``{"0", "1", "2"}`` mapping or a 3-list, in
    field order), as ``tinyedm_tpu/utils/interop.py::_adam_moments`` reads it."""
    if hasattr(opt_state, "mu"):
        return opt_state.mu, opt_state.nu, opt_state.count
    if isinstance(opt_state, Mapping):
        if "mu" in opt_state and "nu" in opt_state:
            return opt_state["mu"], opt_state["nu"], opt_state["count"]
        if {"0", "1", "2"} <= set(opt_state):
            return opt_state["1"], opt_state["2"], opt_state["0"]
    if isinstance(opt_state, (list, tuple)) and len(opt_state) == 3:
        return opt_state[1], opt_state[2], opt_state[0]
    raise ValueError(f"cannot locate the Adam moments in an opt_state of type {type(opt_state)!r}")


def migrate_params_from_scanned(scanned: Mapping) -> dict:
    """Unstack every ``{side}_scan_{start}`` group of a JAX tree (numpy
    leaves, the block axis leading) into per-block subtrees
    ``{side}_blocks_{start + k}``, at any depth; other entries copy through.
    The numpy counterpart of the JAX package's function of the same name."""
    out = {}
    for name, sub in scanned.items():
        m = re.match(r"^(encoder|decoder)_scan_(\d+)$", str(name))
        if m:
            block = _flatten(sub["block"])
            length = int(next(iter(block.values())).shape[0])
            for k in range(length):
                out[f"{m.group(1)}_blocks_{int(m.group(2)) + k}"] = _unflatten(
                    {path: arr[k] for path, arr in block.items()}
                )
        elif isinstance(sub, Mapping):
            out[name] = migrate_params_from_scanned(sub)
        else:
            out[name] = sub
    return out


def _unflatten(flat: Mapping[tuple, Any]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value
    return tree


def save_weights(model: nn.Module, path: str | Path, config: str) -> None:
    """``torch.save`` of the model's ``state_dict`` with its config name."""
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"config": config, "state_dict": state}, str(path))


def load_weights(path: str | Path) -> tuple[str, dict[str, torch.Tensor]]:
    """(config name, state_dict) of a file written by ``save_weights``."""
    blob = torch.load(str(path), map_location="cpu", weights_only=True)
    return blob["config"], blob["state_dict"]


# ---------------------------------------------------------------------------
# The reference (Lightning) layout
# ---------------------------------------------------------------------------

# port name -> reference name, by dotted-name segment
_REFERENCE_NAMES = {"cat_factor.conv_0": "cat_factor.layer1", "cat_factor.conv_1": "cat_factor.layer2",
                    "u.linear": "u.linear1", "u.linear_out": "u.linear2"}
_PORT_NAMES = {v: k for k, v in _REFERENCE_NAMES.items()}
_QKV = ".attention.qkv_conv.weight"

# container classes of a Lightning .ckpt that load as plain dicts
LOADED_AS_DICT = (
    "lightning.fabric.utilities.data.AttributeDict",
    "pytorch_lightning.utilities.parsing.AttributeDict",
    "lightning.pytorch.utilities.parsing.AttributeDict",
)


def _tensor(x) -> torch.Tensor:
    """An fp32 CPU tensor that owns its memory (a copy)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32, copy=True).contiguous()
    return torch.from_numpy(np.array(x, np.float32, copy=True))


def conv_to_torch(w) -> torch.Tensor:
    """A port conv weight as the reference stores it: both are OIHW, so a
    copy (the JAX package's function transposes HWIO -> OIHW)."""
    return _tensor(w)


def conv_from_torch(w) -> torch.Tensor:
    """A reference conv weight as the port stores it: a copy."""
    return _tensor(w)


def qkv_perm_to_torch(w, heads: int) -> torch.Tensor:
    """The qkv conv weight (3C, C, 1, 1), output channels ordered (3, heads,
    hd) as the port (and the JAX package) keep them -> the reference's
    order (heads, hd, 3)."""
    w = _tensor(w)
    c3, rest = w.shape[0], w.shape[1:]
    hd = c3 // 3 // heads
    return w.reshape(3, heads, hd, *rest).permute(1, 2, 0, *range(3, 3 + len(rest))) \
        .reshape(c3, *rest).contiguous()


def qkv_perm_from_torch(w, heads: int) -> torch.Tensor:
    """Inverse of ``qkv_perm_to_torch``: (heads, hd, 3) -> (3, heads, hd)."""
    w = _tensor(w)
    c3, rest = w.shape[0], w.shape[1:]
    hd = c3 // 3 // heads
    return w.reshape(heads, hd, 3, *rest).permute(2, 0, 1, *range(3, 3 + len(rest))) \
        .reshape(c3, *rest).contiguous()


def _rename(key: str, names: Mapping[str, str]) -> str:
    for old, new in names.items():
        head, sep, tail = key.partition(old + ".")
        if sep and (not head or head.endswith(".")):
            return head + new + "." + tail
    return key


def reference_parameter_order(torch_sd: Mapping) -> list[str]:
    """Parameter names of a reference ``state_dict`` in the reference's
    ``model.parameters()`` order, the order of its flat EMA tuple and of its
    Adam state (``tinyedm_tpu/utils/interop.py::reference_parameter_order``,
    pinned there against the live reference module): each module's direct
    parameters before its submodules; embedding, denoiser, then the
    uncertainty head; optional modules by key presence; buffers excluded."""

    def block_count(side: str) -> int:
        idxs = [int(k.split(".")[2]) for k in torch_sd if k.startswith(f"denoiser.{side}_blocks.")]
        return max(idxs) + 1 if idxs else 0

    order = [
        "embedding.sigma_embed.weight",
        "embedding.class_embed.linear.weight",
        "denoiser.gain_out",
        "denoiser.conv_in.weight",
        "denoiser.conv_out.weight",
    ]
    for side in ("encoder", "decoder"):
        for i in range(block_count(side)):
            p = f"denoiser.{side}_blocks.{i}"
            order.append(f"{p}.gain")
            if side == "decoder":
                order += [f"{p}.cat_factor.layer1.weight", f"{p}.cat_factor.layer2.weight"]
            order += [
                f"{p}.conv_1x1.weight",
                f"{p}.conv_3x3_1.weight",
                f"{p}.conv_3x3_2.weight",
                f"{p}.attention.qkv_conv.weight",
                f"{p}.attention.out_conv.weight",
                f"{p}.embed.weight",
            ]
    order += ["u.gain", "u.linear1.weight", "u.linear2.weight"]
    return [k for k in order if k in torch_sd]


def ema_state_dict_from_flat(torch_sd: Mapping, ema_flat: Sequence) -> dict[str, torch.Tensor]:
    """A named reference ``state_dict`` from the reference's flat EMA tuple
    (``optimizer_states[0]["ema"]``, in ``reference_parameter_order``); the
    buffers come from ``torch_sd`` unchanged. Raises on a count or shape
    that does not match."""
    names = reference_parameter_order(torch_sd)
    if len(names) != len(ema_flat):
        raise ValueError(f"EMA tuple has {len(ema_flat)} tensors but the state_dict has "
                         f"{len(names)} parameters — architecture mismatch")
    out = {}
    for name, t in zip(names, ema_flat):
        t = _tensor(t)
        if tuple(t.shape) != tuple(torch_sd[name].shape):
            raise ValueError(f"EMA tensor for {name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(torch_sd[name].shape)} — parameter-order mismatch")
        out[name] = t
    for name, v in torch_sd.items():
        if name not in out:
            out[name] = _tensor(v)
    return out


def _heads(spec) -> int:
    return int(spec.denoiser.num_heads)


def edm_params_to_torch_state_dict(spec, port_sd: Mapping) -> dict[str, torch.Tensor]:
    """The port's EDM ``state_dict`` (or any tree of its names: EMA, Adam
    moments) -> the reference EDM LightningModule's, fp32 CPU copies.
    ``spec`` is the EDMSpec of the architecture (its ``num_heads``)."""
    heads = _heads(spec)
    sd = {}
    for key, value in port_sd.items():
        ref = _rename(key, _REFERENCE_NAMES)
        sd[ref] = qkv_perm_to_torch(value, heads) if key.endswith(_QKV) else conv_to_torch(value)
    return sd


def edm_params_from_torch_state_dict(spec, torch_sd: Mapping) -> dict[str, torch.Tensor]:
    """Inverse: a reference EDM ``state_dict`` -> the port's names and qkv
    order, fp32 CPU copies."""
    heads = _heads(spec)
    sd = {}
    for key, value in torch_sd.items():
        port = _rename(key, _PORT_NAMES)
        sd[port] = qkv_perm_from_torch(value, heads) if key.endswith(_QKV) else conv_from_torch(value)
    return sd


def reference_hyper_parameters(spec, ema_index: int = 0) -> dict:
    """The port's EDMSpec -> the reference EDM's ``hyper_parameters``, the
    tree the JAX package writes (``reference_hyper_parameters`` there):
    ``_target_`` dicts with the reference's ``tinyedm.*`` names and only the
    reference constructors' fields. The knobs with no reference counterpart
    (``mod_fp32``, ``remat``, ``remat_policy``, ``scan_blocks``,
    ``use_pallas_attention``, ``fused``, ``grad_clip_norm``, ``log_norms``,
    ``accum_steps``, ``ema_lengths``, ``val_ema_index``, ...) are dropped;
    with several EMA profiles ``ema_length`` is the exported profile's."""
    emb, den = spec.embedding, spec.denoiser
    sigma_rels = tuple(spec.ema_lengths or ())
    if not sigma_rels and spec.ema_length is not None:
        sigma_rels = (spec.ema_length,)
    ema_length = spec.ema_length
    if sigma_rels:
        if not 0 <= ema_index < len(sigma_rels):
            raise ValueError(f"ema_index={ema_index} out of range for {len(sigma_rels)} "
                             "tracked EMA profile(s)")
        ema_length = sigma_rels[ema_index]
    return {
        "_target_": "tinyedm.EDM",
        "diffuser": {"_target_": "tinyedm.Diffuser", "P_mean": spec.diffuser.P_mean,
                     "P_std": spec.diffuser.P_std},
        "embedding": {
            "_target_": "tinyedm.Embedding",
            "fourier_dim": emb.fourier_dim,
            "embedding_dim": emb.embedding_dim,
            "num_classes": emb.num_classes,
            "add_factor": emb.add_factor,
        },
        "denoiser": {
            "_target_": "tinyedm.Denoiser",
            "in_channels": den.in_channels,
            "out_channels": den.out_channels,
            "encoder_block_types": list(den.encoder_block_types),
            "decoder_block_types": list(den.decoder_block_types),
            "encoder_out_channels": list(den.encoder_out_channels),
            "decoder_out_channels": list(den.decoder_out_channels),
            "skip_connections": list(den.skip_connections),
            "dropout_rate": den.dropout_rate,
            "sigma_data": den.sigma_data,
            "encoder_add_factor": den.encoder_add_factor,
            "decoder_add_factor": den.decoder_add_factor,
            "embedding_dim": den.embedding_dim,
            "num_heads": den.num_heads,
        },
        "use_ema": spec.use_ema,
        "use_uncertainty": spec.use_uncertainty,
        "steady_steps": spec.steady_steps,
        "rampup_steps": spec.rampup_steps,
        "scheduler_interval": spec.scheduler_interval,
        "sigma_data": spec.sigma_data,
        "lr": spec.lr,
        "betas": list(spec.betas),
        "ema_length": ema_length,
        "validate_original_weights": spec.validate_original_weights,
        "every_n_steps": spec.every_n_steps,
        "cpu_offload": False,
    }


def adam_state_to_torch(spec, mu: Mapping, nu: Mapping, order: Sequence[str],
                        step: int) -> dict:
    """The port's Adam moments (``TrainState.mu``/``nu``, port names) -> a
    ``torch.optim.Adam.state_dict()`` over the parameters in ``order``
    (``reference_parameter_order``). Both store raw moments and correct the
    bias at use, so they carry over after the weights' layout change."""
    mu_sd = edm_params_to_torch_state_dict(spec, mu)
    nu_sd = edm_params_to_torch_state_dict(spec, nu)
    state = {
        i: {"step": torch.tensor(float(step)), "exp_avg": mu_sd[k], "exp_avg_sq": nu_sd[k]}
        for i, k in enumerate(order)
    }
    group = {
        "lr": spec.lr,
        "betas": tuple(spec.betas),
        "eps": 1e-8,
        "weight_decay": 0,
        "amsgrad": False,
        "maximize": False,
        "foreach": None,
        "capturable": False,
        "differentiable": False,
        "fused": None,
        "params": list(range(len(order))),
    }
    return {"state": state, "param_groups": [group]}


def load_reference_checkpoint(path: str | Path) -> Any:
    """``torch.load`` of a Lightning ``.ckpt`` or a raw ``state_dict``
    ``.pt`` with ``weights_only=True``: the classes of ``LOADED_AS_DICT``
    load as dicts; any other class raises ``ValueError`` naming it."""
    path = str(path)
    try:
        with torch.serialization.safe_globals([(dict, name) for name in LOADED_AS_DICT]):
            return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as err:
        try:
            names = torch.serialization.get_unsafe_globals_in_checkpoint(path)
        except Exception:  # an older torch, or a file it cannot scan
            names = []
        names = [n for n in names if n not in LOADED_AS_DICT]
        raise ValueError(
            f"{path}: refusing to unpickle class(es) {names or 'unknown'} "
            f"(loaded with weights_only=True; only tensors, plain containers and "
            f"{', '.join(LOADED_AS_DICT)} are read): {str(err).splitlines()[0]}"
        ) from err


def _model_names(spec) -> tuple[dict[str, tuple], dict[str, tuple]]:
    """(parameter name -> shape, buffer name -> shape) of the spec's model,
    built on the meta device (nothing allocated)."""
    with torch.device("meta"):
        model = spec.build_model()
    return ({k: tuple(p.shape) for k, p in model.named_parameters()},
            {k: tuple(b.shape) for k, b in model.named_buffers()})


def _check_names(sd: Mapping, expected: Mapping[str, tuple], what: str) -> None:
    missing, extra = sorted(set(expected) - set(sd)), sorted(set(sd) - set(expected))
    if missing or extra:
        raise KeyError(f"{what}: port keys missing {missing}; keys with no port counterpart {extra}")
    for k, shape in expected.items():
        if tuple(sd[k].shape) != shape:
            raise ValueError(f"{what}: {k} has shape {tuple(sd[k].shape)}, the model's is {shape}")


def import_torch_checkpoint(torch_ckpt: str | Path, config_path: str | Path,
                            out_dir: str | Path, load_ema: bool = False) -> TrainState:
    """A reference checkpoint (Lightning ``.ckpt`` or raw ``state_dict``
    ``.pt``) -> the port's checkpoint ``<out_dir>/<step>/state.pt`` with
    ``config.json`` (the config's ``model`` block), which ``generate
    --ckpt_path`` and the trainer read. ``load_ema`` brings the reference's
    flat EMA tuple in as EMA profile 0. As in the JAX package, Adam starts
    from zero moments at count 0 and the step is the ``global_step`` (0 for
    a raw state_dict). Returns the saved state."""
    from tinyedm_tpu_torch.config.registry import deinstantiate, instantiate, load_config
    from tinyedm_tpu_torch.training.checkpoint import save_checkpoint

    ckpt = load_reference_checkpoint(torch_ckpt)
    if isinstance(ckpt, Mapping) and "state_dict" in ckpt:
        torch_sd, step = ckpt["state_dict"], int(ckpt.get("global_step", 0))
    else:
        torch_sd, step = ckpt, 0
    spec = instantiate(load_config(config_path)["model"])
    param_shapes, buffer_shapes = _model_names(spec)
    sd = edm_params_from_torch_state_dict(spec, torch_sd)
    _check_names(sd, {**param_shapes, **buffer_shapes}, str(torch_ckpt))
    params = {k: sd[k] for k in param_shapes}
    ema = ()
    if load_ema:
        try:
            ema_flat = ckpt["optimizer_states"][0]["ema"]
        except (KeyError, IndexError, TypeError):
            raise ValueError("EMA weights not found in the checkpoint.") from None
        ema_sd = edm_params_from_torch_state_dict(spec, ema_state_dict_from_flat(torch_sd, ema_flat))
        ema = ({k: ema_sd[k] for k in param_shapes},)
    state = TrainState(
        step=step,
        params=params,
        constants={k: sd[k] for k in buffer_shapes},
        mu={k: torch.zeros_like(p) for k, p in params.items()},
        nu={k: torch.zeros_like(p) for k, p in params.items()},
        count=0,
        ema=ema,
    )
    save_checkpoint(out_dir, state, config={"model": deinstantiate(spec)})
    print(f"imported {torch_ckpt} (step {step}) -> {out_dir}")
    return state


def export_torch_checkpoint(ckpt_dir: str | Path, out_path: str | Path,
                            step: Optional[int] = None, ema_index: int = 0) -> dict:
    """The port's checkpoint -> a Lightning ``.ckpt`` that the reference's
    ``EDM.load_from_checkpoint`` reads (``load_ema=True`` too), the dict the
    JAX package's ``export_torch_checkpoint`` writes: ``state_dict``,
    ``global_step``, ``hyper_parameters`` and ``optimizer_states[0]``, a bare
    Adam state dict or, with EMA, the reference EMAOptimizer's ``{"opt",
    "ema", "current_step", "gamma", "every_n_steps"}`` with the EMA profile
    ``ema_index``. Returns the dict written."""
    from tinyedm_tpu_torch.config.registry import instantiate
    from tinyedm_tpu_torch.training.checkpoint import load_checkpoint
    from tinyedm_tpu_torch.training.ema import sigma_rel_to_gamma

    state, config = load_checkpoint(ckpt_dir, step)
    if config is None:
        raise ValueError(f"checkpoint at {ckpt_dir} has no embedded config; cannot build "
                         "reference hyper_parameters")
    spec = instantiate(config["model"] if "model" in config else config)
    gstep = int(state.step)
    sd = edm_params_to_torch_state_dict(spec, {**state.params, **state.constants})
    order = reference_parameter_order(sd)
    adam_sd = adam_state_to_torch(spec, state.mu, state.nu, order, gstep)
    if state.ema:
        # an EMA run wraps Adam in the reference's EMAOptimizer, whose state
        # dict nests Adam under "opt" beside the flat EMA tuple
        if not 0 <= ema_index < len(state.ema):
            raise ValueError(f"ema_index={ema_index} out of range: checkpoint tracks "
                             f"{len(state.ema)} EMA profile(s)")
        ema_sd = edm_params_to_torch_state_dict(spec, state.ema[ema_index])
        sigma_rels = tuple(spec.ema_lengths
                           or ((spec.ema_length,) if spec.ema_length is not None else ()))
        if sigma_rels and not 0 <= ema_index < len(sigma_rels):
            raise ValueError(
                f"ema_index={ema_index} has no declared sigma_rel: the spec declares "
                f"{len(sigma_rels)} EMA profile(s) while the checkpoint stores "
                f"{len(state.ema)} tree(s) — the exported gamma would be untraceable"
            )
        opt0: dict[str, Any] = {
            "opt": adam_sd,
            "ema": tuple(ema_sd[k] for k in order),
            "current_step": gstep,
            "gamma": float(sigma_rel_to_gamma(sigma_rels[ema_index])) if sigma_rels else 0.0,
            "every_n_steps": spec.every_n_steps,
        }
    else:
        opt0 = adam_sd  # no EMA: the reference's optimizer is a bare Adam
    hp = reference_hyper_parameters(spec, ema_index)
    if not state.ema and hp["use_ema"]:
        # the config asks for EMA but there is no tree (imported without
        # --load_ema): use_ema=True would make the reference read the bare
        # Adam dict as an EMAOptimizer's
        hp["use_ema"] = False
        hp["ema_length"] = None
        print("[export] checkpoint has no EMA trees; exporting use_ema=False")
    elif state.ema and not hp["use_ema"]:
        # EMA trees under a use_ema=False config: the reference would build a
        # bare Adam and fail on the nested dict, so the trees are dropped
        opt0 = adam_sd
        print("[export] checkpoint carries EMA tree(s) but the spec has use_ema=False; "
              "exporting a bare Adam (EMA trees dropped). Re-export with a use_ema: true "
              "config to keep them.")
    ckpt: dict[str, Any] = {
        "state_dict": sd,
        "global_step": gstep,
        "epoch": 0,
        "pytorch-lightning_version": "2.0.0",
        "hyper_parameters": hp,
        "lr_schedulers": [],
        "optimizer_states": [opt0],
    }
    torch.save(ckpt, str(out_path))
    print(f"exported {ckpt_dir} (step {gstep}) -> {out_path}")
    return ckpt


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "export":
        p = argparse.ArgumentParser(description="Export a port checkpoint as a reference-loadable "
                                                "Lightning .ckpt")
        p.add_argument("--ckpt_dir", required=True, help="the port's checkpoint directory")
        p.add_argument("--out", required=True, help="output .ckpt path")
        p.add_argument("--step", type=int, default=None)
        p.add_argument("--ema_index", type=int, default=0,
                       help="which tracked EMA profile rides in the reference's single-profile "
                            "optimizer_states[0]['ema'] slot")
        args = p.parse_args(argv[1:])
        export_torch_checkpoint(args.ckpt_dir, args.out, args.step, args.ema_index)
        return
    if argv and argv[0] == "import":
        argv = argv[1:]
    p = argparse.ArgumentParser(description="Import a reference torch checkpoint")
    p.add_argument("--torch_ckpt", required=True)
    p.add_argument("--config", required=True, help="matching experiment YAML")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--load_ema", action="store_true",
                   help="also import the reference's EMA weights (optimizer_states[0]['ema']) "
                        "as EMA profile 0")
    args = p.parse_args(argv)
    import_torch_checkpoint(args.torch_ckpt, args.config, args.out_dir, args.load_ema)


if __name__ == "__main__":
    main()
