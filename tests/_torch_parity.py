"""Shared set-up of the port's parity tests: one small EDM built in both
packages with the same weights (JAX init, carried over by
``tinyedm_tpu_torch.utils.interop.from_jax_variables``)."""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import linen as nn

from tinyedm_tpu.models.edm import EDM as JaxEDM
from tinyedm_tpu.models.layers import CosineAttention as JaxCosineAttention
from tinyedm_tpu.models.layers import Embedding as JaxEmbedding
from tinyedm_tpu.models.unet import Denoiser as JaxDenoiser
from tinyedm_tpu_torch.configs import CONFIGS
from tinyedm_tpu_torch.models.edm import EDM
from tinyedm_tpu_torch.models.layers import CosineAttention, Embedding
from tinyedm_tpu_torch.models.unet import Denoiser
from tinyedm_tpu_torch.utils.interop import from_jax_variables

# the suite runs in several worker processes: one intra-op thread each keeps
# torch from oversubscribing the cores
torch.set_num_threads(1)

JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}

# experiments/conf/smoke.yaml: 16x16 images, widths 32-64, every block type
# (Enc, EncD, EncA, DecA, Dec, DecU), skips, channel changes (conv_1x1) and
# ScaleLong, attention at 8x8 (n=64) with 2 heads of 32
SMOKE_DENOISER = {
    k: v for k, v in CONFIGS["smoke"]["denoiser"].items() if k not in ("dtype", "dropout_rate")
}
SMOKE_EMBEDDING = {k: v for k, v in CONFIGS["smoke"]["embedding"].items() if k != "num_classes"}
IMAGE = (2, 16, 16, 3)


@functools.lru_cache(maxsize=None)
def _jax_variables(seed: int) -> dict:
    """Variables of the conditional small model (one jitted init; the
    unconditional model's are the same without ``class_embed``), as numpy,
    with ``gain_out`` set to 1: at its init value 0 the denoiser output is
    c_skip * x whatever the network computes."""
    jmodel = JaxEDM(
        embedding=JaxEmbedding(**SMOKE_EMBEDDING, num_classes=10),
        denoiser=JaxDenoiser(**SMOKE_DENOISER),
    )
    variables = jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(seed)},
        jnp.zeros(IMAGE), jnp.ones((IMAGE[0],)), jnp.zeros((IMAGE[0],), jnp.int32),
    )
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables = {k: dict(v) for k, v in variables.items()}
    variables["params"]["denoiser"] = dict(variables["params"]["denoiser"])
    variables["params"]["denoiser"]["gain_out"] = np.float32(1.0)
    return variables


def smoke_jax_state():
    """A JAX ``TrainState`` of the conditional small model, numpy leaves:
    seed 0's params (gain_out 1) and constants, Adam moments drawn from a
    seeded normal (``nu`` positive) with count 3, step 7, and one EMA tree,
    seed 1's params, so that train and EMA weights differ."""
    import optax

    from tinyedm_tpu.training.state import TrainState as JaxTrainState

    params, ema = _jax_variables(0)["params"], _jax_variables(1)["params"]
    rng = np.random.default_rng(0)
    mu = jax.tree_util.tree_map(lambda a: rng.standard_normal(np.shape(a)).astype(np.float32), params)
    nu = jax.tree_util.tree_map(lambda a: np.abs(rng.standard_normal(np.shape(a))).astype(np.float32), params)
    return JaxTrainState(
        step=np.int32(7), params=params, constants=_jax_variables(0)["constants"],
        opt_state=optax.ScaleByAdamState(count=np.int32(3), mu=mu, nu=nu), ema=(ema,),
    )


def small_models(num_classes, dtype: torch.dtype, seed: int = 0):
    """(jax_model, jax_variables, port_model) sharing JAX-initialized weights."""
    variables = dict(_jax_variables(seed))
    if num_classes is None:
        variables["params"] = dict(variables["params"])
        variables["params"]["embedding"] = {
            k: v for k, v in variables["params"]["embedding"].items() if k != "class_embed"
        }
    jmodel = JaxEDM(
        embedding=JaxEmbedding(**SMOKE_EMBEDDING, num_classes=num_classes),
        denoiser=JaxDenoiser(**SMOKE_DENOISER, dtype=JAX_DTYPES[dtype]),
    )
    port = EDM(
        Embedding(**SMOKE_EMBEDDING, num_classes=num_classes),
        Denoiser(**SMOKE_DENOISER, dtype=dtype),
    )
    port.load_state_dict(from_jax_variables(variables, port))
    return jmodel, variables, port.eval()


def _set_fused(fused, next_fun, args, kwargs, context):
    if isinstance(context.module, JaxCosineAttention) and context.method_name == "__call__":
        object.__setattr__(context.module, "fused", fused)
    return next_fun(*args, **kwargs)


@contextlib.contextmanager
def jax_attention(fused: str):
    """JAX applies inside run CosineAttention with ``fused`` ("off": the XLA
    path, the CPU default; "on": the Pallas kernel in interpret mode;
    "block": the whole-block Pallas kernels in interpret mode, where they
    fit)."""
    if fused == "off":
        yield
        return
    with nn.intercept_methods(functools.partial(_set_fused, fused)):
        yield


def set_port_attention(model: torch.nn.Module, fused: str) -> None:
    """Every CosineAttention of the port's ``model`` runs with ``fused``."""
    for m in model.modules():
        if isinstance(m, CosineAttention):
            m.fused = fused


def nhwc_to_torch(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).contiguous()


def torch_to_nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().permute(0, 2, 3, 1).numpy()


def rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))
