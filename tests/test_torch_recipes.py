"""The MNIST and ImageNet-64 recipes in the port against the JAX package.

- ``configs.CONFIGS`` and ``TRAINING`` of ``mnist`` and ``imagenet``, which
  the port reads from ``experiments/conf/mnist.yaml`` and ``imagenet.yaml``,
  equal the JAX registry's reading of those files (ImageNet-64's topology
  the JAX Denoiser's default);
  parameter counts on the meta device, MNIST's against the JAX model's
  shapes (``jax.eval_shape``: nothing drawn); ``build_training`` takes both
  names (at smoke width).
- ``CosineAttention`` at MNIST's token counts, n = 196 (14x14, 4 heads of
  64) and 49 (7x7, 4 heads of 128), where the port's ``fused="auto"`` takes
  the fused kernel route (its plain version on the CPU) and the JAX layer
  its XLA branch: fp32 within 1e-5, bf16 within 8e-3 (the fused-attention
  tests' tolerances); and against the JAX Pallas kernel in interpret mode.
- A narrow MNIST-shaped model (28x28x1, 10 classes, attention at 14x14 and
  7x7) forward against the JAX model on the same weights, fp32, 1e-4.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import jax_attention, nhwc_to_torch, rel_l2, torch_to_nhwc
from tinyedm_tpu.config.registry import load_config
from tinyedm_tpu.models import topology as jax_topology
from tinyedm_tpu.models.edm import EDM as JaxEDM
from tinyedm_tpu.models.layers import CosineAttention as JaxCosineAttention
from tinyedm_tpu.models.layers import Embedding as JaxEmbedding
from tinyedm_tpu.models.unet import Denoiser as JaxDenoiser
from tinyedm_tpu_torch import configs
from tinyedm_tpu_torch.models.edm import EDM
from tinyedm_tpu_torch.models.layers import CosineAttention, Embedding, UncertaintyNet
from tinyedm_tpu_torch.models.unet import Denoiser
from tinyedm_tpu_torch.ops import fused_attention as fa
from tinyedm_tpu_torch.utils.interop import from_jax_variables

CONF = Path(__file__).resolve().parent.parent / "experiments" / "conf"
TRAINING_KEYS = ("use_uncertainty", "lr", "steady_steps", "rampup_steps", "scheduler_interval",
                 "use_ema", "ema_length", "every_n_steps")


def _yaml_blocks(name: str, default_topology: bool = False) -> tuple[dict, dict]:
    cfg = load_config(CONF / f"{name}.yaml")
    model = cfg["model"]
    den = {k: v for k, v in model["denoiser"].items() if k != "_target_"}
    if default_topology:
        den.update(
            encoder_block_types=list(jax_topology.default_encoder_block_types()),
            decoder_block_types=list(jax_topology.default_decoder_block_types()),
            encoder_out_channels=list(jax_topology.default_encoder_out_channels()),
            decoder_out_channels=list(jax_topology.default_decoder_out_channels()),
            skip_connections=list(jax_topology.default_skip_connections()),
        )
    emb = {k: v for k, v in model["embedding"].items() if k != "_target_"}
    training = {
        "seed": cfg["seed"],
        "batch_size": cfg["datamodule"]["batch_size"],
        "accumulate_grad_batches": cfg["trainer"]["accumulate_grad_batches"],
        "diffuser": {k: v for k, v in model["diffuser"].items() if k != "_target_"},
        **{k: model[k] for k in TRAINING_KEYS},
    }
    return {"embedding": emb, "denoiser": den}, training


@pytest.mark.parametrize("name,default_topology", [("mnist", False), ("imagenet", True)])
def test_constants_equal_yaml(name, default_topology):
    model, training = _yaml_blocks(name, default_topology)
    assert configs.CONFIGS[name] == model
    assert configs.TRAINING[name] == training


def test_imagenet_recipe_values():
    """The ImageNet-64 numbers the slice relies on: 176 per datamodule batch
    in 3 microbatches (176 is not a multiple of 3), lr 0.01 per step, one
    EMA profile, no uncertainty head, no flash route."""
    t = configs.TRAINING["imagenet"]
    assert (t["batch_size"], t["accumulate_grad_batches"], t["lr"], t["scheduler_interval"]) == (
        176, 3, 0.01, "step")
    assert t["batch_size"] % t["accumulate_grad_batches"] != 0
    assert "use_pallas_attention" not in configs.CONFIGS["imagenet"]["denoiser"]


def test_parameter_counts():
    with torch.device("meta"):
        mnist = configs.model_from_config("mnist")
        imagenet = configs.model_from_config("imagenet")
        u = UncertaintyNet(192, 192)
    cfg = configs.CONFIGS["mnist"]
    jmodel = JaxEDM(
        embedding=JaxEmbedding(**cfg["embedding"]),
        denoiser=JaxDenoiser(**{k: v for k, v in cfg["denoiser"].items() if k != "dtype"}),
    )
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)),
                            jnp.ones((1,)), jnp.zeros((1,), jnp.int32))
    jax_count = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in mnist.parameters()) == jax_count == 87_194_724
    # ImageNet-512's 272,949,794 without its uncertainty head
    assert sum(p.numel() for p in imagenet.parameters()) == 272_949_794 - sum(
        p.numel() for p in u.parameters()) == 272_912_545
    attn = [m for m in mnist.modules() if isinstance(m, CosineAttention)]
    assert [m.qkv_conv.weight.shape[1] for m in attn] == [256] * 3 + [512] * 3 + [512] * 5 + [256] * 4
    assert mnist.conditional and mnist.u is None and imagenet.u is None


@pytest.mark.parametrize("name,batch,accum,ema", [("mnist", 128, 1, None), ("imagenet", 176, 3, (0.13,))])
def test_build_training_recipe(monkeypatch, name, batch, accum, ema):
    smoke = configs.CONFIGS["smoke"]
    small = {"embedding": smoke["embedding"], "denoiser": smoke["denoiser"]}
    monkeypatch.setitem(configs.CONFIGS, name, small)
    model, diffuser, opt_cfg, ema_cfg, b, interval = configs.build_training(name, "cpu")
    t = configs.TRAINING[name]
    assert (b, opt_cfg.accum_steps, opt_cfg.lr, interval) == (batch, accum, t["lr"], t["scheduler_interval"])
    assert (diffuser.P_mean, diffuser.P_std) == (t["diffuser"]["P_mean"], t["diffuser"]["P_std"])
    assert (ema_cfg.sigma_rels if ema_cfg else None) == ema
    assert model.u is None


def _attention_inputs(side, channels, seed):
    return np.random.default_rng(seed).standard_normal((2, side, side, channels)).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("side,channels", [(14, 256), (7, 512)])
def test_cosine_attention_at_mnist_token_counts(side, channels, dtype):
    """n = 196 and 49 with 4 heads: the port's fused route (plain version)
    against the JAX layer's XLA branch and its Pallas kernel (interpret)."""
    n = side * side
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x = _attention_inputs(side, channels, seed=n)
    jmod = JaxCosineAttention(num_heads=4, dtype=jdtype)
    variables = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(n), jnp.asarray(x)))
    port = CosineAttention(channels, 4, dtype=dtype)
    port.load_state_dict(from_jax_variables(variables, port))
    assert n <= fa.MAX_FUSED_TOKENS and port.fused == "auto"
    with torch.no_grad():
        out = torch_to_nhwc(port(nhwc_to_torch(x)))
    tol = 1e-5 if dtype == torch.float32 else 8e-3
    for fused in ("off", "on"):
        with jax_attention(fused):
            ref = np.asarray(jmod.apply(variables, jnp.asarray(x)).astype(jnp.float32))
        np.testing.assert_allclose(out, ref, atol=tol, rtol=tol, err_msg=fused)


# MNIST's structure at narrow width: 28x28x1, EncD to 14x14 (attention at
# C 32, 2 heads of 16: n = 196) and to 7x7 (attention at C 64, 2 heads of
# 32: n = 49), the decoder mirroring it with skips, 10 classes
NARROW_MNIST = {
    "in_channels": 1,
    "out_channels": 1,
    "sigma_data": 0.5,
    "embedding_dim": 32,
    "encoder_block_types": ["Enc", "EncD", "EncA", "EncD", "EncA"],
    "decoder_block_types": ["DecA", "Dec", "DecA", "DecA", "DecU", "DecA", "Dec", "DecU", "Dec", "Dec"],
    "encoder_out_channels": [16, 16, 32, 32, 64],
    "decoder_out_channels": [64, 64, 64, 64, 64, 32, 32, 32, 16, 16],
    "skip_connections": [False, False, True, True, False, True, True, False, True, True],
    "num_heads": 2,
}
NARROW_EMBEDDING = {"fourier_dim": 16, "embedding_dim": 32, "num_classes": 10}


def test_narrow_mnist_model_matches_jax():
    jmodel = JaxEDM(embedding=JaxEmbedding(**NARROW_EMBEDDING), denoiser=JaxDenoiser(**NARROW_MNIST))
    x = np.random.default_rng(3).standard_normal((2, 28, 28, 1)).astype(np.float32)
    sigma, labels = np.asarray([0.7, 12.0], np.float32), np.asarray([3, 9], np.int32)
    variables = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(2)}, jnp.asarray(x),
                                     jnp.asarray(sigma), jnp.asarray(labels))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables = {k: dict(v) for k, v in variables.items()}
    variables["params"]["denoiser"] = {**variables["params"]["denoiser"], "gain_out": np.float32(1.0)}
    ref = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x), jnp.asarray(sigma), jnp.asarray(labels)))

    port = EDM(Embedding(**NARROW_EMBEDDING), Denoiser(**NARROW_MNIST))
    port.load_state_dict(from_jax_variables(variables, port))
    attn = [m for m in port.modules() if isinstance(m, CosineAttention)]
    assert [m.qkv_conv.weight.shape[1] for m in attn] == [32, 64, 64, 64, 64, 32]
    fa.launch_counts.clear()
    with torch.no_grad():
        out = torch_to_nhwc(port.eval()(nhwc_to_torch(x), torch.from_numpy(sigma),
                                        torch.from_numpy(labels).long()))
    assert np.isfinite(out).all() and out.shape == x.shape
    assert rel_l2(out, ref) <= 1e-4
    assert not fa.launch_counts  # on the CPU the plain version runs, no kernel
