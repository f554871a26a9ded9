"""The ImageNet-512 latent recipe in the port against the JAX package.

- ``configs.IMAGENET512`` and ``IMAGENET512_TRAINING`` equal
  ``experiments/conf/imagenet512.yaml``, the topology the JAX Denoiser's
  defaults; the full-width model has 272,949,794 parameters (counted on the
  meta device: drawing 1.1 GB of weights on the CPU is not needed).
- A smoke-width model with the recipe's structure: 4-channel 32x32
  latents, one ``EncA`` and one ``DecA`` at 32x32 (n = 1024, so the
  ``use_pallas_attention`` flash route runs: the JAX flash kernel in
  interpret mode, the port's plain flash Function), class-conditional over
  1000 classes, the uncertainty head, two EMA profiles, 4-way accumulation on
  a batch of 8 and a per-step lr count through rampup, steady and decay.
  Three train steps from one JAX state, carried across by
  ``train_state_from_jax``, in fp32: params, Adam moments and both EMA trees
  within relative L2 2e-5 (the training slice's bar), the metrics within
  1e-4 relative. The diffuser's draws are injected on both sides.
- Class-conditional Heun-3 at that size against the JAX
  ``DeterministicSolver``: relative L2 <= 1e-4 (the solver tests' bound).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests._torch_parity import rel_l2
from tinyedm_tpu.config.registry import load_config
from tinyedm_tpu.data.datamodules import SyntheticDataModule as JaxSynthetic
from tinyedm_tpu.diffusion.diffuser import Diffuser as JaxDiffuser
from tinyedm_tpu.diffusion.solver import DeterministicSolver as JaxSolver
from tinyedm_tpu.models import topology as jax_topology
from tinyedm_tpu.models.edm import EDM as JaxEDM
from tinyedm_tpu.models.layers import Embedding as JaxEmbedding
from tinyedm_tpu.models.unet import Denoiser as JaxDenoiser
from tinyedm_tpu.training import train_step as jts
from tinyedm_tpu.training.ema import EMAConfig as JaxEMAConfig
from tinyedm_tpu_torch import configs
from tinyedm_tpu_torch.data.datamodules import SyntheticDataModule, to_device
from tinyedm_tpu_torch.diffusion.diffuser import Diffuser
from tinyedm_tpu_torch.diffusion.solver import DeterministicSolver
from tinyedm_tpu_torch.models.edm import EDM
from tinyedm_tpu_torch.models.layers import CosineAttention, Embedding
from tinyedm_tpu_torch.models.unet import Denoiser
from tinyedm_tpu_torch.ops import attention as fl
from tinyedm_tpu_torch.training.ema import EMAConfig
from tinyedm_tpu_torch.training.train_step import OptimizerConfig, make_train_step
from tinyedm_tpu_torch.utils.interop import from_jax_variables, train_state_from_jax

ROOT = configs.__file__.rsplit("/tinyedm_tpu_torch/", 1)[0]
YAML = f"{ROOT}/experiments/conf/imagenet512.yaml"

# the recipe's structure at smoke width: 32x32x4 latents, EncA and DecA at
# 32x32 (n = 1024: the flash route), EncD/DecU around one 16x16 level
SMALL_EMBEDDING = {"fourier_dim": 16, "embedding_dim": 32, "num_classes": 1000}
SMALL_DENOISER = {
    "in_channels": 4,
    "out_channels": 4,
    "sigma_data": 0.5,
    "embedding_dim": 32,
    "encoder_block_types": ["EncA", "EncD"],
    "decoder_block_types": ["Dec", "Dec", "DecU", "DecA", "Dec"],
    "encoder_out_channels": [32, 64],
    "decoder_out_channels": [64, 64, 32, 32, 32],
    "skip_connections": [False, True, False, True, True],
    "num_heads": 2,
    "use_pallas_attention": True,
}
LATENT = (8, 32, 32, 4)  # batch 8: 4 microbatches of 2
OPT = dict(lr=0.01, rampup_steps=2, steady_steps=2, accum_steps=4)
SIGMA_RELS = (0.05, 0.13)
SCHED_COUNTS = (1, 2, 5)  # per step: in the rampup, steady, then the decay


def test_constants_equal_yaml_and_jax_topology():
    cfg = load_config(YAML)
    model = cfg["model"]
    den = {k: v for k, v in model["denoiser"].items() if k != "_target_"}
    den.update(
        encoder_block_types=list(jax_topology.default_encoder_block_types()),
        decoder_block_types=list(jax_topology.default_decoder_block_types()),
        encoder_out_channels=list(jax_topology.default_encoder_out_channels()),
        decoder_out_channels=list(jax_topology.default_decoder_out_channels()),
        skip_connections=list(jax_topology.default_skip_connections()),
    )
    emb = {k: v for k, v in model["embedding"].items() if k != "_target_"}
    assert configs.IMAGENET512 == {"embedding": emb, "denoiser": den}
    assert configs.CONFIGS["imagenet512"] is configs.IMAGENET512
    expected = {
        "seed": cfg["seed"],
        "batch_size": cfg["datamodule"]["batch_size"],
        "accumulate_grad_batches": cfg["trainer"]["accumulate_grad_batches"],
        "diffuser": {k: v for k, v in model["diffuser"].items() if k != "_target_"},
        **{k: model[k] for k in ("use_uncertainty", "lr", "steady_steps", "rampup_steps",
                                 "scheduler_interval", "use_ema", "ema_length", "ema_lengths",
                                 "every_n_steps")},
    }
    assert configs.IMAGENET512_TRAINING == expected


def test_full_width_parameter_count():
    with torch.device("meta"):
        model = configs.model_from_config("imagenet512")
    assert sum(p.numel() for p in model.parameters()) == 272_949_794
    assert model.conditional and model.u is not None and model.denoiser.dtype == torch.bfloat16
    attn = [m for m in model.modules() if isinstance(m, CosineAttention)]
    assert len(attn) == 15 and all(m.use_pallas for m in attn)


def test_build_training_recipe(monkeypatch):
    """The recipe around the model (built at smoke width here): two EMA
    profiles from ema_lengths, 4-way accumulation, the per-step interval."""
    small = {"embedding": SMALL_EMBEDDING,
             "denoiser": {**SMALL_DENOISER, "dtype": "bfloat16", "dropout_rate": 0.0}}
    monkeypatch.setitem(configs.CONFIGS, "imagenet512", small)
    model, diffuser, opt_cfg, ema_cfg, batch, interval = configs.build_training("imagenet512", "cpu")
    assert (diffuser.P_mean, diffuser.P_std, batch, interval) == (-0.4, 1.0, 128, "step")
    assert (opt_cfg.lr, opt_cfg.rampup_steps, opt_cfg.steady_steps, opt_cfg.accum_steps) == (
        0.008, 2000, 70000, 4)
    assert ema_cfg.sigma_rels == (0.05, 0.13) and ema_cfg.every_n_steps == 1
    assert model.u is not None and model.conditional


def test_synthetic_latents_reach_the_step_as_int64():
    images, labels = next(SyntheticDataModule(4, image_size=64, num_channels=4, num_samples=4,
                                              num_classes_=1000).train_batches(0))
    x, y = to_device(images, labels, "cpu")
    assert x.shape == (4, 4, 64, 64) and x.dtype == torch.float32
    assert y.dtype == torch.int64 and int(y.max()) < 1000


def _draws(b: int):
    """(eps (b,), noise NHWC): the first b rows of one fixed draw, so that a
    microbatch takes the same rows on both sides."""
    rng = np.random.default_rng(0)
    eps = rng.standard_normal((LATENT[0],)).astype(np.float32)
    return eps[:b], rng.standard_normal(LATENT).astype(np.float32)[:b]


class _JaxInjected(JaxDiffuser):
    def __call__(self, rng, clean_image):
        eps, noise = _draws(clean_image.shape[0])
        sigma = jnp.exp(self.P_mean + jnp.asarray(eps) * self.P_std)
        return clean_image.astype(jnp.float32) + jnp.asarray(noise) * sigma.reshape(-1, 1, 1, 1), sigma


class _Injected(Diffuser):
    def __call__(self, clean_image, generator):
        eps, noise = _draws(clean_image.shape[0])
        return self.apply(clean_image, torch.from_numpy(eps),
                          torch.from_numpy(noise).permute(0, 3, 1, 2))


def _jax_model():
    return JaxEDM(embedding=JaxEmbedding(**SMALL_EMBEDDING),
                  denoiser=JaxDenoiser(**SMALL_DENOISER), use_uncertainty=True)


def _port_model():
    return EDM(Embedding(**SMALL_EMBEDDING), Denoiser(**SMALL_DENOISER), use_uncertainty=True)


@functools.lru_cache(maxsize=None)
def _jax_start():
    """The JAX start state (numpy leaves), with gain_out and the uncertainty
    gain made nonzero so that every parameter gets a gradient at step 0."""
    state = jts.init_train_state(
        jax.random.PRNGKey(0), _jax_model(), jnp.zeros(LATENT), jts.OptimizerConfig(**OPT),
        JaxEMAConfig(SIGMA_RELS), jnp.zeros((LATENT[0],), jnp.int32),
    )
    params = dict(state.params)
    params["denoiser"] = {**params["denoiser"], "gain_out": jnp.float32(1.0)}
    params["u"] = {**params["u"], "gain": jnp.float32(0.5)}
    state = state.replace(params=params, ema=tuple(params for _ in SIGMA_RELS))
    return jax.tree_util.tree_map(np.asarray, state)


def _compare_trees(port: dict, ref: dict, bound: float, what: str) -> None:
    assert set(port) == set(ref), what
    for k in ref:
        a, b = port[k].detach().double().numpy(), ref[k].double().numpy()
        err = rel_l2(a, b) if np.linalg.norm(b) > 0 else float(np.abs(a).max())
        assert err <= bound, (what, k, err)


def test_recipe_three_steps_match_jax():
    start = _jax_start()
    batches = list(JaxSynthetic(LATENT[0], image_size=LATENT[1], num_channels=LATENT[3],
                                num_samples=3 * LATENT[0], num_classes_=1000, seed=5)
                   .train_batches(0))

    jstep = jax.jit(jts.make_train_step(_jax_model(), _JaxInjected(P_std=1.0, P_mean=-0.4),
                                        jts.OptimizerConfig(**OPT), JaxEMAConfig(SIGMA_RELS)))
    jstate = jax.tree_util.tree_map(jnp.asarray, start)
    jmetrics = []
    for (images, labels), count in zip(batches, SCHED_COUNTS):
        jstate, m = jstep(jstate, (jnp.asarray(images), jnp.asarray(labels)),
                          jax.random.PRNGKey(1), count)
        jmetrics.append({k: float(v) for k, v in m.items()})
    ref = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate))

    model = _port_model()
    state = train_state_from_jax(start, model)
    step = make_train_step(model, _Injected(P_std=1.0, P_mean=-0.4), OptimizerConfig(**OPT),
                           EMAConfig(SIGMA_RELS))
    before = dict(fl.launch_counts)
    for (images, labels), count, jm in zip(batches, SCHED_COUNTS, jmetrics):
        state, m = step(state, to_device(images, labels, "cpu"), None, count)
        assert set(m) == set(jm) and "uncertainty" in m
        for k, v in m.items():
            assert abs(float(v) - jm[k]) <= 1e-4 * abs(jm[k]) + 1e-7, (k, float(v), jm[k])
    assert dict(fl.launch_counts) == before  # the CPU runs the plain versions

    assert (state.step, state.count) == (ref.step, ref.count) == (3, 3)
    _compare_trees(state.params, ref.params, 2e-5, "params")
    _compare_trees(state.mu, ref.mu, 2e-5, "mu")
    _compare_trees(state.nu, ref.nu, 2e-5, "nu")
    assert len(state.ema) == len(ref.ema) == 2
    for tree, rtree in zip(state.ema, ref.ema):
        _compare_trees(tree, rtree, 2e-5, "ema")


def test_class_conditional_heun_matches_jax():
    start = _jax_start()
    variables = {"params": start.params, "constants": start.constants}
    jmodel = _jax_model()
    port = _port_model()
    port.load_state_dict(from_jax_variables(variables, port))
    rng = np.random.default_rng(9)
    noise = rng.standard_normal((2, 32, 32, 4)).astype(np.float32)
    labels = rng.integers(0, 1000, size=(2,)).astype(np.int32)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    ref = JaxSolver(num_steps=3).solve(lambda x, s, lab: jmodel.apply(jvars, x, s, lab),
                                       jnp.asarray(noise), jnp.asarray(labels))
    with torch.inference_mode():
        out = DeterministicSolver(num_steps=3).solve(
            port.eval(), torch.from_numpy(noise).permute(0, 3, 1, 2).contiguous(),
            torch.from_numpy(labels.astype(np.int64)))
    assert rel_l2(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref)) <= 1e-4


def test_seeded_labels_and_noise_equal_jax():
    """generate()'s feed at --num_classes 1000: the same seeded noise and
    labels as the JAX RandomNoiseDataModule."""
    from tinyedm_tpu.data.datamodules import RandomNoiseDataModule as JaxNoise
    from tinyedm_tpu_torch.data.datamodules import RandomNoiseDataModule

    kwargs = dict(batch_size=3, image_size=8, num_samples=7, num_classes=1000, num_channels=4, seed=11)
    ours, theirs = RandomNoiseDataModule(**kwargs), JaxNoise(**kwargs)
    pairs = list(zip(ours.predict_batches(), theirs.predict_batches()))
    assert len(pairs) == 3
    for (n1, l1, i1), (n2, l2, i2) in pairs:
        assert n1.shape[-1] == 4 and np.array_equal(n1, n2)
        assert np.array_equal(l1, l2) and np.array_equal(i1, i2)
        assert l1.dtype == np.int32 and l1.max() < 1000
