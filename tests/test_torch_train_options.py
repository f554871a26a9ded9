"""The train step's options that came with classifier-free guidance, and the
validation step, against the JAX package on the smoke model.

- ``label_dropout`` at p = 1 replaces every label by -1 whatever the draws,
  so three steps of both packages from one JAX state (fp32, 2 microbatches,
  clipping, the norm metrics and ``log_norms_per_layer`` on, injected
  diffuser draws) compare as ``tests/test_torch_train_step.py`` compares
  them: every tensor within 2e-5 relative L2, every metric within 1e-4
  relative. The per-layer metric names equal the JAX step's.
- p = 0, or an unconditional model, draws nothing: the step is unchanged.
- ``make_eval_step`` against the JAX step on JAX's per-sample draws (fed to
  the port through its per-sample generators): plain, EMA and every-profile
  evaluation, a padded batch with its mask; 1e-5 relative.
- A batch that the accumulation count does not split raises in both.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import IMAGE, SMOKE_DENOISER, SMOKE_EMBEDDING, rel_l2
from tests.test_torch_train_step import (
    OPT,
    SCHED_COUNT,
    SIGMA_RELS,
    _batches,
    _compare_trees,
    _Injected,
    _jax_model,
    _jax_start,
    _JaxInjected,
    _port_state,
    _small_model,
)
from tinyedm_tpu.diffusion.diffuser import Diffuser as JaxDiffuser
from tinyedm_tpu.models.edm import EDM as JaxEDM
from tinyedm_tpu.models.layers import Embedding as JaxEmbedding
from tinyedm_tpu.models.unet import Denoiser as JaxDenoiser
from tinyedm_tpu.training import train_step as jts
from tinyedm_tpu.training.ema import EMAConfig as JaxEMAConfig
from tinyedm_tpu_torch.data.datamodules import SyntheticDataModule, to_device
from tinyedm_tpu_torch.diffusion.diffuser import Diffuser
from tinyedm_tpu_torch.models.edm import EDM
from tinyedm_tpu_torch.models.layers import Embedding
from tinyedm_tpu_torch.models.unet import Denoiser
from tinyedm_tpu_torch.training.ema import EMAConfig
from tinyedm_tpu_torch.training.train_step import (
    OptimizerConfig,
    init_train_state,
    make_eval_step,
    make_grad_fn,
    make_train_step,
)
from tinyedm_tpu_torch.utils.cuda import fold_seed
from tinyedm_tpu_torch.utils.interop import jax_group, train_state_from_jax

OPTIONS = dict(accum_steps=2, grad_clip_norm=1.0, log_norms=True, log_norms_per_layer=True,
               label_dropout=1.0)


def test_label_dropout_one_and_per_layer_norms_match_jax():
    opt_items = tuple(sorted({**OPT, **OPTIONS}.items()))
    start = _jax_start(torch.float32, opt_items)
    batches = _batches()
    jstep = jax.jit(jts.make_train_step(
        _jax_model(torch.float32), _JaxInjected(), jts.OptimizerConfig(**dict(opt_items)),
        JaxEMAConfig(SIGMA_RELS)))
    jstate = jax.tree_util.tree_map(jnp.asarray, start)
    jmetrics = []
    for images, labels in batches:
        jstate, m = jstep(jstate, (jnp.asarray(images), jnp.asarray(labels)), jax.random.PRNGKey(1), SCHED_COUNT)
        jmetrics.append({k: float(v) for k, v in m.items()})
    ref = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate))

    model, state = _port_state(torch.float32, start)
    step = make_train_step(model, _Injected(), OptimizerConfig(**dict(opt_items)), EMAConfig(SIGMA_RELS))
    for (images, labels), jm in zip(batches, jmetrics):
        state, m = step(state, to_device(images, labels, "cpu"), torch.Generator().manual_seed(0), SCHED_COUNT)
        assert set(m) == set(jm)
        for k, v in m.items():
            assert abs(float(v) - jm[k]) <= 1e-4 * abs(jm[k]) + 1e-7, (k, float(v), jm[k])
    per_layer = {k for k in jmetrics[0] if "/" in k}
    assert "grad_norm/denoiser.encoder_blocks_2" in per_layer and "param_norm/embedding.class_embed" in per_layer
    _compare_trees(state.params, ref.params, 2e-5, "params")
    _compare_trees(state.mu, ref.mu, 2e-5, "mu")
    _compare_trees(state.nu, ref.nu, 2e-5, "nu")
    for tree, rtree in zip(state.ema, ref.ema):
        _compare_trees(tree, rtree, 2e-5, "ema")


def test_per_layer_names_equal_jax_groups_with_uncertainty():
    """The groups of every parameter of a model with the uncertainty head
    (u.WNLinear_0, u.WNLinear_1, u.gain) against JAX's ``_param_groups``."""
    jmodel = JaxEDM(embedding=JaxEmbedding(**SMOKE_EMBEDDING, num_classes=10),
                    denoiser=JaxDenoiser(**SMOKE_DENOISER), use_uncertainty=True)
    shapes = jax.eval_shape(
        lambda r: jmodel.init(r, jnp.zeros(IMAGE), jnp.ones((2,)), jnp.zeros((2,), jnp.int32),
                              method=JaxEDM.denoise_with_aux),
        jax.random.PRNGKey(0))
    jax_names = {name for name, _ in jts._param_groups(shapes["params"])}
    port = EDM(Embedding(**SMOKE_EMBEDDING, num_classes=10), Denoiser(**SMOKE_DENOISER), use_uncertainty=True)
    assert {jax_group(k) for k, _ in port.named_parameters()} == jax_names
    assert {"u.WNLinear_0", "u.WNLinear_1", "u.gain", "denoiser.gain_out"} <= jax_names


def _one_step(model, opt_cfg, seed=5):
    images, labels = next(SyntheticDataModule(4, image_size=16, num_samples=4).train_batches(0))
    state = init_train_state(model, opt_cfg)
    _, m = make_train_step(model, Diffuser(), opt_cfg)(
        state, to_device(images, labels, "cpu"), torch.Generator().manual_seed(seed), 0)
    return float(m["train_loss"])


def test_label_dropout_zero_and_unconditional_draw_nothing():
    base = _one_step(_small_model(), OptimizerConfig(lr=0.01))
    assert _one_step(_small_model(), OptimizerConfig(lr=0.01, label_dropout=0.0)) == base
    assert _one_step(_small_model(), OptimizerConfig(lr=0.01, label_dropout=0.5)) != base
    uncond = EDM(Embedding(**SMOKE_EMBEDDING, num_classes=None),
                 Denoiser(**SMOKE_DENOISER, dtype=torch.bfloat16))
    uncond.load_state_dict({k: v for k, v in _small_model().state_dict().items()
                            if not k.startswith("embedding.class_embed")})
    uncond2 = EDM(Embedding(**SMOKE_EMBEDDING, num_classes=None),
                  Denoiser(**SMOKE_DENOISER, dtype=torch.bfloat16))
    uncond2.load_state_dict(uncond.state_dict())
    assert (_one_step(uncond, OptimizerConfig(lr=0.01, label_dropout=0.5))
            == _one_step(uncond2, OptimizerConfig(lr=0.01)))


def test_uneven_microbatches_raise_as_in_jax():
    """A batch of 5 in 2 microbatches: the JAX step's reshape raises, and so
    does the port's grad_fn (it averaged 2 and 3 samples with equal weight)."""
    opt_items = tuple(sorted({**OPT, "accum_steps": 2}.items()))
    start = _jax_start(torch.float32, opt_items)
    images = np.random.default_rng(0).standard_normal((5, *IMAGE[1:])).astype(np.float32)
    labels = np.arange(5, dtype=np.int32)
    jstep = jts.make_train_step(_jax_model(torch.float32), JaxDiffuser(), jts.OptimizerConfig(**dict(opt_items)))
    with pytest.raises((TypeError, ValueError), match="reshape"):
        jstep(jax.tree_util.tree_map(jnp.asarray, start), (jnp.asarray(images), jnp.asarray(labels)),
              jax.random.PRNGKey(0), SCHED_COUNT)
    model, state = _port_state(torch.float32, start)
    with pytest.raises(ValueError, match="equal microbatches"):
        make_grad_fn(model, Diffuser(), OptimizerConfig(**dict(opt_items)))(
            state, *to_device(images, labels, "cpu"), torch.Generator())


def _jax_sample_draws(rng, images: np.ndarray):
    """JAX's eval draws: sample i's (eps, noise) from fold_in(rng, i), as the
    JAX eval step's per-sample Diffuser call splits that key."""
    draws = []
    for i in range(images.shape[0]):
        k_sigma, k_noise = jax.random.split(jax.random.fold_in(rng, i))
        draws.append((np.asarray(jax.random.normal(k_sigma, (1,))),
                      np.asarray(jax.random.normal(k_noise, (1, *images.shape[1:])))))
    return draws


class _FedDiffuser(Diffuser):
    """The per-sample draws of the JAX eval step, by the sample index the
    port's per-sample generator is seeded with."""

    def __init__(self, draws, seed):
        super().__init__()
        object.__setattr__(self, "draws", {fold_seed(seed, i): d for i, d in enumerate(draws)})

    def __call__(self, clean_image, generator):
        eps, noise = self.draws[generator.initial_seed()]
        return self.apply(clean_image, torch.tensor(eps), torch.tensor(noise).permute(0, 3, 1, 2))


@pytest.mark.parametrize("options", [
    dict(), dict(use_ema=True, ema_index=1), dict(n_profiles=2, use_ema=True, ema_index=0),
], ids=["params", "ema1", "profiles"])
def test_eval_step_matches_jax(options):
    start = _jax_start(torch.float32, tuple(sorted(OPT.items())))
    rng = np.random.default_rng(9)
    ema = tuple(jax.tree_util.tree_map(lambda p, s=s: p + np.float32(0.05 * s) * rng.standard_normal(
        np.shape(p)).astype(np.float32), start.params) for s in (1, 2))
    start = dataclasses.replace(start, ema=ema)
    images, labels = _batches()[0]
    pad = 2
    images_p = np.concatenate([images, images[:pad]])
    labels_p = np.concatenate([labels, labels[:pad]])
    mask = np.concatenate([np.ones(len(images)), np.zeros(pad)]).astype(np.float32)
    key = jax.random.PRNGKey(3)

    jeval = jax.jit(jts.make_eval_step(_jax_model(torch.float32), JaxDiffuser(), **options))
    jstate = jax.tree_util.tree_map(jnp.asarray, start)
    ref = {k: float(v) for k, v in jeval(jstate, (jnp.asarray(images_p), jnp.asarray(labels_p),
                                                  jnp.asarray(mask)), key).items()}

    model, state = _port_state(torch.float32, start)
    diffuser = _FedDiffuser(_jax_sample_draws(key, images_p), seed=0)
    step = make_eval_step(model, diffuser, **options)
    x, y = to_device(images_p, labels_p, "cpu")
    out = {k: float(v) for k, v in step(state, (x, y, torch.from_numpy(mask)), 0).items()}
    assert set(out) == set(ref)
    for k in ref:
        assert abs(out[k] - ref[k]) <= 1e-5 * abs(ref[k]), (k, out[k], ref[k])
    assert out["count"] == len(images)
    # without the pad rows: the same sums (pad rows shift no real row's draws)
    unpadded = step(state, to_device(images, labels, "cpu"), 0)
    assert abs(float(unpadded["sse"]) - out["sse"]) <= 1e-6 * abs(out["sse"])
    assert float(unpadded["count"]) == len(images)


def test_eval_step_draws_depend_on_seed_and_sample_only():
    model = _small_model()
    state = init_train_state(model, OptimizerConfig(), EMAConfig())
    images, labels = next(SyntheticDataModule(4, image_size=16, num_samples=4).train_batches(0))
    x, y = to_device(images, labels, "cpu")
    step = make_eval_step(model, Diffuser())
    a, b, c = (float(step(state, (x, y), s)["sse"]) for s in (1, 1, 2))
    assert a == b != c and np.isfinite(a)
    first_two = float(step(state, (x[:2], y[:2]), 1)["sse"])
    masked = float(step(state, (x, y, torch.tensor([1.0, 1.0, 0.0, 0.0])), 1)["sse"])
    assert rel_l2(np.float64(masked), np.float64(first_two)) <= 1e-6
