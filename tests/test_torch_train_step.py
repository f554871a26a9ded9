"""The port's train step against the JAX package's, on the smoke model.

Both packages start from one JAX-initialized state (``init_train_state``,
then ``gain_out`` set to 1 so that every parameter gets a gradient at step
0), carried across by ``train_state_from_jax``. The diffuser's sigma and
noise are injected (a ``Diffuser`` subclass on each side, so no JAX code
changes), dropout is 0 in the smoke topology's parity form, and the schedule
count is past the rampup so the lr is not 1e-8. Three steps on three
SyntheticDataModule batches, then the loss of each step and every tensor of
the params, Adam moments and EMA trees are compared by relative L2:

- fp32 (with accumulation over 2 microbatches, global-norm clipping and the
  norm metrics on): <= 2e-5 for every tensor and 1e-4 relative for the
  metrics (measured at most 6.4e-7 for params and EMA, 2.7e-6 for the Adam
  moments: the frameworks sum in other orders);
- bf16: <= 1e-2 for params and EMA, 1e-1 for the Adam moments, 1e-2
  relative for the metrics (measured 2.1e-3 and 4.1e-2: each side rounds to
  bf16 at its own places through ~10 layers, and Adam's early updates are
  close to sign(g), so a small gradient entry that differs in sign moves a
  parameter by a whole lr step).

One step's gradients are compared with the JAX package's loss gradient with
its attention forced "on" (the Pallas kernels in interpret mode) and "off"
(XLA), by relative L2 over all gradients: fp32 <= 2e-5 (measured 4e-7),
bf16 <= 2e-2 (measured 4.4e-3).
"""

from __future__ import annotations

import contextlib
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import (
    IMAGE,
    JAX_DTYPES,
    SMOKE_DENOISER,
    SMOKE_EMBEDDING,
    jax_attention,
    rel_l2,
)
from tinyedm_tpu.data.datamodules import SyntheticDataModule as JaxSynthetic
from tinyedm_tpu.diffusion.diffuser import Diffuser as JaxDiffuser
from tinyedm_tpu.diffusion.loss import edm_training_loss as jax_training_loss
from tinyedm_tpu.models.edm import EDM as JaxEDM
from tinyedm_tpu.models.layers import Embedding as JaxEmbedding
from tinyedm_tpu.models.unet import Denoiser as JaxDenoiser
from tinyedm_tpu.ops.precond import edm_loss_weight as jax_loss_weight
from tinyedm_tpu.training import train_step as jts
from tinyedm_tpu.training.ema import EMAConfig as JaxEMAConfig
from tinyedm_tpu_torch.data.datamodules import SyntheticDataModule, to_device
from tinyedm_tpu_torch.diffusion.diffuser import Diffuser
from tinyedm_tpu_torch.diffusion.loss import edm_training_loss
from tinyedm_tpu_torch.models.blocks import _Block
from tinyedm_tpu_torch.models.edm import EDM, init_weights
from tinyedm_tpu_torch.models.layers import Embedding
from tinyedm_tpu_torch.models.unet import Denoiser
from tinyedm_tpu_torch.ops.precond import edm_loss_weight
from tinyedm_tpu_torch.training.ema import EMAConfig
from tinyedm_tpu_torch.training.state import is_weight_normed
from tinyedm_tpu_torch.training.train_step import (
    OptimizerConfig,
    init_train_state,
    make_grad_fn,
    make_train_step,
)
from tinyedm_tpu_torch.utils.interop import from_jax_variables, train_state_from_jax

SCHED_COUNT = 10  # past the rampup of 2 and the steady 2: the decay branch
OPT = dict(lr=0.01, rampup_steps=2, steady_steps=2)
FP32_OPTIONS = dict(accum_steps=2, grad_clip_norm=1.0, log_norms=True)
SIGMA_RELS = (0.13, 0.05)


def _draws(b: int):
    """(eps (b,), noise NHWC) for the injected diffusers: the first b rows of
    one fixed draw, so that a microbatch takes the same rows on both sides."""
    rng = np.random.default_rng(0)
    eps = rng.standard_normal((IMAGE[0],)).astype(np.float32)
    return eps[:b], rng.standard_normal(IMAGE).astype(np.float32)[:b]


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


def _jax_model(dtype):
    return JaxEDM(
        embedding=JaxEmbedding(**SMOKE_EMBEDDING, num_classes=10),
        denoiser=JaxDenoiser(**SMOKE_DENOISER, dtype=JAX_DTYPES[dtype]),
    )


def _port_model(dtype):
    return EDM(Embedding(**SMOKE_EMBEDDING, num_classes=10), Denoiser(**SMOKE_DENOISER, dtype=dtype))


def _batches():
    return list(JaxSynthetic(IMAGE[0], image_size=IMAGE[1], num_samples=3 * IMAGE[0], seed=5)
                .train_batches(0))


@functools.lru_cache(maxsize=None)
def _jax_start(dtype, opt_items):
    """The JAX start state (numpy leaves), gain_out set to 1."""
    jmodel = _jax_model(dtype)
    state = jts.init_train_state(
        jax.random.PRNGKey(0), jmodel, jnp.zeros(IMAGE), jts.OptimizerConfig(**dict(opt_items)),
        JaxEMAConfig(SIGMA_RELS), jnp.zeros((IMAGE[0],), jnp.int32),
    )
    params = jax.tree_util.tree_map(lambda x: x, state.params)
    params = {**params, "denoiser": {**params["denoiser"], "gain_out": jnp.float32(1.0)}}
    state = state.replace(params=params, ema=tuple(params for _ in SIGMA_RELS))
    return jax.tree_util.tree_map(np.asarray, state)


def _port_state(dtype, start):
    model = _port_model(dtype)
    return model, train_state_from_jax(start, model)


def _compare_trees(port: dict, ref: dict, bound: float, what: str) -> float:
    worst = 0.0
    assert set(port) == set(ref), what
    for k in ref:
        a, b = port[k].detach().double().numpy(), ref[k].double().numpy()
        err = rel_l2(a, b) if np.linalg.norm(b) > 0 else float(np.abs(a).max())
        assert err <= bound, (what, k, err)
        worst = max(worst, err)
    return worst


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_three_steps_match_jax(dtype):
    fp32 = dtype == torch.float32
    opt_items = tuple(sorted({**OPT, **(FP32_OPTIONS if fp32 else {})}.items()))
    start = _jax_start(dtype, opt_items)
    batches = _batches()

    jmodel = _jax_model(dtype)
    jstep = jax.jit(jts.make_train_step(
        jmodel, _JaxInjected(), jts.OptimizerConfig(**dict(opt_items)), JaxEMAConfig(SIGMA_RELS)
    ))
    jstate = jax.tree_util.tree_map(jnp.asarray, start)
    jmetrics = []
    for images, labels in batches:
        jstate, m = jstep(jstate, (jnp.asarray(images), jnp.asarray(labels)),
                          jax.random.PRNGKey(1), SCHED_COUNT)
        jmetrics.append({k: float(v) for k, v in m.items()})
    ref = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate))

    opt_cfg = OptimizerConfig(**dict(opt_items))
    model, state = _port_state(dtype, start)
    step = make_train_step(model, _Injected(), opt_cfg, EMAConfig(SIGMA_RELS))
    for (images, labels), jm in zip(batches, jmetrics):
        state, m = step(state, to_device(images, labels, "cpu"), None, SCHED_COUNT)
        assert set(m) == set(jm)
        for k, v in m.items():
            assert abs(float(v) - jm[k]) <= (1e-4 if fp32 else 1e-2) * abs(jm[k]) + 1e-7, (k, float(v), jm[k])

    assert (state.step, state.count) == (ref.step, ref.count) == (3, 3)
    bound = 2e-5 if fp32 else 1e-2
    _compare_trees(state.params, ref.params, bound, "params")
    _compare_trees(state.mu, ref.mu, 2e-5 if fp32 else 1e-1, "mu")
    _compare_trees(state.nu, ref.nu, 2e-5 if fp32 else 1e-1, "nu")
    for tree, rtree in zip(state.ema, ref.ema):
        _compare_trees(tree, rtree, bound, "ema")


def _jax_grads(dtype, start, images, labels, fused):
    jmodel = _jax_model(dtype)

    def loss_fn(params):
        noisy, sigma = _JaxInjected()(None, jnp.asarray(images))
        denoised, u = jmodel.apply(
            {"params": params, "constants": start.constants}, noisy, sigma, jnp.asarray(labels),
            train=True, method=JaxEDM.denoise_with_aux,
        )
        return jax_training_loss(jax_loss_weight(sigma, jmodel.sigma_data), denoised,
                                 jnp.asarray(images), u)[0]

    with jax_attention(fused):
        grads = jax.jit(jax.grad(loss_fn))(jax.tree_util.tree_map(jnp.asarray, start.params))
    return from_jax_variables({"params": jax.tree_util.tree_map(np.asarray, grads)})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_step_gradients_match_jax_attention_on_and_off(dtype):
    opt_items = tuple(sorted(OPT.items()))
    start = _jax_start(dtype, opt_items)
    images, labels = _batches()[0]
    opt_cfg = OptimizerConfig(**OPT)
    model, state = _port_state(dtype, start)
    _, _, grads = make_grad_fn(model, _Injected(), opt_cfg)(
        state, *to_device(images, labels, "cpu"), None
    )
    port = dict(zip(state.params, grads))
    flat = np.concatenate([g.double().numpy().ravel() for g in grads])
    for fused in ("off", "on"):
        ref = _jax_grads(dtype, start, images, labels, fused)
        rflat = np.concatenate([ref[k].double().numpy().ravel() for k in port])
        assert rel_l2(flat, rflat) <= (2e-5 if dtype == torch.float32 else 2e-2), fused


def _small_model(seed=0, dropout_rate=0.0):
    """The smoke model in bf16 with seeded weights and gain_out = 1."""
    model = EDM(Embedding(**SMOKE_EMBEDDING, num_classes=10),
                Denoiser(**{**SMOKE_DENOISER, "dropout_rate": dropout_rate}, dtype=torch.bfloat16))
    init_weights(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.denoiser.gain_out.fill_(1.0)
    return model


def _recompute_islands():
    """``experiments/torch_profile_train.py``'s recomputed-island variant."""
    path = Path(__file__).resolve().parent.parent / "experiments" / "torch_profile_train.py"
    spec = importlib.util.spec_from_file_location("torch_profile_train", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.recompute_islands()


def test_island_recompute_gives_same_numbers():
    """The profiler's recomputed fp32 island (``torch.utils.checkpoint``)
    and the saved one the model runs: same loss and gradients bit for bit,
    with dropout on (the bits are drawn outside the recomputed region)."""
    images, labels = next(SyntheticDataModule(4, image_size=16, num_samples=4).train_batches(0))
    batch = to_device(images, labels, "cpu")
    results = []
    for recompute in (True, False):
        model = _small_model(dropout_rate=0.1)
        state = init_train_state(model, OptimizerConfig())
        with _recompute_islands() if recompute else contextlib.nullcontext():
            loss, _, grads = make_grad_fn(model, Diffuser(), OptimizerConfig())(
                state, *batch, torch.Generator().manual_seed(7)
            )
        results.append((loss, grads))
    assert _Block._island.__name__ == "_island"  # the variant is undone on exit
    assert torch.equal(results[0][0], results[1][0])
    assert all(torch.equal(a, b) for a, b in zip(results[0][1], results[1][1]))


def _shared_bits(nhwc_shape) -> np.ndarray:
    """16-bit dropout numbers that depend on the NHWC shape only: both
    packages' blocks of one shape get the same mask."""
    return np.random.default_rng(list(nhwc_shape)).integers(0, 65536, size=nhwc_shape, dtype=np.uint16)


def test_train_forward_with_dropout_matches_jax(monkeypatch):
    """The smoke model at dropout 0.1 in training, fp32, with the same
    dropout bits fed to both packages' blocks: the denoised output within
    2e-5 relative L2 and the loss gradients within 2e-5 (the no-dropout
    parity's bounds; measured 2.4e-7 and 4.7e-7), so the mask, the exact
    survivor scale and its place in the fp32 island agree with the JAX
    package."""
    from tinyedm_tpu.ops import dropout as jdrop
    from tinyedm_tpu_torch.models import blocks

    rate = 0.1
    monkeypatch.setattr(jdrop, "dropout_bits", lambda rng, shape: jnp.asarray(_shared_bits(shape)))
    monkeypatch.setattr(blocks, "dropout_bits", lambda shape, generator, device: torch.from_numpy(
        _shared_bits((shape[0], shape[2], shape[3], shape[1])).astype(np.int32)).permute(0, 3, 1, 2))
    start = _jax_start(torch.float32, tuple(sorted(OPT.items())))
    images, labels = _batches()[0]
    jmodel = JaxEDM(embedding=JaxEmbedding(**SMOKE_EMBEDDING, num_classes=10),
                    denoiser=JaxDenoiser(**SMOKE_DENOISER, dropout_rate=rate, dtype=jnp.float32))
    noisy, sigma = _JaxInjected()(None, jnp.asarray(images))

    def jax_loss(params):
        denoised, u = jmodel.apply(
            {"params": params, "constants": start.constants}, noisy, sigma, jnp.asarray(labels),
            train=True, method=JaxEDM.denoise_with_aux, rngs={"dropout": jax.random.PRNGKey(2)},
        )
        loss = jax_training_loss(jax_loss_weight(sigma, jmodel.sigma_data), denoised,
                                 jnp.asarray(images), u)[0]
        return loss, denoised

    (_, ref), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, start.params))
    jgrads = from_jax_variables({"params": jax.tree_util.tree_map(np.asarray, jgrads)})

    model = EDM(Embedding(**SMOKE_EMBEDDING, num_classes=10),
                Denoiser(**SMOKE_DENOISER, dropout_rate=rate, dtype=torch.float32))
    state = train_state_from_jax(start, model)
    x, y = to_device(images, labels, "cpu")
    noisy_t, sigma_t = _Injected()(x, None)
    denoised, u = model.denoise_with_aux(noisy_t, sigma_t, y, train=True, generator=torch.Generator())
    loss, _ = edm_training_loss(edm_loss_weight(sigma_t, model.sigma_data), denoised, x, u)
    grads = torch.autograd.grad(loss, list(state.params.values()))
    out_err = rel_l2(denoised.detach().permute(0, 2, 3, 1).double().numpy(), np.asarray(ref, np.float64))
    flat = np.concatenate([g.double().numpy().ravel() for g in grads])
    grad_err = rel_l2(flat, np.concatenate([jgrads[k].double().numpy().ravel() for k in state.params]))
    assert out_err <= 2e-5 and grad_err <= 2e-5


def test_step_invariants_and_dropout_draws():
    """After step 0 the EMA equals the params (decay 0), every WN weight has
    unit per-output RMS, and the generator decides the dropout masks."""
    images, labels = next(SyntheticDataModule(4, image_size=16, num_samples=4).train_batches(0))
    batch = to_device(images, labels, "cpu")
    losses = []
    for seed in (1, 1, 2):
        model = _small_model(dropout_rate=0.1)
        opt_cfg, ema_cfg = OptimizerConfig(lr=0.01), EMAConfig()
        state = init_train_state(model, opt_cfg, ema_cfg)
        state, m = make_train_step(model, Diffuser(), opt_cfg, ema_cfg)(
            state, batch, torch.Generator().manual_seed(seed), 0
        )
        losses.append(float(m["train_loss"]))
        assert state.step == 1 and np.isfinite(losses[-1])
        assert all(torch.equal(state.ema[0][k], p) for k, p in state.params.items())
        for k, p in state.params.items():
            if is_weight_normed(k, p):
                rms = p.detach().reshape(p.shape[0], -1).pow(2).mean(dim=1).sqrt()
                assert torch.allclose(rms, torch.ones_like(rms), atol=1e-3), k
    assert losses[0] == losses[1] != losses[2]


def test_unported_options_raise():
    model = _small_model()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_step(model, Diffuser(), OptimizerConfig(label_dropout=0.1))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_step(model, Diffuser(), OptimizerConfig(log_norms_per_layer=True))
