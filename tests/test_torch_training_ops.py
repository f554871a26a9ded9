"""The port's training pieces against the JAX package's, on the same numpy
inputs: pixel_norm's VJP, dropout on shared bits, the diffuser on injected
draws, the loss and its weight, the LR schedule, the EMA, the forced weight
norm, the synthetic data module and the training recipe's constants.

Tolerances: fp32 within 1e-6 relative (summation order and the last bits of
sqrt/exp/pow); bf16 within one bf16 ulp; integer and uint8-derived values
(thresholds, masks, batches) exactly.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_ops import DTYPES, _assert_close, _pair
from tinyedm_tpu.config.registry import load_config
from tinyedm_tpu.data.datamodules import SyntheticDataModule as JaxSynthetic
from tinyedm_tpu.diffusion import loss as jloss
from tinyedm_tpu.diffusion.diffuser import Diffuser as JaxDiffuser
from tinyedm_tpu.ops import dropout as jdrop
from tinyedm_tpu.ops import mp as jmp
from tinyedm_tpu.training import ema as jema
from tinyedm_tpu.training.lr_schedule import edm_lr_multiplier as jax_lr_multiplier
from tinyedm_tpu.training.state import force_weight_norm as jax_force_weight_norm
from tinyedm_tpu_torch.configs import CIFAR10_TRAINING, build_training
from tinyedm_tpu_torch.data.datamodules import SyntheticDataModule, to_device
from tinyedm_tpu_torch.diffusion import loss
from tinyedm_tpu_torch.diffusion.diffuser import Diffuser
from tinyedm_tpu_torch.ops import dropout, mp
from tinyedm_tpu_torch.training import ema
from tinyedm_tpu_torch.training.lr_schedule import edm_lr_multiplier, make_lr_fn
from tinyedm_tpu_torch.training.state import force_weight_norm

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("tdtype,jdtype", DTYPES)
@pytest.mark.parametrize("shape,dim", [((64, 48), -1), ((4, 8, 8, 32), 1), ((6, 3, 3, 5), (1, 2, 3))])
def test_pixel_norm_vjp(tdtype, jdtype, shape, dim):
    x, jx = _pair(shape, tdtype, jdtype, seed=4)
    g, jg = _pair(shape, tdtype, jdtype, seed=5, scale=1.0)
    x.requires_grad_(True)
    (dx,) = torch.autograd.grad(mp.pixel_norm(x, dim=dim), x, g)
    ref = jax.vjp(lambda v: jmp.pixel_norm(v, axis=dim), jx)[1](jg)[0]
    assert dx.dtype == tdtype
    _assert_close(dx, ref, tdtype)


def test_pixel_norm_gradcheck_fp64():
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((3, 4, 5)))
    x.requires_grad_(True)
    assert torch.autograd.gradcheck(lambda v: mp.pixel_norm(v, dim=(1, 2)), (x,))


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.13])
def test_dropout_threshold(rate):
    assert dropout.dropout_threshold(rate) == jdrop.dropout_threshold(rate)


@pytest.mark.parametrize("tdtype,jdtype", DTYPES)
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.13])
def test_dropout_on_shared_bits(tdtype, jdtype, rate):
    """The same uint16 bits give the same result, exactly."""
    x, jx = _pair((8, 300), tdtype, jdtype, seed=7)
    bits = np.random.default_rng(8).integers(0, 65536, size=(8, 300), dtype=np.uint16)
    out = dropout.apply_dropout_bits(torch.from_numpy(bits.astype(np.int32)), x, rate)
    ref = jdrop.apply_dropout_bits(jnp.asarray(bits), jx, rate)
    assert out.dtype == tdtype
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_dropout_bits_range_and_rate():
    g = torch.Generator().manual_seed(0)
    bits = dropout.dropout_bits((200, 500), g, torch.device("cpu"))
    assert bits.dtype == torch.int32 and int(bits.min()) >= 0 and int(bits.max()) < 65536
    kept = float((dropout.apply_dropout_bits(bits, torch.ones(200, 500), 0.13) != 0).float().mean())
    assert abs(kept - 0.87) < 0.005


def test_diffuser_on_injected_draws():
    rng = np.random.default_rng(9)
    clean = rng.standard_normal((3, 8, 8, 3)).astype(np.float32)
    eps = rng.standard_normal((3,)).astype(np.float32)
    noise = rng.standard_normal(clean.shape).astype(np.float32)

    class Injected(JaxDiffuser):
        def __call__(self, rng_, clean_image):
            sigma = jnp.exp(self.P_mean + jnp.asarray(eps) * self.P_std)
            return clean_image + jnp.asarray(noise) * sigma.reshape(-1, 1, 1, 1), sigma

    jnoisy, jsigma = Injected(-1.2, 1.2)(None, jnp.asarray(clean))
    t = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731
    noisy, sigma = Diffuser(-1.2, 1.2).apply(t(clean), torch.from_numpy(eps), t(noise))
    _assert_close(sigma, jsigma, torch.float32)
    _assert_close(noisy.permute(0, 2, 3, 1), jnoisy, torch.float32)
    # the port's own draws: shapes, types, and the log-normal law's first moments
    noisy, sigma = Diffuser(-1.2, 1.2)(torch.zeros((4000, 1, 2, 2)), torch.Generator().manual_seed(1))
    assert noisy.dtype == sigma.dtype == torch.float32 and sigma.shape == (4000,)
    assert abs(float(torch.log(sigma).mean()) + 1.2) < 0.06
    assert abs(float(torch.log(sigma).std()) - 1.2) < 0.06


@pytest.mark.parametrize("with_u", [False, True])
def test_edm_training_loss(with_u):
    rng = np.random.default_rng(10)
    w = rng.uniform(0.5, 30.0, (4,)).astype(np.float32)
    d = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    x = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    u = rng.standard_normal((4,)).astype(np.float32) if with_u else None
    t = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)  # noqa: E731
    out, metrics = loss.edm_training_loss(
        torch.from_numpy(w), t(d), t(x), None if u is None else torch.from_numpy(u)
    )
    ref, rmetrics = jloss.edm_training_loss(
        jnp.asarray(w), jnp.asarray(d), jnp.asarray(x), None if u is None else jnp.asarray(u)
    )
    _assert_close(out, ref, torch.float32)
    assert set(metrics) == set(rmetrics)
    for k in metrics:
        _assert_close(metrics[k], rmetrics[k], torch.float32)
    _assert_close(loss.weighted_mse(torch.from_numpy(w), t(d), t(x)),
                  jloss.weighted_mse(jnp.asarray(w), jnp.asarray(d), jnp.asarray(x)), torch.float32)
    m = loss.WeightedMeanSquaredError.create().update(torch.from_numpy(w), t(d), t(x))
    m = m.merge(m)
    jm = jloss.WeightedMeanSquaredError.create().update(jnp.asarray(w), jnp.asarray(d), jnp.asarray(x))
    jm = jm.merge(jm)
    _assert_close(m.compute(), jm.compute(), torch.float32)
    assert float(loss.WeightedMeanSquaredError.create().compute()) == 0.0


@pytest.mark.parametrize("rampup,steady", [(200, 200), (0, 1), (10, 50)])
def test_lr_multiplier(rampup, steady):
    """Rampup (1e-8 at count 0 with a rampup), steady and inverse-sqrt decay."""
    counts = np.asarray([0, 1, 5, 9, 10, 11, 60, 199, 200, 201, 399, 400, 401, 1000, 5000], np.float32)
    out = edm_lr_multiplier(torch.from_numpy(counts), rampup, steady)
    assert out.dtype == torch.float32
    _assert_close(out, jax_lr_multiplier(jnp.asarray(counts), rampup, steady), torch.float32)
    assert float(make_lr_fn(0.02, rampup, steady)(0)) == pytest.approx(
        0.02 * (1e-8 if rampup else 1.0), rel=1e-6
    )


@pytest.mark.parametrize("sigma_rel", [0.05, 0.1, 0.13, 0.2])
def test_ema_gamma_and_decay(sigma_rel):
    gamma = ema.sigma_rel_to_gamma(sigma_rel)
    assert gamma == jema.sigma_rel_to_gamma(sigma_rel)
    assert ema.gamma_to_sigma_rel(gamma) == pytest.approx(sigma_rel, rel=1e-9)
    for step in (0, 1, 7, 100, 12345):
        got = ema.power_ema_decay(step, gamma)
        assert got == pytest.approx(float(jema.power_ema_decay(step, gamma)), rel=1e-6, abs=0)
    assert ema.power_ema_decay(0, gamma) == 0.0
    with pytest.raises(ValueError):
        ema.sigma_rel_to_gamma(0.0)
    assert ema.EMAConfig((sigma_rel,)).gammas == jema.EMAConfig((sigma_rel,)).gammas


def test_ema_update_in_place():
    rng = np.random.default_rng(11)
    e = {"a": rng.standard_normal((5, 3)).astype(np.float32), "b": rng.standard_normal(()).astype(np.float32)}
    p = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in e.items()}
    te = {k: torch.from_numpy(v.copy()) for k, v in e.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    ema.maybe_ema_update(te, tp, 3, 6.94, every_n_steps=2)  # step 3: not a multiple of 2
    assert all(np.array_equal(te[k].numpy(), e[k]) for k in e)
    ema.maybe_ema_update(te, tp, 4, 6.94, every_n_steps=2)
    ref = jema.maybe_ema_update(e, p, jnp.asarray(4), 6.94, every_n_steps=2)
    for k in e:
        _assert_close(te[k], ref[k], torch.float32)


def test_force_weight_norm_only_touches_wn_weights():
    """WN layers' weights only: gains, gain_out and the Fourier buffers stay
    (the JAX rule: leaves named "w")."""
    model, *_ = build_training("cifar10", "cpu")
    params = {k: v.detach().clone() * 3.0 for k, v in model.named_parameters()}
    params["denoiser.gain_out"] = torch.tensor(0.7)
    before = {k: v.clone() for k, v in params.items()}
    force_weight_norm(params)
    n_wn = 0
    for k, v in params.items():
        if k.endswith(".weight"):
            n_wn += 1
            rms = v.reshape(v.shape[0], -1).pow(2).mean(dim=1).sqrt()
            assert torch.allclose(rms, torch.ones_like(rms), atol=1e-3), k
        else:
            assert torch.equal(v, before[k]), k
    assert n_wn > 50 and not any(k.endswith(("freqs", "phases")) for k in params)
    # against the JAX transform on one conv (OIHW here, HWIO there) and one linear
    for k in ("denoiser.conv_in.weight", "embedding.sigma_embed.weight"):
        w = before[k].numpy()
        jw = w.transpose(2, 3, 1, 0) if w.ndim == 4 else w
        ref = np.asarray(jax_force_weight_norm({"m": {"w": jnp.asarray(jw)}})["m"]["w"])
        ref = ref.transpose(3, 2, 0, 1) if w.ndim == 4 else ref
        np.testing.assert_allclose(params[k].numpy(), ref, rtol=1e-6, atol=1e-6)


def test_synthetic_batches_equal_jax():
    ours = SyntheticDataModule(16, image_size=8, num_samples=70, seed=3)
    theirs = JaxSynthetic(16, image_size=8, num_samples=70, seed=3)
    for epoch in (0, 1):
        a, b = list(ours.train_batches(epoch)), list(theirs.train_batches(epoch))
        assert len(a) == len(b) == 4
        for (xa, ya), (xb, yb) in zip(a, b):
            assert xa.dtype == np.float32 and np.array_equal(xa, xb) and np.array_equal(ya, yb)
    tail, jtail = (list(m.train_batches(0, drop_last=False, skip=2)) for m in (ours, theirs))
    assert len(tail) == len(jtail) == 3 and len(tail[-1][0]) == 70 - 64
    assert all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) for a, b in zip(tail, jtail))
    x, y = to_device(*a[0], "cpu")
    assert x.shape == (16, 3, 8, 8) and y.dtype == torch.int64
    assert torch.equal(x.permute(0, 2, 3, 1), torch.from_numpy(a[0][0]))


def test_training_recipe_equals_yaml():
    cfg = load_config(ROOT / "experiments" / "conf" / "cifar10.yaml")
    m = cfg["model"]
    expected = {
        "seed": cfg["seed"],
        "batch_size": cfg["datamodule"]["batch_size"],
        "accumulate_grad_batches": cfg["trainer"]["accumulate_grad_batches"],
        "diffuser": {k: v for k, v in m["diffuser"].items() if k != "_target_"},
        **{k: m[k] for k in ("use_uncertainty", "lr", "steady_steps", "rampup_steps",
                             "scheduler_interval", "use_ema", "ema_length", "every_n_steps")},
    }
    assert CIFAR10_TRAINING == expected
    model, diffuser, opt_cfg, ema_cfg, batch, interval = build_training("cifar10", "cpu")
    assert interval == "epoch"  # the caller ticks the schedule per epoch
    assert (diffuser.P_mean, diffuser.P_std, batch) == (-1.2, 1.2, 256)
    assert (opt_cfg.lr, opt_cfg.betas, opt_cfg.eps) == (0.02, (0.9, 0.999), 1e-8)
    assert ema_cfg.sigma_rels == (0.13,)
    assert all(b.dropout_rate == 0.13 for b in model.denoiser.encoder_blocks)


def test_uncertainty_net_matches_jax():
    """UncertaintyNet on the fp32 Fourier embedding, its JAX weights carried
    over under the EDM's ``u`` (gain set nonzero: it is made 0)."""
    from tinyedm_tpu.models.layers import UncertaintyNet as JaxUncertaintyNet
    from tinyedm_tpu_torch.models.layers import UncertaintyNet
    from tinyedm_tpu_torch.utils.interop import from_jax_variables

    x = np.random.default_rng(12).standard_normal((5, 16)).astype(np.float32)
    jnet = JaxUncertaintyNet(16)
    params = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"])
    params = {**params, "gain": np.float32(0.7)}
    net = UncertaintyNet(16, 16)
    sd = from_jax_variables({"params": {"u": params}})
    net.load_state_dict({k.removeprefix("u."): v for k, v in sd.items()})
    with torch.no_grad():
        out = net(torch.from_numpy(x))
    _assert_close(out, jnet.apply({"params": params}, jnp.asarray(x)), torch.float32)
