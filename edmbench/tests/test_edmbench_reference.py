"""The plain reference held against the port, at the smoke configuration in
fp32 on the CPU, with every gain drawn nonzero: the forward, one training
step, a short Heun solve and the uint8 mapping. The test imports both; the
reference imports nothing of the port."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from edmbench.harness import port_model, train_gaps
from edmbench.reference.heun import heun, to_uint8
from edmbench.reference.model import denoise, draw_weights
from edmbench.reference.train import Readings, train
from edmbench.tests.conftest import SMOKE

from tinyedm_tpu_torch.diffusion.diffuser import Diffuser
from tinyedm_tpu_torch.diffusion.solver import DeterministicSolver
from tinyedm_tpu_torch.generate import device_denormalize_uint8
from tinyedm_tpu_torch.training.ema import EMAConfig
from tinyedm_tpu_torch.training.train_step import OptimizerConfig, init_train_state, make_train_step

CFG32 = {**SMOKE, "denoiser": {**SMOKE["denoiser"], "dtype": "float32"}}


@pytest.fixture(scope="module")
def weights():
    return draw_weights(CFG32, 1234, "cpu")


def test_gains_drawn_nonzero(weights):
    gains = [v for k, v in weights.items() if k.endswith("gain") or k.endswith("gain_out")]
    assert gains and all(0.5 <= float(g) <= 1.5 for g in gains)


def test_forward_matches_port(weights):
    model = port_model(CFG32, "cpu", weights)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((4, 3, 16, 16), generator=g)
    sigma = torch.exp(torch.randn(4, generator=g))
    labels = torch.randint(0, 10, (4,), generator=g)
    with torch.no_grad():
        want, u_want = model.denoise_with_aux(x, sigma, labels)
        got, u_got = denoise(weights, CFG32, x, sigma, labels)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(u_got, u_want, rtol=1e-5, atol=1e-5)
    # the network reaches the output: not c_skip * x alone
    assert float((want - x * 0.25 / (sigma.reshape(-1, 1, 1, 1) ** 2 + 0.25)).abs().max()) > 1e-2


def test_train_step_matches_port(weights):
    t = CFG32["training"]
    model = port_model(CFG32, "cpu", weights)
    opt = OptimizerConfig(lr=t["lr"], betas=tuple(t["betas"]), eps=t["eps"], rampup_steps=t["rampup_steps"],
                          steady_steps=t["steady_steps"], scheduler_interval="step", accum_steps=t["accum_steps"])
    ema = EMAConfig(sigma_rels=tuple(t["ema_lengths"]))
    state = init_train_state(model, opt, ema)
    p0 = {k: v.detach().clone() for k, v in state.params.items()}
    step = make_train_step(model, Diffuser(**t["diffuser"]), opt, ema)
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.standard_normal((8, 3, 16, 16), dtype=np.float32) * 0.5)
    labels = torch.from_numpy(rng.integers(0, 10, 8))
    _, metrics = step(state, (images, labels), torch.Generator().manual_seed(77), t["full_lr_count"])
    prog = Readings(
        [float(metrics["sse"])],
        {k: float(torch.linalg.vector_norm(v)) / (1 - t["betas"][0]) for k, v in state.mu.items()},
        {k: float(torch.linalg.vector_norm(v.detach() - p0[k])) for k, v in state.params.items()},
        [{k: float(torch.linalg.vector_norm(v - p0[k])) for k, v in e.items()} for e in state.ema])
    ref = train(CFG32, weights, [(images, labels)], [77], 1)
    gaps = train_gaps(prog, ref)
    assert gaps["loss_gap"] < 1e-5
    assert gaps["grad_gap"] < 1e-4
    assert gaps["change_gap"] < 1e-4
    assert gaps["ema_gap"] < 1e-4


def test_heun_and_uint8_match_port(weights):
    model = port_model(CFG32, "cpu", weights)
    g = torch.Generator().manual_seed(3)
    noise = torch.randn((3, 3, 16, 16), generator=g)
    labels = torch.randint(0, 10, (3,), generator=g)
    with torch.inference_mode():
        want = DeterministicSolver(num_steps=4).solve(model, noise, labels)
    got = heun(weights, CFG32, noise, labels, 4)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    mean, std = SMOKE["sampling"]["mean"], SMOKE["sampling"]["std"]
    assert torch.equal(to_uint8(want, mean, std), device_denormalize_uint8(want, mean, std))
