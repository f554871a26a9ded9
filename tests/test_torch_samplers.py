"""The port's DPM-Solver++(2M) and churn (stochastic Heun) samplers against
the JAX package's ``MultistepSolver`` and ``StochasticSolver``.

Both sides start from the same numpy noise. Closed-form denoisers (a
constant target, zero, a linear map) agree within 1e-6 relative L2 in fp32
(float rounding only); the smoke model, fp32, within 1e-5 (its forwards
differ by about 1e-6 between the frameworks); a bf16 solver dtype within
1e-2. Churn noise cannot match bit for bit (threefry against Philox), so the
churn cases feed JAX's own draws (``jax.random.split(rng, half_steps)``, one
normal per prediction half-step) into the port's ``churn_noise``. The rest
mirrors ``tests/test_diffusion_core.py``'s ``TestStochasticSolver``,
``TestMultistepSolver`` and ``TestSolverEdgeCases``.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import IMAGE, nhwc_to_torch, rel_l2, small_models, torch_to_nhwc
from tinyedm_tpu.diffusion.solver import MultistepSolver as JaxMultistep
from tinyedm_tpu.diffusion.solver import StochasticSolver as JaxStochastic
from tinyedm_tpu_torch.diffusion import solver as solver_mod
from tinyedm_tpu_torch.diffusion.solver import (
    DeterministicSolver,
    MultistepSolver,
    StochasticSolver,
    karras_sigma_schedule,
)

CHURN = dict(S_churn=40.0, S_min=0.05, S_max=50.0, S_noise=1.003)  # EDM's ImageNet-64 settings


def _noise(seed=0, shape=IMAGE):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _closeness(out: np.ndarray, ref: np.ndarray) -> float:
    """Relative L2, or the largest difference where the reference is 0."""
    if np.linalg.norm(ref) == 0.0:
        return float(np.abs(out).max())
    return rel_l2(out, ref)


def _constant(xp):
    return lambda x, s, _: xp.full_like(x, 0.7)


def _zero(xp):
    return lambda x, s, _: xp.zeros_like(x)


def _linear(xp):
    # in fp32 on both sides: a bf16 x times 0.9 rounds 0.9 to bf16 in JAX
    # and not in torch
    if xp is jnp:
        return lambda x, s, _: x.astype(jnp.float32) * 0.9 / (1.0 + s.reshape(-1, 1, 1, 1))
    return lambda x, s, _: x.float() * 0.9 / (1.0 + s.reshape(-1, 1, 1, 1))


DENOISERS = {"constant": _constant, "zero": _zero, "linear": _linear}


@pytest.mark.parametrize("num_steps", [1, 2, 18, 32])
@pytest.mark.parametrize("denoiser", sorted(DENOISERS))
def test_multistep_closed_form_matches_jax(denoiser, num_steps):
    x0 = _noise()
    ref = np.asarray(JaxMultistep(num_steps=num_steps).solve(DENOISERS[denoiser](jnp), jnp.asarray(x0)))
    out = MultistepSolver(num_steps=num_steps).solve(DENOISERS[denoiser](torch), nhwc_to_torch(x0))
    assert out.dtype == torch.float32
    assert _closeness(torch_to_nhwc(out), ref) <= 1e-6


def _jax_model_fn(jmodel, variables):
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    return lambda x, s, l: jmodel.apply(jvars, x, s, l)


@pytest.mark.parametrize("dtype,bound", [(None, 1e-5), ("bfloat16", 1e-2)])
def test_multistep_smoke_model_matches_jax(dtype, bound):
    jmodel, variables, port = small_models(10, torch.float32)
    x0, labels = _noise(1), np.asarray([2, 9], np.int32)
    fn = _jax_model_fn(jmodel, variables)
    ref = jax.jit(lambda x, lab: JaxMultistep(num_steps=18, dtype=dtype).solve(fn, x, lab))(
        jnp.asarray(x0), jnp.asarray(labels))
    with torch.no_grad():
        out = MultistepSolver(num_steps=18, dtype=dtype).solve(
            port, nhwc_to_torch(x0), torch.from_numpy(labels).long())
    out = torch_to_nhwc(out)
    assert np.isfinite(out).all()
    assert rel_l2(out, np.asarray(ref, np.float32)) <= bound


def test_multistep_bf16_closed_form_matches_jax():
    x0 = _noise(2)
    ref = JaxMultistep(num_steps=18, dtype="bfloat16").solve(_linear(jnp), jnp.asarray(x0))
    out = MultistepSolver(num_steps=18, dtype="bfloat16").solve(_linear(torch), nhwc_to_torch(x0))
    assert out.dtype == torch.bfloat16
    assert rel_l2(torch_to_nhwc(out), np.asarray(ref, np.float32)) <= 1e-2


def _jax_churn_draws(rng, solver: JaxStochastic, shape, dtype=jnp.float32) -> list[np.ndarray]:
    """The normals the JAX solver adds on its prediction half-steps (every
    other one of its 2n - 1 half-step keys), as NHWC numpy arrays."""
    keys = jax.random.split(rng, 2 * solver.num_steps - 1)
    return [np.asarray(jax.random.normal(keys[2 * i], shape, dtype), np.float32)
            for i in range(solver.num_steps)]


@pytest.fixture
def fed_churn(monkeypatch):
    """feed(draws): the port's churn_noise returns these NHWC draws in turn."""
    def feed(draws):
        queue = list(draws)

        def churn_noise(shape, dtype, generator, device):
            eps = nhwc_to_torch(queue.pop(0)).to(dtype)
            assert eps.shape == shape
            return eps

        monkeypatch.setattr(solver_mod, "churn_noise", churn_noise)
        return queue

    return feed


@pytest.mark.parametrize("denoiser", ["linear", "model"])
def test_churn_with_jax_draws_matches_jax(denoiser, fed_churn):
    x0, labels = _noise(3), np.asarray([4, 1], np.int32)
    if denoiser == "model":
        jmodel, variables, port = small_models(10, torch.float32)
        jfn, pfn = _jax_model_fn(jmodel, variables), port
    else:
        jfn, pfn = _linear(jnp), _linear(torch)
    jsolver = JaxStochastic(num_steps=6, **CHURN)
    rng = jax.random.PRNGKey(5)
    ref = jax.jit(lambda x, lab: jsolver.solve(jfn, x, lab, rng=rng))(jnp.asarray(x0), jnp.asarray(labels))
    queue = fed_churn(_jax_churn_draws(rng, jsolver, IMAGE))
    with torch.no_grad():
        out = StochasticSolver(num_steps=6, **CHURN).solve(
            pfn, nhwc_to_torch(x0), torch.from_numpy(labels).long(), generator=torch.Generator())
    assert not queue  # one draw per step
    assert rel_l2(torch_to_nhwc(out), np.asarray(ref)) <= 1e-5


def test_zero_churn_equals_heun_and_jax():
    jmodel, variables, port = small_models(10, torch.float32)
    x0, labels = _noise(4), np.asarray([0, 7], np.int32)
    ref = jax.jit(lambda x, lab: JaxStochastic(num_steps=5).solve(
        _jax_model_fn(jmodel, variables), x, lab))(jnp.asarray(x0), jnp.asarray(labels))
    lab = torch.from_numpy(labels).long()
    with torch.no_grad():
        heun = DeterministicSolver(num_steps=5).solve(port, nhwc_to_torch(x0), lab)
        out = StochasticSolver(num_steps=5).solve(port, nhwc_to_torch(x0), lab)
    assert torch.equal(out, heun)
    assert rel_l2(torch_to_nhwc(out), np.asarray(ref)) <= 1e-5


class TestStochasticSolver:
    def test_zero_churn_equals_deterministic(self):
        x0 = nhwc_to_torch(_noise(3, (2, 4, 4, 3)))
        det = DeterministicSolver(num_steps=6).solve(_linear(torch), x0)
        sto = StochasticSolver(num_steps=6, S_churn=0.0).solve(_linear(torch), x0,
                                                              generator=torch.Generator().manual_seed(0))
        assert torch.equal(sto, det)

    def test_churn_converges_for_point_mass(self):
        solver = StochasticSolver(num_steps=18, S_churn=10.0, S_min=0.05, S_max=50.0)
        out = solver.solve(_constant(torch), nhwc_to_torch(_noise(0, (4, 2, 2, 1))),
                           generator=torch.Generator().manual_seed(1))
        np.testing.assert_allclose(out.numpy(), 0.7, atol=1e-3)

    def test_churn_randomness_controlled_by_generator(self):
        solver = StochasticSolver(num_steps=6, S_churn=5.0)
        x0 = nhwc_to_torch(_noise(0, (2, 4, 4, 1)))
        a, b, c = (solver.solve(_linear(torch), x0, generator=torch.Generator().manual_seed(s))
                   for s in (1, 1, 2))
        assert torch.equal(a, b)
        assert not torch.allclose(a, c)

    def test_gamma_capped(self):
        solver = StochasticSolver(num_steps=4, S_churn=1000.0)
        assert solver.gamma == math.sqrt(2.0) - 1.0
        assert StochasticSolver(num_steps=40, S_churn=4.0).gamma == 0.1
        t = solver.t_steps
        t_hat, churn = solver.tables()
        np.testing.assert_allclose(t_hat, t[:-1] * math.sqrt(2.0), rtol=1e-15)
        np.testing.assert_allclose(churn, t[:-1], rtol=1e-12)  # sqrt(2 t^2 - t^2)
        # outside [S_min, S_max] the step takes no churn
        t_hat, churn = StochasticSolver(num_steps=4, **CHURN).tables()
        assert t_hat[0] == t[0] == 80.0 and churn[0] == 0.0


class TestMultistepSolver:
    def test_constant_target_exact_per_step(self):
        out = MultistepSolver(num_steps=6).solve(_constant(torch), nhwc_to_torch(_noise(0, (4, 2, 2, 1))))
        np.testing.assert_allclose(out.numpy(), 0.7, atol=1e-5)

    def test_zero_denoiser_contracts_to_zero(self):
        out = MultistepSolver(num_steps=8, sigma_min=0.01, sigma_max=10.0).solve(
            _zero(torch), torch.ones((2, 1, 4, 4)))
        assert torch.equal(out, torch.zeros_like(out))  # the last step is x = D exactly

    def test_one_forward_per_step(self):
        calls = []

        def denoise_fn(x, sigma, labels):
            calls.append(float(sigma[0]))
            return torch.zeros_like(x)

        solver = MultistepSolver(num_steps=5)
        solver.solve(denoise_fn, torch.ones((1, 1, 2, 2)))
        expected = [float(np.float32(s)) for s in solver.t_steps[:-1]]
        assert calls == expected  # n forwards, Heun's 2n - 1

    def test_matches_python_loop_reference(self):
        """Against an fp64 Python loop of the published 2M recurrence."""
        solver = MultistepSolver(num_steps=6)
        x0 = nhwc_to_torch(_noise(3, (2, 4, 4, 3)))
        out = solver.solve(_linear(torch), x0).double().numpy()
        t = solver.t_steps
        x = x0.double().numpy() * t[0]
        d_prev = h_prev = None
        for i in range(solver.num_steps):
            s_cur, s_next = t[i], t[i + 1]
            d = x * 0.9 / (1.0 + s_cur)
            if s_next == 0.0:
                x = d
            else:
                h = np.log(s_cur) - np.log(s_next)
                d_hat = d if d_prev is None else (
                    (1.0 + 1.0 / (2.0 * h_prev / h)) * d - (1.0 / (2.0 * h_prev / h)) * d_prev)
                x = (s_next / s_cur) * x + (-np.expm1(-h)) * d_hat
                h_prev = h
            d_prev = d
        np.testing.assert_allclose(out, x, rtol=1e-4, atol=1e-6)

    def test_second_order_convergence(self):
        """Against 256-step Heun on a smooth nonlinear denoiser: halving the
        step cuts the error about 4x, and 32 steps sit close to the truth."""
        def denoise_fn(x, sigma, labels):
            return torch.tanh(x) * (1.0 / (1.0 + 0.3 * sigma.reshape(-1, 1, 1, 1)))

        x0 = nhwc_to_torch(_noise(5, (2, 4, 4, 1)))
        truth = DeterministicSolver(num_steps=256).solve(denoise_fn, x0)

        def err(n):
            return float((MultistepSolver(num_steps=n).solve(denoise_fn, x0) - truth).abs().max())

        e8, e16, e32 = err(8), err(16), err(32)
        assert e8 > 2.5 * e16 > 0, (e8, e16)
        assert e16 > 2.5 * e32 > 0, (e16, e32)
        assert e32 < 2e-3, e32


class TestSolverEdgeCases:
    def test_single_step_schedule_is_finite(self):
        np.testing.assert_array_equal(karras_sigma_schedule(1, 0.002, 80.0, 7.0), [80.0, 0.0])
        x0 = nhwc_to_torch(_noise(0, (2, 8, 8, 1)))
        for solver in (DeterministicSolver(num_steps=1), MultistepSolver(num_steps=1),
                       StochasticSolver(num_steps=1, S_churn=5.0)):
            out = solver.solve(lambda x, s, l: x * 0.5, x0, None,
                               **({"generator": torch.Generator()} if isinstance(solver, StochasticSolver) else {}))
            assert torch.isfinite(out).all()
        with pytest.raises(ValueError, match="num_steps"):
            karras_sigma_schedule(0, 0.002, 80.0, 7.0)

    def test_stochastic_solver_requires_generator_when_churning(self):
        x0 = nhwc_to_torch(_noise(1, (2, 8, 8, 1)))
        den = lambda x, s, l: x * 0.9  # noqa: E731
        with pytest.raises(ValueError, match="generator"):
            StochasticSolver(num_steps=3, S_churn=5.0).solve(den, x0, None)
        assert torch.isfinite(StochasticSolver(num_steps=3).solve(den, x0, None)).all()
        a, b = (StochasticSolver(num_steps=3, S_churn=5.0).solve(den, x0, None,
                                                                 generator=torch.Generator().manual_seed(s))
                for s in (2, 3))
        assert not torch.allclose(a, b)

    def test_solver_dtypes(self):
        for cls in (MultistepSolver, StochasticSolver):
            assert cls(dtype="bfloat16").torch_dtype == torch.bfloat16
            assert cls().torch_dtype == torch.float32
            with pytest.raises(ValueError):
                cls(dtype="int8").torch_dtype
