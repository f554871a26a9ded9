"""The port's Karras schedule and Heun solver against the JAX package's.

The solves start from the same numpy noise and run 4 steps (7 forwards) in
fp32; they agree within 1e-4 relative L2 (the fp32 model forwards differ by
about 1e-6 relative between the frameworks, and the closed-form denoiser by
float rounding only).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import IMAGE, nhwc_to_torch, rel_l2, small_models, torch_to_nhwc
from tinyedm_tpu.diffusion.solver import DeterministicSolver as JaxSolver
from tinyedm_tpu.diffusion.solver import karras_sigma_schedule as jax_schedule
from tinyedm_tpu_torch.diffusion.solver import DeterministicSolver, karras_sigma_schedule


@pytest.mark.parametrize("num_steps", [1, 2, 18, 32])
def test_karras_schedule_equals_jax(num_steps):
    port = karras_sigma_schedule(num_steps, 0.002, 80.0, 7.0)
    ref = jax_schedule(num_steps, 0.002, 80.0, 7.0)
    assert port.dtype == np.float64
    np.testing.assert_array_equal(port, ref)
    assert port[-1] == 0.0
    with pytest.raises(ValueError):
        karras_sigma_schedule(0, 0.002, 80.0, 7.0)


def _noise(seed=0):
    return np.random.default_rng(seed).standard_normal(IMAGE).astype(np.float32)


@pytest.mark.parametrize("num_steps", [1, 4])
def test_heun_closed_form_denoiser(num_steps):
    """D(x; sigma) = x * sd^2 / (sigma^2 + sd^2): the ideal denoiser of
    N(0, sd^2) data, the same formula on both sides. sigma_max is 2 here: from
    80 the solve ends in x - (x - D) with D ~ 4e-5 x, a cancellation that
    leaves only the fp32 rounding of x (either side may fuse a multiply-add)."""
    sd = 0.5

    def jax_d(x, sigma, _):
        s = sigma.reshape(-1, 1, 1, 1)
        return x * (sd**2 / (s**2 + sd**2))

    def port_d(x, sigma, _):
        s = sigma.reshape(-1, 1, 1, 1)
        return x * (sd**2 / (s**2 + sd**2))

    x0 = _noise()
    ref = np.asarray(JaxSolver(num_steps=num_steps, sigma_max=2.0).solve(jax_d, jnp.asarray(x0)))
    out = DeterministicSolver(num_steps=num_steps, sigma_max=2.0).solve(port_d, nhwc_to_torch(x0))
    assert out.dtype == torch.float32
    assert rel_l2(torch_to_nhwc(out), ref) <= 1e-4


def test_heun_small_model():
    jmodel, variables, port = small_models(10, torch.float32)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    x0 = _noise(1)
    labels = np.asarray([2, 9], np.int32)

    ref = jax.jit(
        lambda x, lab: JaxSolver(num_steps=4).solve(
            lambda x, s, l: jmodel.apply(jvars, x, s, l), x, lab
        )
    )(jnp.asarray(x0), jnp.asarray(labels))
    with torch.no_grad():
        out = DeterministicSolver(num_steps=4).solve(
            port, nhwc_to_torch(x0), torch.from_numpy(labels)
        )
    out = torch_to_nhwc(out)
    assert np.isfinite(out).all()
    assert rel_l2(out, np.asarray(ref)) <= 1e-4


def test_solver_dtypes():
    assert DeterministicSolver(dtype="bfloat16").torch_dtype == torch.bfloat16
    assert DeterministicSolver().torch_dtype == torch.float32
    with pytest.raises(ValueError):
        DeterministicSolver(dtype="int8").torch_dtype
