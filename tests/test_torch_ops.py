"""The port's magnitude-preserving ops and preconditioning against the JAX
package's, on the same numpy inputs.

Tolerances: fp32 within 1e-6 (relative, with 1e-6 absolute for values near
zero): the two frameworks differ only in summation order and in the last
bits of sqrt/exp/log/sigmoid. bf16 within one bf16 ulp of the JAX value: the
math is the same, but each side rounds intermediate results at its own places.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyedm_tpu.ops import mp as jmp
from tinyedm_tpu.ops.precond import edm_precond as jax_edm_precond
from tinyedm_tpu_torch.ops import mp
from tinyedm_tpu_torch.ops.precond import edm_precond

DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


def _pair(shape, tdtype, jdtype, seed=0, scale=3.0):
    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(x).to(tdtype), jnp.asarray(x).astype(jdtype)


def _assert_close(port: torch.Tensor, ref, tdtype):
    a = port.float().numpy()
    b = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert a.shape == b.shape
    if tdtype == torch.float32:
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    else:
        # one bf16 ulp at the magnitude of the reference (8 mantissa bits)
        mag = np.maximum(np.abs(b), np.finfo(np.float32).tiny)
        ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
        assert np.all(np.abs(a - b) <= ulp), float(np.max(np.abs(a - b) / ulp))


@pytest.mark.parametrize("tdtype,jdtype", DTYPES)
@pytest.mark.parametrize("shape,dim", [((64, 48), -1), ((4, 8, 8, 32), 1), ((4, 8, 8, 32), (1, 2, 3))])
def test_pixel_norm(tdtype, jdtype, shape, dim):
    t, j = _pair(shape, tdtype, jdtype)
    _assert_close(mp.pixel_norm(t, dim=dim), jmp.pixel_norm(j, axis=dim), tdtype)


@pytest.mark.parametrize("tdtype,jdtype", DTYPES)
@pytest.mark.parametrize("shape", [(64, 48), (4, 6, 3, 3)])
def test_normalize(tdtype, jdtype, shape):
    t, j = _pair(shape, tdtype, jdtype)
    _assert_close(mp.normalize(t), jmp.normalize(j), tdtype)


@pytest.mark.parametrize("shape", [(32, 17), (3, 3, 12, 20)])
def test_weight_normalize_layouts(shape):
    """Linear (out, in) stays; an HWIO conv kernel is the port's OIHW one
    transposed, normalized over (1, 2, 3) instead of (0, 1, 2)."""
    w = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jmp.weight_normalize(jnp.asarray(w)))
    if w.ndim == 4:
        port = mp.weight_normalize(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
        port = port.permute(2, 3, 1, 0)
    else:
        port = mp.weight_normalize(torch.from_numpy(w))
    _assert_close(port, ref, torch.float32)
    with pytest.raises(ValueError):
        mp.weight_normalize(torch.zeros(3))


@pytest.mark.parametrize("tdtype,jdtype", DTYPES)
def test_mp_silu(tdtype, jdtype):
    """In bf16 the reference is the JAX function in fp32 on the same bf16
    values, rounded once: XLA's CPU backend expands the bf16 logistic into
    1/(1+exp(-x)) with a bf16 rounding after each step, which lands up to two
    ulps from the exact value and is not the function's definition."""
    t, j = _pair((16, 64), tdtype, jdtype)
    ref = jmp.mp_silu(j.astype(jnp.float32)).astype(jdtype)
    _assert_close(mp.mp_silu(t), ref, tdtype)


@pytest.mark.parametrize("tdtype,jdtype", DTYPES)
@pytest.mark.parametrize("t_", [0.3, 0.5])
def test_mp_add(tdtype, jdtype, t_):
    a, ja = _pair((16, 64), tdtype, jdtype, seed=2)
    b, jb = _pair((16, 64), tdtype, jdtype, seed=3)
    _assert_close(mp.mp_add(a, b, t_), jmp.mp_add(ja, jb, t_), tdtype)


@pytest.mark.parametrize("sigma_data", [0.5, 1.0])
def test_edm_precond(sigma_data):
    sigma = np.asarray([0.002, 0.1, 0.5, 1.0, 7.3, 80.0], np.float32)
    port = edm_precond(torch.from_numpy(sigma), sigma_data)
    ref = jax_edm_precond(jnp.asarray(sigma), sigma_data)
    for name in ("c_skip", "c_out", "c_in", "c_noise"):
        p, r = getattr(port, name), getattr(ref, name)
        assert p.dtype == torch.float32
        _assert_close(p, r, torch.float32)
