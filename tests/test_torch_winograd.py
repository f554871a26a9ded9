"""The port's Winograd F(2x2, 3x3) conv against the JAX package.

``winograd_conv3x3_plain`` (what ``winograd_conv3x3`` runs for a CPU tensor)
is held against the JAX Pallas kernel in interpret mode,
``winograd_conv3x3(..., interpret=True, bb=1)``, at the shapes of
``tests/test_winograd.py``, on inputs made with numpy: fp32 within atol =
rtol = 2e-5 (measured at most 6e-7: the component products sum in other
orders), bf16 within 1e-3 relative L2 (measured 0: the same rounding sites,
and every bf16 product exact in fp32). ``transform_weights`` equals the JAX
function bit for bit, and the plain version agrees with ``F.conv2d`` in fp32
at the JAX test's 2e-5. The CUDA kernel needs the card; on it
``chip_smoke.py`` holds it against the plain version at the CIFAR-10 conv
shapes. The kernel's edges (105 tiles, Ci 40 and Co 72, none a multiple
of the bf16 kernel's 32-tile x 64-channel block or its 16-channel chunk)
are checked both ways: the plain version against JAX here, the kernel
against the plain version on the card.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests._torch_parity import rel_l2
from tinyedm_tpu.ops import winograd as jax_winograd
from tinyedm_tpu_torch.ops import winograd as wg

JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
CASES = [
    ((2, 8, 8, 16), 24, torch.float32),
    ((1, 16, 16, 8), 8, torch.float32),
    ((3, 4, 4, 4), 12, torch.float32),
    ((2, 8, 8, 16), 16, torch.bfloat16),
    # the CUDA kernel's edges (a tile count, Ci and Co off its block tile),
    # run on the card by test_cuda_kernel_matches_plain
    ((3, 10, 14, 40), 72, torch.bfloat16),
    ((3, 10, 14, 40), 72, torch.float32),
]


def _inputs(shape, co, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    w = (rng.standard_normal((3, 3, shape[-1], co)) * 0.1).astype(np.float32)
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype),
            jnp.asarray(x).astype(JAX_DTYPES[dtype]), jnp.asarray(w).astype(JAX_DTYPES[dtype]))


def _direct(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The direct SAME conv in NHWC / HWIO, fp32."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


@pytest.mark.parametrize("shape,co,dtype", CASES)
def test_plain_matches_jax_kernel(shape, co, dtype):
    x, w, jx, jw = _inputs(shape, co, dtype)
    out = wg.winograd_conv3x3(x, w)
    assert out.dtype == dtype and out.shape == (*shape[:3], co)
    ref = np.asarray(jax_winograd.winograd_conv3x3(jx, jw, interpret=True, bb=1).astype(jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)
    else:
        assert rel_l2(out.float().numpy(), ref) <= 1e-3


@pytest.mark.parametrize("ci,co", [(4, 6), (16, 24)])
def test_transform_weights_equals_jax(ci, co):
    w = np.random.default_rng(ci).standard_normal((3, 3, ci, co)).astype(np.float32)
    u = wg.transform_weights(torch.from_numpy(w))
    assert u.shape == (4, 4, ci, co) and u.dtype == torch.float32
    np.testing.assert_array_equal(u.numpy(), np.asarray(jax_winograd.transform_weights(jnp.asarray(w))))


@pytest.mark.parametrize("shape,co", [((2, 8, 8, 16), 24), ((1, 6, 4, 3), 20), ((2, 2, 2, 24), 3)])
def test_plain_matches_direct_conv_fp32(shape, co):
    x, w, _, _ = _inputs(shape, co, torch.float32, seed=1)
    torch.testing.assert_close(wg.winograd_conv3x3(x, w), _direct(x, w), atol=2e-5, rtol=2e-5)


def test_odd_spatial_rejected():
    for shape in ((1, 7, 8, 4), (1, 8, 5, 4)):
        with pytest.raises(ValueError, match="even"):
            wg.winograd_conv3x3(torch.zeros(shape), torch.zeros((3, 3, 4, 4)))
    with pytest.raises(ValueError, match="w must be"):
        wg.winograd_conv3x3(torch.zeros((1, 8, 8, 4)), torch.zeros((3, 3, 5, 4)))


def test_wrapper_never_falls_back():
    """Only a CPU tensor takes the plain version; the CUDA wrapper rejects
    what it cannot launch instead of computing it some other way."""
    before = dict(wg.launch_counts)
    with pytest.raises(ValueError, match="CUDA"):
        wg.winograd_conv3x3(torch.empty((1, 8, 8, 4), device="meta"), torch.empty((3, 3, 4, 4), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        wg.winograd_conv3x3_cuda(torch.zeros((1, 8, 8, 4)), torch.zeros((3, 3, 4, 4)))
    assert dict(wg.launch_counts) == before


def test_launch_rejects_mismatched_weights():
    """The launch checks w against x before it touches the card."""
    x = torch.zeros((1, 8, 8, 4), dtype=torch.bfloat16)
    for w in (torch.zeros((3, 3, 5, 4)), torch.zeros((4, 4, 4, 4)), torch.zeros((3, 3, 4))):
        with pytest.raises(ValueError, match="w must be"):
            wg.winograd_conv3x3_cuda(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        wg.winograd_conv3x3_cuda(x, torch.zeros((3, 3, 4, 4), dtype=torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,co,dtype", [
    ((8, 32, 32, 256), 256, torch.bfloat16), ((8, 32, 32, 4), 256, torch.bfloat16),
    ((4, 8, 8, 256), 256, torch.float32), ((2, 6, 6, 3), 20, torch.float32),
    ((1, 4, 8, 20), 24, torch.bfloat16), ((3, 10, 14, 40), 72, torch.bfloat16),
    ((3, 10, 14, 40), 72, torch.float32),
])
def test_cuda_kernel_matches_plain(shape, co, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    x, w, _, _ = _inputs(shape, co, dtype, seed=2)
    x, w = x.cuda(), w.cuda()
    key = ("winograd", *shape[1:], co)
    before = wg.launch_counts[key]
    out = wg.winograd_conv3x3(x, w)
    torch.cuda.synchronize()
    assert wg.launch_counts[key] == before + 1
    ref = wg.winograd_conv3x3_plain(x, w)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
    else:
        assert rel_l2(out.float().cpu().numpy(), ref.float().cpu().numpy()) <= 1e-3


@pytest.mark.cuda
def test_cuda_kernel_offset_input():
    """x a contiguous view one element into its storage (not 16-byte
    aligned), bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    shape, co = (2, 8, 10, 32), 40
    x, w, _, _ = _inputs(shape, co, torch.bfloat16, seed=3)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
    xo = flat[1:].view(shape)
    xo.copy_(x)
    out = wg.winograd_conv3x3_cuda(xo, w.cuda())
    torch.cuda.synchronize()
    ref = wg.winograd_conv3x3_plain(x, w)
    assert rel_l2(out.float().cpu().numpy(), ref.float().numpy()) <= 1e-3
