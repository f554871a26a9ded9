"""The port's whole-block cosine attention against the JAX package.

``attention_block_plain`` and ``attention_block_bwd_plain`` (what the
autograd Function runs for a CPU tensor) are held against the JAX Pallas
block kernels in interpret mode, ``_block_fwd_impl(..., interpret=True)`` and
``_block_bwd_impl(..., interpret=True)``, on inputs made with numpy. n = 16
and 64 with even heads reach the JAX pair kernels as the attention core,
n = 49, 256 or odd heads the per-head ones. Bounds:

- fp32: forward atol = rtol = 1e-5, dx and both weight gradients relative L2
  2e-5 (measured at most 5.4e-7 and 4.7e-7: the same math, other orders of
  summation);
- bf16: forward within one bf16 ulp of max(1, |ref|) (measured 0); backward relative L2 5e-4 at pair shapes (measured 3.0e-4)
  and 5e-3 at per-head shapes (measured 2.1e-3). At per-head shapes the JAX
  kernel's dk, run in interpret mode on the CPU, is 3.8e-3 (relative L2) off
  an evaluation of its own rounding sites with fp64 sums, which the port's
  plain version equals exactly; its dq and dv agree with the port's.

The Function is also held against autograd through the unfused layer, by an
fp64 ``gradcheck``, and ``CosineAttention(fused="block")`` against the JAX
module of that name on the same weights, forward and all gradients, at the
bounds of ``tests/test_attention_block.py`` (2e-5, 1e-4). The CUDA kernels
need the card; on it ``chip_smoke.py`` holds them against the plain versions
at the CIFAR-10 shapes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import rel_l2
from tinyedm_tpu.models.layers import CosineAttention as JaxCosineAttention
from tinyedm_tpu.ops.fused_attention import _block_bwd_impl, _block_fwd_impl
from tinyedm_tpu.ops.fused_attention import block_kernel_fits as jax_block_kernel_fits
from tinyedm_tpu_torch.models import layers
from tinyedm_tpu_torch.models.layers import CosineAttention
from tinyedm_tpu_torch.ops import fused_attention as fa
from tinyedm_tpu_torch.utils.interop import from_jax_variables

JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# (n, heads, C, dtype): pair shapes first, then per-head ones
CASES = [
    (16, 2, 64, torch.float32),
    (64, 4, 128, torch.bfloat16),
    (64, 2, 64, torch.float32),
    (49, 2, 64, torch.float32),
    (16, 3, 96, torch.bfloat16),
    (256, 2, 64, torch.float32),
]


def _inputs(n, c, dtype, b=2, seed=0):
    """x, wqkv, wout, g as (torch in dtype, jax in dtype) pairs; the weights
    scaled as effective weights are (unit-norm columns / sqrt(C))."""
    rng = np.random.default_rng(seed)
    arrays = [
        rng.standard_normal((b, n, c)).astype(np.float32),
        (rng.standard_normal((c, 3 * c)) / np.sqrt(c)).astype(np.float32),
        (rng.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32),
        rng.standard_normal((b, n, c)).astype(np.float32),
    ]
    jd = JAX_DTYPES.get(dtype)
    return ([torch.from_numpy(a).to(dtype) for a in arrays],
            [None if jd is None else jnp.asarray(a).astype(jd) for a in arrays])


def _np(x) -> np.ndarray:
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _check_forward(out: np.ndarray, ref: np.ndarray, dtype, ulps: int = 1) -> None:
    """fp32: atol = rtol = 1e-5; bf16: every element within ``ulps`` bf16
    ulps of max(1, |ref|)."""
    if dtype == torch.float32:
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    else:
        assert (np.abs(out - ref) / np.maximum(1.0, np.abs(ref))).max() <= ulps * 2.0**-7


@pytest.mark.parametrize("n,heads,c,dtype", CASES)
def test_plain_forward_matches_jax_kernel(n, heads, c, dtype):
    (x, wq, wo, _), (jx, jwq, jwo, _) = _inputs(n, c, dtype)
    out = fa.attention_block_plain(x, wq, wo, heads)
    assert out.dtype == dtype and out.shape == x.shape
    ref = _np(_block_fwd_impl(jx, jwq, jwo, heads, interpret=True))
    _check_forward(out.float().numpy(), ref, dtype)


@pytest.mark.parametrize("n,heads,c,dtype", CASES)
def test_plain_backward_matches_jax_kernel(n, heads, c, dtype):
    (x, wq, wo, g), (jx, jwq, jwo, jg) = _inputs(n, c, dtype, seed=1)
    grads = fa.attention_block_bwd_plain(x, wq, wo, g, heads)
    assert [t.dtype for t in grads] == [dtype, torch.float32, torch.float32]
    refs = _block_bwd_impl(jx, jwq, jwo, jg, heads, interpret=True)
    if dtype == torch.float32:
        bound = 2e-5
    else:
        bound = 5e-4 if fa.use_pair(heads, n) else 5e-3
    for name, got, want in zip(("dx", "dwqkv", "dwout"), grads, refs):
        assert rel_l2(got.float().numpy(), _np(want)) <= bound, name


def _layers(c, heads, dtype, seed=0):
    block = CosineAttention(c, heads, dtype=dtype, fused="block")
    gen = torch.Generator().manual_seed(seed)
    block.qkv_conv.reset_parameters(gen)
    block.out_conv.reset_parameters(gen)
    off = CosineAttention(c, heads, dtype=dtype, fused="off")
    off.load_state_dict(block.state_dict())
    return block, off


def test_function_matches_autograd_through_unfused_layer():
    """fp32: the block route's output and gradients (input and both stored
    weights) against autograd through pixel norm and the XLA branch."""
    block, off = _layers(64, 2, torch.float32)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 64, 8, 8)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 64, 8, 8)).astype(np.float32))
    results = []
    for module in (block, off):
        xr = x.clone().requires_grad_(True)
        out = module(xr)
        grads = torch.autograd.grad(out, [xr, module.qkv_conv.weight, module.out_conv.weight], g)
        results.append((out.detach(), grads))
    (out, grads), (ref, ref_grads) = results
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    for got, want in zip(grads, ref_grads):
        assert rel_l2(got.numpy(), want.numpy()) <= 2e-5


def test_plain_backward_gradcheck_fp64():
    """In fp64 every rounding site is exact: the plain backward is the VJP of
    the plain forward in all three inputs."""
    rng = np.random.default_rng(4)
    c, heads = 8, 2
    x = torch.from_numpy(rng.standard_normal((2, 5, c))).requires_grad_(True)
    wq = torch.from_numpy(rng.standard_normal((c, 3 * c)) / np.sqrt(c)).requires_grad_(True)
    wo = torch.from_numpy(rng.standard_normal((c, c)) / np.sqrt(c)).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda a, b, d: fa.attention_block(a, b, d, heads), (x, wq, wo))


@pytest.mark.parametrize("side,c,heads", [(4, 128, 2), (8, 128, 4)])
def test_layer_matches_jax_block_layer(side, c, heads):
    """CosineAttention(fused="block") against the JAX module of that name
    from the same weights (its qkv_conv/w and out_conv/w, HWIO to OIHW):
    forward atol = rtol = 2e-5, input and weight gradients 1e-4."""
    rng = np.random.default_rng(side)
    x = (rng.standard_normal((3, side, side, c)) * 0.6).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jmod = JaxCosineAttention(num_heads=heads, fused="block")
    variables = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(1), jnp.asarray(x)))

    def apply(params, xx):
        return jmod.apply({"params": params}, xx)

    ref, vjp = jax.vjp(apply, jax.tree_util.tree_map(jnp.asarray, variables["params"]), jnp.asarray(x))
    ref_params, ref_dx = vjp(jnp.asarray(g))
    ref_grads = from_jax_variables({"params": jax.tree_util.tree_map(np.asarray, ref_params)})

    port = CosineAttention(c, heads, fused="block")
    port.load_state_dict(from_jax_variables(variables, port))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    out = port(xt)
    names = [k for k, _ in port.named_parameters()]
    dx, *dws = torch.autograd.grad(out, [xt, *port.parameters()],
                                   torch.from_numpy(g).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), _np(ref), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(dx.permute(0, 2, 3, 1).numpy(), _np(ref_dx), atol=1e-4, rtol=1e-4)
    assert sorted(names) == sorted(ref_grads)
    for name, dw in zip(names, dws):
        np.testing.assert_allclose(dw.numpy(), ref_grads[name].numpy(), atol=1e-4, rtol=1e-4)


def test_block_kernel_fits_equals_jax():
    grid = [(n, c, h) for n in (1, 16, 49, 64, 256, 1024, 4096)
            for c in (64, 128, 192, 256, 384, 576, 768) for h in (1, 2, 3, 4) if c % h == 0]
    assert all(fa.block_kernel_fits(*k) == jax_block_kernel_fits(*k) for k in grid)
    # the CIFAR-10 attention layers fit (C 256 at n = 256 and 64), the
    # ImageNet-512 ones do not (C 576 at n = 256, 768 at n = 64)
    assert fa.block_kernel_fits(256, 256, 4) and fa.block_kernel_fits(64, 256, 4)
    assert not fa.block_kernel_fits(256, 576, 4) and not fa.block_kernel_fits(64, 768, 4)


def test_layer_takes_the_block_route_exactly_where_it_fits(monkeypatch):
    """C = 256 at 8x8 takes attention_block; C = 768 at 8x8 does not fit and
    runs the unfused route, bit for bit the fused="off" layer's output."""
    calls = []
    real = layers.attention_block
    monkeypatch.setattr(layers, "attention_block",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    for c, expected in ((256, [(1, 64, 256)]), (768, [])):
        calls.clear()
        block, off = _layers(c, 4, torch.float32, seed=c)
        x = torch.randn((1, c, 8, 8), generator=torch.Generator().manual_seed(5))
        with torch.no_grad():
            out, ref = block(x), off(x)
        assert [tuple(s) for s in calls] == expected
        if not expected:
            assert torch.equal(out, ref)
        else:
            torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


def test_wrappers_never_fall_back():
    """Only a CPU tensor takes the plain versions: the CUDA wrappers reject
    what they cannot launch instead of computing it some other way."""
    before = dict(fa.launch_counts)
    x = torch.empty((2, 16, 64), device="meta")
    wq, wo = torch.empty((64, 192), device="meta"), torch.empty((64, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.attention_block(x, wq, wo, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.attention_block_bwd_cuda(torch.zeros((2, 16, 64)), torch.zeros((64, 192)),
                                    torch.zeros((64, 64)), torch.zeros((2, 16, 64)), 2)
    with pytest.raises(ValueError, match="divisible"):
        fa.attention_block_cuda(torch.zeros((2, 16, 64)), torch.zeros((64, 192)),
                                torch.zeros((64, 64)), 3)
    assert dict(fa.launch_counts) == before


@pytest.mark.cuda
@pytest.mark.parametrize("n,heads,c,dtype", [
    (256, 4, 256, torch.bfloat16), (64, 4, 256, torch.bfloat16), (256, 4, 256, torch.float32),
    (49, 3, 96, torch.float32), (1, 1, 64, torch.bfloat16), (300, 4, 768, torch.bfloat16),
])
def test_cuda_kernels_match_plain(n, heads, c, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    (x, wq, wo, g), _ = _inputs(n, c, dtype, b=4, seed=6)
    x, wq, wo, g = (t.cuda() for t in (x, wq, wo, g))
    before = fa.launch_counts["block_fwd", n], fa.launch_counts["block_bwd", n]
    out = fa.attention_block_cuda(x, wq, wo, heads)
    grads = fa.attention_block_bwd_cuda(x, wq, wo, g, heads)
    torch.cuda.synchronize()
    assert (fa.launch_counts["block_fwd", n], fa.launch_counts["block_bwd", n]) == (
        before[0] + 1, before[1] + 1)
    # bf16: one ulp of out from the GEMM's sum order becomes up to two of
    # the output through the residual's roundings (chip_smoke.py phase 13)
    ref = fa.attention_block_plain(x, wq, wo, heads).float().cpu().numpy()
    _check_forward(out.float().cpu().numpy(), ref, dtype, ulps=3)
    if dtype == torch.bfloat16:
        assert rel_l2(out.float().cpu().numpy(), ref) <= 1e-3
    for got, want in zip(grads, fa.attention_block_bwd_plain(x, wq, wo, g, heads)):
        assert rel_l2(got.float().cpu().numpy(), want.float().cpu().numpy()) <= (
            1e-3 if dtype == torch.bfloat16 else 1e-5)
