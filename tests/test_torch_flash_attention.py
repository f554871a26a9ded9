"""The port's flash attention (the ``use_pallas_attention`` route) against
the JAX package.

The plain versions, and the autograd Function on CPU tensors, are held
against the JAX flash kernel in interpret mode (``_flash_attention_kernel_path``
and its custom VJP) and against ``_xla_attention``, on seeded numpy inputs,
at the JAX tests' tolerances (``tests/test_attention_kernel.py``): fp32 rtol
2e-4, atol 2e-5; bf16 rtol 0.05, atol 0.02; gradients fp32 rtol 1e-3, atol
1e-4, and in bf16 at (1, 1024, 1, 64) a median relative error < 2e-2
against the fp32-input reference. (1, 1100, 2, 64) has tail rows past a
multiple of every tile; (1, 1030, 2, 20) and (1, 1030, 2, 144) are the
bf16 CUDA kernel's edges (head dims padded to 32 and 192, element loads at
hd 20), held here against JAX and on the card against the plain version.
``CosineAttention(use_pallas=True)`` at 32x32
(n = 1024) reaches the JAX flash kernel in interpret mode on the CPU and the
port's flash Function.

The CUDA kernels against the plain versions need the card; on the card
``chip_smoke.py`` makes the same check at the ImageNet-512 widths.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import rel_l2
from tinyedm_tpu.models.layers import CosineAttention as JaxCosineAttention
from tinyedm_tpu.ops.attention import _flash_attention_kernel_path, _flash_bwd_impl, _xla_attention
from tinyedm_tpu_torch.models.layers import CosineAttention
from tinyedm_tpu_torch.ops import attention as fl
from tinyedm_tpu_torch.utils.interop import from_jax_variables

JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
FWD_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-5), torch.bfloat16: dict(rtol=0.05, atol=0.02)}
SHAPES = [
    ((2, 64, 2, 32), torch.float32),
    ((1, 256, 4, 64), torch.float32),
    ((2, 128, 1, 128), torch.float32),
    ((1, 64, 2, 64), torch.bfloat16),
    ((1, 1100, 2, 64), torch.float32),
    ((1, 1100, 2, 64), torch.bfloat16),
    # the bf16 kernel's edges, run on the card by test_cuda_kernels_match_plain:
    # hd 20 (element loads, padded to 32) and 144 (padded to 192), n = 1030
    ((1, 1030, 2, 20), torch.bfloat16),
    ((1, 1030, 2, 144), torch.bfloat16),
]


def _inputs(shape, dtype, seed=0, count=3):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32) for _ in range(count)]
    return ([torch.from_numpy(a).to(dtype) for a in arrays],
            [jnp.asarray(a).astype(JAX_DTYPES[dtype]) for a in arrays])


def _np(x) -> np.ndarray:
    return np.array(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("shape,dtype", SHAPES)
def test_forward_matches_jax_kernel_and_xla(shape, dtype):
    (q, k, v), (jq, jk, jv) = _inputs(shape, dtype)
    kernel_ref = _np(_flash_attention_kernel_path(jq, jk, jv))
    xla_ref = _np(_xla_attention(jq, jk, jv))
    plain = fl.flash_attention_plain(q, k, v)
    function = fl._FlashAttention.apply(q, k, v)
    assert plain.dtype == dtype and plain.shape == q.shape
    assert torch.equal(plain, function)
    for ref in (kernel_ref, xla_ref):
        np.testing.assert_allclose(plain.float().numpy(), ref, **FWD_TOL[dtype])
    # every tail row is computed (a40b910's first fix)
    np.testing.assert_allclose(plain.float().numpy()[:, -76:], kernel_ref[:, -76:], **FWD_TOL[dtype])


@pytest.mark.parametrize("shape,dtype", [s for s in SHAPES if s[1] == torch.float32])
def test_plain_backward_matches_jax_kernel(shape, dtype):
    """Against ``_flash_bwd_impl`` in interpret mode: dq in the input dtype,
    dk and dv summed in fp32 and cast once."""
    (q, k, v, g), (jq, jk, jv, jg) = _inputs(shape, dtype, seed=1, count=4)
    refs = [_np(r) for r in _flash_bwd_impl(jq, jk, jv, jg, interpret=True)]
    for out, ref in zip(fl.flash_attention_bwd_plain(q, k, v, g), refs):
        assert out.dtype == dtype
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-3, atol=1e-4)


def test_gradients_match_jax():
    """The Function's gradients (through autograd) against jax.grad of the
    interpret-mode kernel path and of the XLA attention."""
    (q, k, v), (jq, jk, jv) = _inputs((1, 64, 2, 32), torch.float32, seed=2)
    for t in (q, k, v):
        t.requires_grad_(True)
    grads = torch.autograd.grad(fl._FlashAttention.apply(q, k, v).pow(2).sum(), (q, k, v))
    for fn in (_flash_attention_kernel_path, _xla_attention):
        refs = jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c) ** 2), argnums=(0, 1, 2))(jq, jk, jv)
        for got, ref in zip(grads, refs):
            np.testing.assert_allclose(got.numpy(), _np(ref), rtol=1e-3, atol=1e-4)


def test_bf16_gradients_accumulate_in_fp32():
    """bf16 inputs at n = 1024: dk and dv summed in fp32 keep the gradients
    close to the fp32-input XLA reference (a40b910's second fix)."""
    (q, k, v, g), (jq, jk, jv, jg) = _inputs((1, 1024, 1, 64), torch.float32, seed=5, count=4)
    refs = jax.grad(lambda a, b, c: jnp.vdot(_xla_attention(a, b, c), jg), argnums=(0, 1, 2))(jq, jk, jv)
    qb, kb, vb = (t.to(torch.bfloat16).requires_grad_(True) for t in (q, k, v))
    out = fl.flash_attention(qb, kb, vb)
    grads = torch.autograd.grad(out, (qb, kb, vb), g.to(torch.bfloat16))
    for got, ref in zip(grads, refs):
        ref = _np(ref)
        err = np.abs(got.float().numpy() - ref) / np.maximum(np.abs(ref), 1e-3)
        assert np.median(err) < 2e-2


def test_gradcheck_fp64():
    """In fp64 every rounding site is exact: the analytic backward must match
    finite differences of the forward, with and without tail keys."""
    rng = np.random.default_rng(3)
    for shape in [(1, 5, 2, 3), (2, 7, 1, 4)]:
        args = tuple(torch.from_numpy(rng.standard_normal(shape)).requires_grad_(True) for _ in range(3))
        assert torch.autograd.gradcheck(fl._FlashAttention.apply, args)


def test_dispatch_by_token_count():
    """Below 1024 tokens flash_attention is xla_attention; at 1024 and above
    the Function, which on a CPU tensor runs the plain version and launches
    nothing."""
    (q, k, v), _ = _inputs((1, 1023, 1, 16), torch.float32, seed=4)
    assert torch.equal(fl.flash_attention(q, k, v), fl.xla_attention(q, k, v))
    before = dict(fl.launch_counts)
    (q, k, v), _ = _inputs((1, 1024, 1, 16), torch.float32, seed=4)
    q.requires_grad_(True)
    out = fl.flash_attention(q, k, v)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    assert torch.equal(out.detach(), fl.flash_attention_plain(q.detach(), k, v))
    assert dict(fl.launch_counts) == before


def test_cuda_wrappers_never_fall_back():
    """Only a CPU tensor takes the plain versions: the CUDA wrappers reject
    what they cannot launch instead of computing it some other way."""
    before = dict(fl.launch_counts)
    q = torch.zeros((1, 1024, 1, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fl.flash_attention_fwd_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fl.flash_attention_bwd_cuda(q, q, q, q, torch.zeros((2, 1, 1, 1024)))
    meta = torch.empty((1, 1024, 1, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fl.flash_attention_fwd_cuda(meta, meta, meta)
    assert dict(fl.launch_counts) == before


@pytest.mark.parametrize("channels,heads", [(32, 2), (48, 4)])
def test_cosine_attention_flash_route_matches_jax(channels, heads):
    """``CosineAttention(use_pallas=True)`` at 32x32, fp32: output and input
    gradient against the JAX module, whose flash kernel runs in interpret
    mode on the CPU."""
    x = np.random.default_rng(6).standard_normal((2, 32, 32, channels)).astype(np.float32)
    jmod = JaxCosineAttention(num_heads=heads, use_pallas=True)
    variables = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    g = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)
    ref, vjp = jax.vjp(lambda a: jmod.apply(variables, a), jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(g))

    port = CosineAttention(channels, heads, use_pallas=True)
    port.load_state_dict(from_jax_variables(variables, port))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    out = port(xt)
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g).permute(0, 3, 1, 2))
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), _np(ref), rtol=2e-4, atol=2e-5)
    assert rel_l2(dx.permute(0, 2, 3, 1).numpy(), _np(ref_dx)) <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("views", [False, True], ids=["contiguous", "qkv_views"])
@pytest.mark.parametrize("shape,dtype", [
    ((2, 1024, 4, 96), torch.bfloat16), ((2, 1024, 4, 96), torch.float32),
    ((1, 1100, 2, 64), torch.bfloat16), ((2, 1, 1, 256), torch.float32),
    ((1, 1030, 2, 20), torch.bfloat16), ((1, 1030, 2, 144), torch.bfloat16),
])
def test_cuda_kernels_match_plain(shape, dtype, views):
    """The kernels against the plain versions, on contiguous q, k, v and on
    the views of one (b, n, 3, heads, hd) tensor, as the layer hands them
    over."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    (q, k, v, g), _ = _inputs(shape, dtype, seed=8, count=4)
    q, k, v, g = (t.cuda() for t in (q, k, v, g))
    if views:
        q, k, v = torch.stack((q, k, v), dim=2).unbind(2)
    before = fl.launch_counts["flash_fwd", shape[1]], fl.launch_counts["flash_bwd", shape[1]]
    out, stats = fl.flash_attention_fwd_cuda(q, k, v)
    grads = fl.flash_attention_bwd_cuda(q, k, v, g, stats)
    torch.cuda.synchronize()
    after = fl.launch_counts["flash_fwd", shape[1]], fl.launch_counts["flash_bwd", shape[1]]
    assert after == (before[0] + 1, before[1] + 1)
    ref = fl.flash_attention_plain(q, k, v)
    tol = 8e-3 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0 if dtype == torch.bfloat16 else tol)
    for got, want in zip(grads, fl.flash_attention_bwd_plain(q, k, v, g)):
        err = float((got.double() - want.double()).norm() / want.double().norm().clamp(min=1e-30))
        assert err <= (1e-3 if dtype == torch.bfloat16 else 1e-5)


