"""The port's fused cosine-attention backward against the JAX package.

The plain backward (what the autograd Function runs for a CPU tensor) is
held against the JAX Pallas backward kernel in interpret mode,
``_bwd_impl(..., interpret=True)``, given the same forward output o: same
algorithm and rounding sites, so the bound is tight (fp32: relative L2
<= 2e-6, measured 3e-7; bf16: relative L2 <= 5e-4, measured 5e-5, from a
bf16 rounding of E or ds landing one ulp apart where a sum's order differs).
Through the autograd Function, with the port's own forward, it is held
against ``jax.vjp`` of the XLA attention at the JAX tests' own tolerances
(fp32 atol 2e-6, rtol 2e-5; bf16 relative L2 < 2e-2). n = 64 with even heads
reaches the JAX pair kernel, n = 56 and 16 the per-head one.

The CUDA kernel against the plain version needs the card; on the card
``chip_smoke.py`` makes the same check at the CIFAR-10 training shapes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import rel_l2
from tests.test_fused_attention import xla_attention
from tinyedm_tpu.ops.fused_attention import _bwd_impl, _fwd_impl
from tinyedm_tpu_torch.ops import fused_attention as fa

JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
CASES = [
    (64, 4, torch.bfloat16),
    (64, 2, torch.float32),
    (56, 4, torch.bfloat16),
    (56, 3, torch.float32),
    (16, 1, torch.float32),
    (16, 2, torch.bfloat16),
]


def _inputs(n, heads, dtype, b=2, seed=0, hd=64):
    rng = np.random.default_rng(seed)
    c = hd * heads
    x = (rng.standard_normal((b, n, 3 * c)) * 0.7).astype(np.float32)
    g = (rng.standard_normal((b, n, c)) * 0.5).astype(np.float32)
    jd = JAX_DTYPES.get(dtype)
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(g).to(dtype),
            None if jd is None else jnp.asarray(x).astype(jd),
            None if jd is None else jnp.asarray(g).astype(jd))


def _np(x) -> np.ndarray:
    return np.array(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("n,heads,dtype", CASES)
def test_plain_bwd_matches_jax_kernel(n, heads, dtype):
    tq, tg, jq, jg = _inputs(n, heads, dtype)
    jo = _fwd_impl(jq, heads, interpret=True)
    ref = _np(_bwd_impl(jq, jg, jo, heads, interpret=True))
    to = torch.from_numpy(_np(jo)).to(dtype)
    out = fa.cosine_attention_qkv_bwd_plain(tq, tg, to, heads)
    assert out.dtype == dtype and out.shape == tq.shape
    assert rel_l2(out.float().numpy(), ref) <= (2e-6 if dtype == torch.float32 else 5e-4)


@pytest.mark.parametrize("n,heads,dtype", CASES)
def test_autograd_matches_xla_vjp(n, heads, dtype):
    tq, tg, jq, jg = _inputs(n, heads, dtype, seed=1)
    tq.requires_grad_(True)
    (out,) = torch.autograd.grad(fa.cosine_attention_qkv(tq, heads), tq, tg)
    ref = _np(jax.vjp(lambda q: xla_attention(q, heads), jq)[1](jg)[0])
    if dtype == torch.float32:
        np.testing.assert_allclose(out.numpy(), ref, atol=2e-6, rtol=2e-5)
    else:
        assert rel_l2(out.float().numpy(), ref) < 2e-2


def test_autograd_uses_own_output_and_plain_bwd():
    """The Function's backward is the plain backward on (qkv, g, its own o),
    bit for bit, and takes a non-contiguous g."""
    tq, tg, _, _ = _inputs(24, 2, torch.bfloat16, seed=2)
    tq.requires_grad_(True)
    out = fa.cosine_attention_qkv(tq, 2)
    g_t = tg.transpose(1, 2).contiguous().transpose(1, 2)  # same values, other strides
    assert not g_t.is_contiguous()
    (d,) = torch.autograd.grad(out, tq, g_t)
    ref = fa.cosine_attention_qkv_bwd_plain(tq.detach(), tg, out.detach(), 2)
    assert torch.equal(d, ref)


def test_gradcheck_fp64():
    """Exact-math VJP: in fp64 every rounding site is exact, so the analytic
    backward must match finite differences of the forward."""
    rng = np.random.default_rng(3)
    for n, heads, hd in [(5, 2, 3), (7, 1, 4)]:
        x = torch.from_numpy(rng.standard_normal((2, n, 3 * heads * hd)))
        x.requires_grad_(True)
        assert torch.autograd.gradcheck(lambda q: fa.cosine_attention_qkv(q, heads), (x,))


def test_bwd_wrapper_never_falls_back():
    """Only a CPU tensor takes the plain backward: the CUDA wrapper rejects
    what it cannot launch instead of computing it some other way."""
    before = dict(fa.launch_counts)
    qkv = torch.empty((2, 16, 192), device="meta")
    g = torch.empty((2, 16, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.cosine_attention_qkv_bwd_cuda(qkv, g, g, 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.cosine_attention_qkv_bwd_cuda(torch.zeros((2, 16, 192)), torch.zeros((2, 16, 64)),
                                         torch.zeros((2, 16, 64)), 1)
    assert dict(fa.launch_counts) == before


@pytest.mark.cuda
@pytest.mark.parametrize("n,heads,dtype,hd", [
    (256, 4, torch.bfloat16, 64), (64, 4, torch.bfloat16, 64), (256, 4, torch.float32, 64),
    (1, 1, torch.float32, 64), (97, 2, torch.bfloat16, 128), (33, 3, torch.float32, 20),
])
def test_cuda_bwd_kernel_matches_plain(n, heads, dtype, hd):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    tq, tg, _, _ = _inputs(n, heads, dtype, hd=hd)
    tq, tg = tq.cuda(), tg.cuda()
    o = fa.cosine_attention_qkv_plain(tq, heads)
    before = fa.launch_counts["bwd", n]
    out = fa.cosine_attention_qkv_bwd_cuda(tq, tg, o, heads)
    torch.cuda.synchronize()
    assert fa.launch_counts["bwd", n] == before + 1
    ref = fa.cosine_attention_qkv_bwd_plain(tq, tg, o, heads)
    assert rel_l2(out.float().cpu().numpy(), ref.float().cpu().numpy()) <= (
        1e-5 if dtype == torch.float32 else 5e-3
    )


@pytest.mark.cuda
@pytest.mark.parametrize("n,hd", [(33, 144), (65, 144), (33, 192), (65, 192), (300, 256)])
def test_cuda_bwd_kernel_ragged_head_dims(n, hd):
    """As the forward's case in test_torch_fused_attention.py: hd 144 and
    192 at ragged n, several key chunks at n 300, bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    tq, tg, _, _ = _inputs(n, 2, torch.bfloat16, hd=hd)
    tq, tg = tq.cuda(), tg.cuda()
    o = fa.cosine_attention_qkv_plain(tq, 2)
    out = fa.cosine_attention_qkv_bwd_cuda(tq, tg, o, 2)
    torch.cuda.synchronize()
    ref = fa.cosine_attention_qkv_bwd_plain(tq, tg, o, 2)
    assert rel_l2(out.float().cpu().numpy(), ref.float().cpu().numpy()) <= 1e-3
