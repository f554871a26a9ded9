"""The port's fused cosine attention against the JAX package.

The port's plain version (what the wrapper runs for a CPU tensor) is held
against the JAX Pallas forward kernel in interpret mode, ``_fwd_impl(...,
interpret=True)``, and against the XLA path. Tolerances are those of
``tests/test_fused_attention.py``: 1e-5 in fp32 (same math, other summation
order and exp); 8e-3 in bf16, where the kernel math and the XLA path round
the softmax at different places (bf16(E) before the PV product and one
divide after it, against bf16(E/s)), and where either side may round an
entry of E or of the normalized q, k, v one ulp apart.

The CUDA kernel against the plain version needs the card; on the card
``chip_smoke.py`` makes the same check at the CIFAR-10 path's shapes.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_fused_attention import xla_attention
from tinyedm_tpu.ops.fused_attention import _fwd_impl
from tinyedm_tpu_torch.ops import fused_attention as fa

CASES = [
    (64, 4, torch.bfloat16),
    (256, 4, torch.bfloat16),
    (64, 2, torch.float32),
    (16, 1, torch.float32),
    (56, 4, torch.bfloat16),
]
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _qkv(n, heads, dtype, b=2, seed=0, hd=64):
    c = hd * heads
    x = (np.random.default_rng(seed).standard_normal((b, n, 3 * c)) * 0.7).astype(np.float32)
    return torch.from_numpy(x).to(dtype), jnp.asarray(x).astype(JAX_DTYPES[dtype])


def _tol(dtype):
    return 8e-3 if dtype == torch.bfloat16 else 1e-5


@pytest.mark.parametrize("n,heads,dtype", CASES)
def test_plain_matches_jax_kernel(n, heads, dtype):
    t, j = _qkv(n, heads, dtype)
    port = fa.cosine_attention_qkv(t, heads)
    assert port.dtype == dtype and port.shape == (t.shape[0], n, t.shape[2] // 3)
    ref = np.asarray(_fwd_impl(j, heads, interpret=True).astype(jnp.float32))
    tol = _tol(dtype)
    np.testing.assert_allclose(port.float().numpy(), ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("n,heads,dtype", CASES)
def test_plain_matches_jax_xla_path(n, heads, dtype):
    t, j = _qkv(n, heads, dtype, seed=1)
    port = fa.cosine_attention_qkv(t, heads).float().numpy()
    ref = np.asarray(xla_attention(j, heads).astype(jnp.float32))
    tol = _tol(dtype)
    np.testing.assert_allclose(port, ref, atol=tol, rtol=tol)


def test_wrapper_never_falls_back():
    """Only a CPU tensor takes the plain version: any other device goes to the
    CUDA wrapper, which rejects what it cannot launch instead of computing it
    some other way."""
    before = dict(fa.launch_counts)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.cosine_attention_qkv(torch.empty((2, 16, 192), device="meta"), 1)
    with pytest.raises(ValueError, match="divisible"):
        fa.cosine_attention_qkv(torch.zeros((2, 16, 192)), 5)
    assert dict(fa.launch_counts) == before


def test_max_fused_tokens_bound():
    assert fa.MAX_FUSED_TOKENS == 512


@pytest.mark.cuda
@pytest.mark.parametrize("n,heads,dtype", CASES + [(256, 4, torch.float32), (1, 1, torch.float32)])
def test_cuda_kernel_matches_plain(n, heads, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    t, _ = _qkv(n, heads, dtype)
    t = t.cuda()
    before = fa.launch_counts["fwd", n]
    out = fa.cosine_attention_qkv(t, heads)
    torch.cuda.synchronize()
    assert fa.launch_counts["fwd", n] == before + 1
    ref = fa.cosine_attention_qkv_plain(t, heads)
    tol = _tol(dtype)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("n,hd", [(33, 144), (65, 144), (33, 192), (65, 192), (300, 256)])
def test_cuda_kernel_ragged_head_dims(n, hd):
    """The ImageNet-512 head dims (144, 192) at ragged token counts, and
    several key chunks per block (n 300 at hd 256), bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    t, _ = _qkv(n, 2, torch.bfloat16, hd=hd)
    t = t.cuda()
    out = fa.cosine_attention_qkv_cuda(t, 2)
    torch.cuda.synchronize()
    ref = fa.cosine_attention_qkv_plain(t, 2)
    torch.testing.assert_close(out.float(), ref.float(), atol=8e-3, rtol=8e-3)
