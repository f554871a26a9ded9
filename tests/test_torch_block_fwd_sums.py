"""The arithmetic of the bf16 whole-block attention forward on the tensor
cores (``csrc/attention_block_fwd.cu`` through ``csrc/gemm_tc.cuh``).

The tensor-core GEMM multiplies bf16 operands exactly, sums each k16 step's
16 products from zero and adds that step's sum to the fp32 sums with one
rounded fp32 add; the plain version sums in another order. ``tc_matmul`` is that order of sums in plain PyTorch, and
``block_fwd_tc`` the block forward with both GEMMs taken that way (qkv
rounded to bf16, the plain attention core, out rounded, the ``mp_add``
residual). On inputs drawn as ``chip_smoke.py`` draws them (standard normal
x, weights scaled by C^-1/2), at the CIFAR-10 attention width (C 256, 4
heads of 64, n 256 and 64) and at C 768, it is held within the forward gate
of ``chip_smoke.py`` phase 13 (relative L2 1e-3 and three bf16 ulps of
max(1, |ref|) per element) against the JAX block forward kernel in interpret
mode (``_block_fwd_impl``) and against ``attention_block_plain``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import rel_l2
from tinyedm_tpu.ops.fused_attention import _block_fwd_impl
from tinyedm_tpu_torch.ops import fused_attention as fa
from tinyedm_tpu_torch.ops.mp import mp_add

GATE_REL, GATE_ULPS = 1e-3, 3  # chip_smoke.py phase 13, the bf16 forward
# (b, n, heads, C): CIFAR-10's two attention levels (n 256 takes the JAX
# per-head kernel, n 64 the head-pair one) and C 768
SHAPES = [(2, 256, 4, 256), (4, 64, 4, 256), (2, 64, 4, 768)]
K_STEP = 16  # the depth of one mma.sync.m16n8k16


def tc_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 sums of a @ w in gemm_tc.cuh's order: each k16 step summed from
    zero, then added to the running sums with one rounded fp32 add."""
    a, w = a.float(), w.float()
    acc = torch.zeros((*a.shape[:-1], w.shape[-1]), dtype=torch.float32)
    for k0 in range(0, a.shape[-1], K_STEP):
        acc = acc + torch.matmul(a[..., k0:k0 + K_STEP], w[k0:k0 + K_STEP])
    return acc


def block_fwd_tc(x: torch.Tensor, wqkv: torch.Tensor, wout: torch.Tensor, heads: int) -> torch.Tensor:
    """The block forward with both GEMMs summed as the tensor cores sum."""
    qkv = tc_matmul(x, wqkv).to(x.dtype)
    y = fa.cosine_attention_qkv_plain(qkv, heads)
    return mp_add(x, tc_matmul(y, wout).to(x.dtype), fa.RES_T)


def _inputs(b: int, n: int, c: int, seed: int = 0):
    """x, wqkv, wout in bf16, as torch tensors and as JAX arrays."""
    rng = np.random.default_rng(seed)
    arrays = [
        rng.standard_normal((b, n, c)).astype(np.float32),
        (rng.standard_normal((c, 3 * c)) / np.sqrt(c)).astype(np.float32),
        (rng.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32),
    ]
    return ([torch.from_numpy(a).to(torch.bfloat16) for a in arrays],
            [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays])


def _assert_within_gate(out: np.ndarray, ref: np.ndarray) -> None:
    assert rel_l2(out, ref) <= GATE_REL
    ulps = (np.abs(out - ref) / np.maximum(1.0, np.abs(ref))).max() / 2.0**-7
    assert ulps <= GATE_ULPS, ulps


@pytest.mark.parametrize("reference", ["jax_kernel", "plain"])
@pytest.mark.parametrize("b,n,heads,c", SHAPES)
def test_tensor_core_sums_within_forward_gate(b, n, heads, c, reference):
    (x, wq, wo), (jx, jwq, jwo) = _inputs(b, n, c)
    out = block_fwd_tc(x, wq, wo, heads)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    if reference == "plain":
        ref = fa.attention_block_plain(x, wq, wo, heads)
        # the order of sums does move some bf16 roundings of qkv
        qkv_tc = tc_matmul(x, wq).to(x.dtype)
        assert not torch.equal(qkv_tc, torch.matmul(x.float(), wq.float()).to(x.dtype))
        ref = ref.float().numpy()
    else:
        ref = np.array(jnp.asarray(_block_fwd_impl(jx, jwq, jwo, heads, interpret=True)).astype(jnp.float32))
    _assert_within_gate(out.float().numpy(), ref)
