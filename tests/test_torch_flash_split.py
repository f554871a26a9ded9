"""The arithmetic of the bf16 tensor-core flash backward
(``csrc/flash_attention_bwd.cu``).

The kernel multiplies bf16 operands on the tensor cores with fp32 sums, but
keeps p and ds in fp32: each enters the dq, dk and dv products as a hi + lo
pair of bf16 values, hi = bf16(x) and lo = bf16(x - hi). Up to hd 128 (the
warpgroup kernels) it takes p as one exp2 a logit, the scale's log2(e) and
the row statistics folded into its argument. ``split_pair_bwd`` is that
arithmetic in plain PyTorch (bf16 operands, p, the pair, fp32 sums, one
rounding of each output). On seeded normal inputs at n = 1024, hd 48, 72 and
96, it is held against the JAX flash backward kernel in interpret mode
(``_flash_bwd_impl``) and against ``flash_attention_bwd_plain`` within 1e-3
relative L2, the bf16 gate of ``chip_smoke.py``, with p from exp2 and, as
the 192 and 256 buckets take it, from exp and a division. The same
arithmetic with p and ds rounded once to bf16 misses that gate on the same
inputs: why the kernel splits them.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import rel_l2
from tinyedm_tpu.ops.attention import _flash_bwd_impl
from tinyedm_tpu_torch.ops import attention as fl

GATE = 1e-3  # chip_smoke.py's BWD_TOL for bf16
HEAD_DIMS = [48, 96]  # the ImageNet-512 widths above its attention levels
EXP2_HEAD_DIMS = [48, 72, 96]  # and DiT-XL/2's
LOG2E = np.float32(1.4426950408889634)


def _inputs(hd: int, seed: int = 0, n: int = 1024, heads: int = 2):
    """q, k, v, g: (1, n, heads, hd) bf16 from seeded standard normals, as
    torch tensors and as JAX arrays."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((1, n, heads, hd)).astype(np.float32) for _ in range(4)]
    return ([torch.from_numpy(a).to(torch.bfloat16) for a in arrays],
            [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays])


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def split_pair_bwd(q, k, v, g, split: bool = True, exp2: bool = True):
    """The tensor-core backward's arithmetic: p and ds fp32, each multiplied
    as hi + lo bf16 (or, with ``split`` False, rounded once to bf16), fp32
    sums, dq, dk and dv rounded once to the input dtype. p from the
    forward's row max m and sum s: with ``exp2`` (up to hd 128)
    2^(l c - (m log2(e) + log2(s))), l = q k^T and c = fp32(scale log2(e)),
    else exp(l scale - m) / s."""
    qa, ka, va, ga = (t.float() for t in (q, k, v, g))
    scale32 = np.float32(1.0 / math.sqrt(q.shape[-1]))
    scale = float(scale32)
    raw = torch.einsum("bqhd,bkhd->bhqk", qa, ka)
    logits = raw * scale
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    s = e.sum(dim=-1, keepdim=True)
    if exp2:
        p = torch.exp2(raw * float(scale32 * LOG2E) - (m * float(LOG2E) + torch.log2(s)))
    else:
        p = e / s
    dp = torch.einsum("bqhd,bkhd->bhqk", ga, va)
    delta = (dp * p).sum(dim=-1, keepdim=True)
    ds = (dp - delta) * p * scale

    def parts(x):
        hi = _bf16(x)
        return (hi, _bf16(x - hi)) if split else (hi,)

    dq = sum(torch.einsum("bhqk,bkhd->bqhd", a, ka) for a in parts(ds))
    dk = sum(torch.einsum("bhqk,bqhd->bkhd", a, qa) for a in parts(ds))
    dv = sum(torch.einsum("bhqk,bqhd->bkhd", a, ga) for a in parts(p))
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


def _worst(got, refs) -> float:
    return max(rel_l2(a.float().numpy(), r) for a, r in zip(got, refs))


@pytest.mark.parametrize("reference", ["jax_kernel", "plain"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_split_pair_within_the_gate(hd, reference):
    """hi + lo pairs: within 1e-3 of the JAX kernel (interpret mode) and of
    the plain version; in fact near the outputs' own rounding (3e-4)."""
    (q, k, v, g), (jq, jk, jv, jg) = _inputs(hd)
    if reference == "jax_kernel":
        refs = [np.asarray(r.astype(jnp.float32))
                for r in _flash_bwd_impl(jq, jk, jv, jg, interpret=True)]
    else:
        refs = [r.float().numpy() for r in fl.flash_attention_bwd_plain(q, k, v, g)]
    assert _worst(split_pair_bwd(q, k, v, g), refs) <= 3e-4


@pytest.mark.parametrize("exp2", [True, False], ids=["exp2", "exp_div"])
@pytest.mark.parametrize("hd", EXP2_HEAD_DIMS)
def test_exp2_within_the_gate_of_the_jax_kernel(hd, exp2):
    """p by one exp2 a logit (the warpgroup kernels), and by exp and a
    division (the 192 and 256 buckets): within 1e-3 of the JAX kernel in
    interpret mode at the ImageNet-512 and DiT-XL/2 widths, near the outputs'
    own rounding; the two ways of taking p differ by fp32 rounding."""
    (q, k, v, g), (jq, jk, jv, jg) = _inputs(hd, seed=hd)
    refs = [np.asarray(r.astype(jnp.float32)) for r in _flash_bwd_impl(jq, jk, jv, jg, interpret=True)]
    got = split_pair_bwd(q, k, v, g, exp2=exp2)
    assert _worst(got, refs) <= 3e-4 < GATE
    other = split_pair_bwd(q, k, v, g, exp2=not exp2)
    assert _worst(got, [o.float().numpy() for o in other]) <= 3e-4


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_single_rounding_misses_the_gate(hd):
    """p and ds rounded once to bf16 before the products: above 1e-3 of the
    plain version on the same inputs, while the pair stays 5x below it."""
    (q, k, v, g), _ = _inputs(hd)
    refs = [r.float().numpy() for r in fl.flash_attention_bwd_plain(q, k, v, g)]
    single = _worst(split_pair_bwd(q, k, v, g, split=False), refs)
    pair = _worst(split_pair_bwd(q, k, v, g), refs)
    assert single > GATE > 5 * pair


_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN2wg23flash_bwd_dkv_wg_kernelILi80EEEvPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _ZN2wg23flash_bwd_dkv_wg_kernelILi80EEEvPK13__nv_bfloat16
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN2tc23flash_bwd_dkv_tc_kernelILi192EEEvPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _ZN2tc23flash_bwd_dkv_tc_kernelILi192EEEvPK13__nv_bfloat16
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 178 registers, used 1 barriers, 48 bytes cumulative stack size
"""


def test_ptxas_registers_by_entry():
    """``_build.ptxas_registers`` reads each kernel entry's registers from
    a ptxas -v report, which chip_smoke.py's phase 2 holds the warpgroup
    kernels to."""
    from tinyedm_tpu_torch.ops import _build

    assert _build.ptxas_registers(_PTXAS_LOG) == {
        "_ZN2wg23flash_bwd_dkv_wg_kernelILi80EEEvPK13__nv_bfloat16": 168,
        "_ZN2tc23flash_bwd_dkv_tc_kernelILi192EEEvPK13__nv_bfloat16": 178,
    }
    assert _build.ptxas_registers("") == {}


def test_warpgroup_register_handoff_adds_up():
    """The warpgroup kernels' producers give back exactly the registers that
    their two consumer warpgroups take (setmaxnreg), out of the 168 a thread
    that a block of 384 threads launches with: a request past the pool would
    wait forever. Read from the source's constants."""
    import re
    from pathlib import Path

    import chip_smoke

    src = (Path(fl.__file__).parent.parent / "csrc" / "flash_attention_bwd.cu").read_text()
    value = {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
             for name in ("kProducerRegs", "kConsumerRegs", "kGroups")}
    threads = 128 * (value["kGroups"] + 1)
    assert threads == 384 and chip_smoke.WG_LAUNCH_REGS == 168
    assert 128 * value["kProducerRegs"] + 128 * value["kGroups"] * value["kConsumerRegs"] \
        <= threads * chip_smoke.WG_LAUNCH_REGS
    assert value["kProducerRegs"] % 8 == 0 and value["kConsumerRegs"] % 8 == 0
