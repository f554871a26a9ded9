"""The port's EDM forward against the JAX package's ``EDM.apply``.

The small model is the smoke config's topology (every block type, skips,
channel changes, ScaleLong, attention at 8x8), 16x16 images, batch 2, with
JAX-initialized weights carried over by ``from_jax_variables`` and
``gain_out`` set to 1. The port runs its default ``fused="auto"`` attention
(on the CPU, the kernel's plain version); the JAX side runs both its XLA
attention (``fused="off"``) and its Pallas kernel in interpret mode
(``fused="on"``). In the "block" cases both sides run ``fused="block"``:
the whole-block kernels (in interpret mode on the JAX side, the plain
versions on the port's), which fit at the smoke width's 8x8 attention.

Tolerances: fp32 within 1e-4 max abs (measured about 1e-6: the two
frameworks sum in other orders); bf16 within 2e-2 relative L2 (measured
about 1e-2: each side rounds to bf16 at its own places through ~20 layers).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import (
    IMAGE,
    jax_attention,
    nhwc_to_torch,
    rel_l2,
    set_port_attention,
    small_models,
    torch_to_nhwc,
)
from tinyedm_tpu_torch.configs import CONFIGS, build_model
from tinyedm_tpu_torch.models.layers import CosineAttention
from tinyedm_tpu_torch.ops import fused_attention as fa


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    sigma = np.asarray([0.3, 5.0], np.float32)
    x = (rng.standard_normal(IMAGE) * sigma[:, None, None, None]).astype(np.float32)
    labels = np.asarray([3, 7], np.int32)
    return x, sigma, labels


@pytest.mark.parametrize("jax_fused", ["off", "on", "block"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("num_classes", [None, 10])
def test_edm_forward_matches_jax(num_classes, dtype, jax_fused):
    jmodel, variables, port = small_models(num_classes, dtype)
    if jax_fused == "block":
        set_port_attention(port, "block")
    x, sigma, labels = _inputs()
    with jax_attention(jax_fused):
        ref = jax.jit(jmodel.apply)(
            jax.tree_util.tree_map(jnp.asarray, variables),
            jnp.asarray(x), jnp.asarray(sigma), jnp.asarray(labels),
        )
    ref = np.asarray(ref)
    with torch.no_grad():
        out = port(nhwc_to_torch(x), torch.from_numpy(sigma), torch.from_numpy(labels))
    assert out.dtype == torch.float32
    out = torch_to_nhwc(out)
    assert out.shape == ref.shape and np.isfinite(out).all()
    if dtype == torch.float32:
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
    else:
        assert rel_l2(out, ref) <= 2e-2


def test_unconditional_ignores_labels():
    """num_classes None: labels are dropped, as EDM.__call__ does."""
    _, _, port = small_models(None, torch.float32)
    x, sigma, labels = _inputs(1)
    args = (nhwc_to_torch(x), torch.from_numpy(sigma))
    with torch.no_grad():
        torch.testing.assert_close(port(*args, torch.from_numpy(labels)), port(*args), rtol=0, atol=0)


def test_fused_auto_and_off_agree():
    """The port's two attention paths on the same weights (fp32: same math up
    to the softmax's max subtraction and divide placement)."""
    _, _, port = small_models(10, torch.float32)
    x, sigma, labels = _inputs(2)
    args = (nhwc_to_torch(x), torch.from_numpy(sigma), torch.from_numpy(labels))
    with torch.no_grad():
        auto = port(*args)
        set_port_attention(port, "off")
        off = port(*args)
    torch.testing.assert_close(auto, off, atol=1e-5, rtol=1e-5)


def test_from_jax_variables_maps_every_leaf():
    _, variables, port = small_models(10, torch.float32)
    from tinyedm_tpu_torch.utils.interop import from_jax_variables

    sd = from_jax_variables(variables, port)
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    assert len(sd) == n_leaves == len(port.state_dict())
    bad = {"params": {**variables["params"], "u": {"w": np.zeros((1, 1))}}}
    with pytest.raises(KeyError, match="no counterpart"):
        from_jax_variables(bad, port)
    partial = {"params": variables["params"]}  # the Fourier constants left out
    with pytest.raises(KeyError, match="unfilled"):
        from_jax_variables(partial, port)


def test_attention_options_raise():
    """fused="block" builds and runs (the whole-block route, held against
    the JAX module in test_torch_attention_block.py); fused="on" runs the
    fused route past MAX_FUSED_TOKENS (held against the JAX module in
    test_torch_model_knobs.py); use_pallas at n >= 1024 runs the flash route
    (held against the JAX module in test_torch_flash_attention.py); an
    unknown fused value raises."""
    with pytest.raises(ValueError, match="fused must be"):
        CosineAttention(64, 2, fused="always")
    for kwargs, side in ((dict(fused="block"), 8), (dict(fused="on"), 24),
                         (dict(use_pallas=True, fused="off"), 32)):
        attn = CosineAttention(64, 2, **kwargs)
        attn.qkv_conv.weight.data.normal_(generator=torch.Generator().manual_seed(0))
        attn.out_conv.weight.data.normal_(generator=torch.Generator().manual_seed(1))
        x = torch.randn((1, 64, side, side), generator=torch.Generator().manual_seed(2))
        out = attn(x)
        assert out.shape == x.shape and torch.isfinite(out).all()


def test_cifar10_attention_layers_per_forward():
    """11 attention layers: 5 at 16x16 (n=256) and 6 at 8x8 (n=64), which the
    card's Heun-32 path multiplies by 63 forwards (693 kernel launches)."""
    model = build_model("cifar10", "cpu")
    sizes = []
    hooks = [
        m.register_forward_pre_hook(lambda mod, args: sizes.append(args[0].shape[-1] ** 2))
        for m in model.modules()
        if isinstance(m, CosineAttention)
    ]
    assert len(hooks) == 11
    assert CONFIGS["cifar10"]["denoiser"]["encoder_out_channels"][0] == 256
    before = dict(fa.launch_counts)
    with torch.no_grad():
        out = model(torch.zeros((1, 3, 32, 32)), torch.ones((1,)))
    assert out.shape == (1, 3, 32, 32)
    assert sorted(sizes) == [64] * 6 + [256] * 5
    assert dict(fa.launch_counts) == before  # the CPU never launches the kernel
