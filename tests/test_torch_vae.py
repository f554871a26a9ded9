"""The port's SD VAE (``tinyedm_tpu_torch/data/vae.py``) against the flax
module of ``tinyedm_tpu/data/vae.py`` on the same weights.

Weights: ``tests/test_vae_latents.py``'s synthetic diffusers state dict at
base 32, mults (1, 2), loaded by the port through
``diffusers_state_dict_to_port`` and by JAX through ``convert_torch_vae``;
``state_dict_from_jax`` carries the JAX params back, equal to the former.
Images 64x64.

Tolerances (relative L2, fp32): 1e-5 for each block, ``encode_moments``,
``encode_sample``, and the port's whole decode against a float64
evaluation of the same graph. The two packages' whole decodes against each
other: 3e-5, because JAX's fp32 decode itself lies further than 1e-5 from
the float64 one on these weights (the decoder's GroupNorms, scales drawn
N(0, 1), amplify each conv's rounding; the test's assertion message prints
both distances).
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_vae_latents import _synthetic_diffusers_state_dict, _torch_vae_reference
from tinyedm_tpu.data import vae as jvae
from tinyedm_tpu_torch.data import vae as pvae

torch.set_num_threads(1)
BASE, MULTS = 32, (1, 2)
TOL, DECODE_TOL = 1e-5, 3e-5


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def weights():
    sd = _synthetic_diffusers_state_dict(base=BASE, mults=MULTS, rng_seed=5)
    params = jvae.convert_torch_vae(sd, channel_mults=MULTS)
    port = pvae.build_vae(pvae.diffusers_state_dict_to_port(sd), "cpu", base_channels=BASE, channel_mults=MULTS)
    return sd, params, port


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(6).uniform(-1.0, 1.0, (2, 64, 64, 3)).astype(np.float32)


def test_state_dict_from_jax_equals_the_diffusers_conversion(weights):
    sd, params, port = weights
    from_jax = pvae.state_dict_from_jax(params)
    from_diffusers = pvae.diffusers_state_dict_to_port(sd)
    assert set(from_jax) == set(from_diffusers) == set(port.state_dict())
    for k in from_jax:
        assert torch.equal(from_jax[k], from_diffusers[k]), k


# (JAX path in the converted params, port submodule, JAX module, input NHWC shape)
BLOCKS = [
    ("encoder/down_1_block_0", "encoder.down_blocks.1.resnets.0", lambda: jvae.ResnetBlock(64), (2, 16, 16, 32)),
    ("decoder/up_0_block_1", "decoder.up_blocks.0.resnets.1", lambda: jvae.ResnetBlock(64), (2, 8, 8, 64)),
    ("encoder/mid_attn", "encoder.mid_block.attentions.0", lambda: jvae.AttnBlock(), (2, 8, 8, 64)),
    ("decoder/mid_attn", "decoder.mid_block.attentions.0", lambda: jvae.AttnBlock(), (1, 16, 16, 64)),
    ("encoder/down_0_downsample", "encoder.down_blocks.0.downsamplers.0", lambda: jvae.Downsample(32),
     (2, 15, 17, 32)),
    ("decoder/up_0_upsample", "decoder.up_blocks.0.upsamplers.0", lambda: jvae.Upsample(64), (2, 7, 9, 64)),
]


@pytest.mark.parametrize("path,name,make,shape", BLOCKS, ids=[b[1] for b in BLOCKS])
def test_block_matches_flax(weights, path, name, make, shape):
    _, params, port = weights
    p = params
    for key in path.split("/"):
        p = p[key]
    x = np.random.default_rng(len(name)).standard_normal(shape).astype(np.float32)
    want = make().apply({"params": p}, jnp.asarray(x))
    with torch.no_grad():
        got = port.get_submodule(name)(_nchw(x))
    assert got.shape == _nchw(np.asarray(want)).shape
    assert _rel(_nhwc(got), want) <= TOL


def test_encode_moments_and_decode_match_flax(weights, images):
    """Both packages against each other, and against a float64 evaluation of
    the same graph (``tests/test_vae_latents.py``'s plain torch reference,
    run on float64 weights and images): the port's decode lies within 1e-5
    of it, JAX's fp32 decode further, which is why the two fp32 decodes are
    held to 3e-5 of each other."""
    sd, params, port = weights
    sd64 = {k: np.asarray(v, np.float64) for k, v in sd.items()}
    ref_mean, ref_logvar, ref_decoded = _torch_vae_reference(sd64, images.astype(np.float64), BASE, MULTS)
    z = ref_mean.astype(np.float32)  # both decode the same latents
    module = jvae.AutoencoderKL(base_channels=BASE, channel_mults=MULTS)
    mean, logvar = module.apply({"params": params}, jnp.asarray(images), method=module.encode_moments)
    decoded = module.apply({"params": params}, jnp.asarray(z), method=module.decode)
    with torch.no_grad():
        pm, pl = port.encode_moments(_nchw(images))
        pd = port.decode(_nchw(z))
    assert pm.shape == (2, 4, 32, 32) and pd.shape == (2, 3, 64, 64)
    assert _rel(_nhwc(pm), mean) <= TOL and _rel(_nhwc(pm), ref_mean) <= TOL
    assert _rel(_nhwc(pl), logvar) <= TOL and _rel(_nhwc(pl), ref_logvar) <= TOL
    port_err, jax_err = _rel(_nhwc(pd), ref_decoded), _rel(decoded, ref_decoded)
    assert port_err <= TOL, (port_err, jax_err)
    assert _rel(_nhwc(pd), decoded) <= DECODE_TOL, (port_err, jax_err)


def test_logvar_is_clipped(weights):
    _, _, port = weights
    with torch.no_grad():
        port.quant_conv.bias[4:] += 100.0
        try:
            _, logvar = port.encode_moments(torch.zeros((1, 3, 16, 16)))
        finally:
            port.quant_conv.bias[4:] -= 100.0
    assert float(logvar.max()) == 20.0


def test_encode_sample_with_the_same_noise_matches_flax(weights, images):
    _, params, port = weights
    module = jvae.AutoencoderKL(base_channels=BASE, channel_mults=MULTS)
    key = jax.random.PRNGKey(3)
    want = module.apply({"params": params}, jnp.asarray(images), key, method=module.encode_sample)
    noise = jax.random.normal(key, want.shape, jnp.float32)  # the draw inside encode_sample
    with torch.no_grad():
        got = port.encode_sample(_nchw(images), noise=_nchw(np.asarray(noise)))
    assert _rel(_nhwc(got), want) <= TOL
    with pytest.raises(ValueError, match="noise"):
        port.encode_sample(_nchw(images), noise=torch.zeros((1, 4, 32, 32)))


def test_encode_sample_draws_from_the_generator(weights, images):
    _, _, port = weights
    x = _nchw(images)
    with torch.no_grad():
        a = port.encode_sample(x, generator=torch.Generator().manual_seed(1))
        b = port.encode_sample(x, generator=torch.Generator().manual_seed(1))
        c = port.encode_sample(x, generator=torch.Generator().manual_seed(2))
        mean, logvar = port.encode_moments(x)
    assert torch.equal(a, b) and not torch.equal(a, c)
    noise = torch.randn(mean.shape, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, mean + torch.exp(0.5 * logvar) * noise, rtol=0, atol=0)


def test_legacy_attention_names_and_4d_projections(weights, images):
    sd, _, port = weights
    legacy = {}
    names = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}
    for k, v in sd.items():
        for new, old in names.items():
            if f".attentions.0.{new}." in k:
                k = k.replace(f".{new}.", f".{old}.")
                v = v[:, :, None, None] if k.endswith(".weight") else v
        legacy[k] = v
    assert any(".query.weight" in k for k in legacy) and legacy[
        "encoder.mid_block.attentions.0.query.weight"].ndim == 4
    converted = pvae.diffusers_state_dict_to_port(legacy)
    want = pvae.diffusers_state_dict_to_port(sd)
    assert set(converted) == set(want) and all(torch.equal(converted[k], want[k]) for k in want)
    other = pvae.build_vae(converted, "cpu", base_channels=BASE, channel_mults=MULTS)
    with torch.no_grad():
        assert torch.equal(other.encode_moments(_nchw(images))[0], port.encode_moments(_nchw(images))[0])


def test_strict_load_names_what_is_missing(weights):
    sd, _, _ = weights
    partial = pvae.diffusers_state_dict_to_port(sd)
    del partial["decoder.conv_out.bias"]
    with pytest.raises(RuntimeError, match="decoder.conv_out.bias"):
        pvae.build_vae(partial, "cpu", base_channels=BASE, channel_mults=MULTS)


def test_full_width_matches_the_jax_parameter_tree():
    """sd-vae-ft-ema's width: 83,653,863 parameters (encoder 34,163,592,
    decoder 49,490,179), the same count and shapes as the flax module."""
    with torch.device("meta"):
        model = pvae.AutoencoderKL()
    module = jvae.AutoencoderKL()
    shapes = jax.eval_shape(lambda: module.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)),
                                                jax.random.PRNGKey(1)))["params"]
    leaves = jax.tree_util.tree_leaves_with_path(shapes)
    jax_sd = pvae.state_dict_from_jax(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes))
    ours = model.state_dict()
    assert set(jax_sd) == set(ours) and len(leaves) == len(ours)
    assert all(tuple(jax_sd[k].shape) == tuple(ours[k].shape) for k in ours)
    assert sum(t.numel() for t in ours.values()) == 83_653_863
    assert sum(p.numel() for p in model.encoder.parameters()) == 34_163_592
    assert sum(p.numel() for p in model.decoder.parameters()) == 49_490_179


def test_random_vae_is_seeded():
    a = pvae.random_state_dict(3, BASE, MULTS)
    b = pvae.random_state_dict(3, BASE, MULTS)
    c = pvae.random_state_dict(4, BASE, MULTS)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.conv_in.weight"], c["encoder.conv_in.weight"])
    assert torch.equal(a["encoder.conv_norm_out.weight"], torch.ones(64))
    assert float(a["decoder.conv_out.bias"].abs().sum()) == 0.0
    vae = pvae.random_vae(3, "cpu", base_channels=BASE, channel_mults=MULTS)
    assert not any(p.requires_grad for p in vae.parameters()) and not vae.training
    with torch.no_grad():
        out = vae.decode(torch.randn((1, 4, 8, 8)))
    assert out.shape == (1, 3, 16, 16) and torch.isfinite(out).all()


def test_bf16_compute_stays_near_fp32(weights, images):
    """``dtype=bfloat16`` computes the convs and projections in bf16 with
    fp32 GroupNorm and logits, as the flax module's ``dtype``: within 3e-2
    of fp32 (bf16's 8 bits through 20 convs)."""
    sd, _, port = weights
    bf = pvae.build_vae(pvae.diffusers_state_dict_to_port(sd), "cpu", dtype=torch.bfloat16, base_channels=BASE,
                        channel_mults=MULTS)
    assert all(p.dtype == torch.float32 for p in bf.parameters())
    with torch.no_grad():
        mean, _ = bf.encode_moments(_nchw(images))
        ref, _ = port.encode_moments(_nchw(images))
    assert mean.dtype == torch.bfloat16
    assert _rel(_nhwc(mean.float()), _nhwc(ref)) <= 3e-2


def test_vae_golden_file_when_present():
    """Real sd-vae-ft-ema weights and their diffusers outputs
    (experiments/make_vae_golden.py): skipped, as the JAX package's test is,
    while datasets/ holds neither file."""
    root = Path(__file__).resolve().parent.parent / "datasets"
    golden, weights = root / "vae_golden.npz", root / "sd_vae_ft_ema_state_dict.npz"
    if not golden.exists() or not weights.exists():
        pytest.skip("no sd-vae-ft-ema golden/weights in this egress-less environment"
                    " (run experiments/make_vae_golden.py where weights exist)")
    g = np.load(golden)
    vae = pvae.load_vae(str(weights), device="cpu")
    with torch.no_grad():
        mean, logvar = vae.encode_moments(_nchw(g["input"]))
        decoded = vae.decode(mean)
    np.testing.assert_allclose(_nhwc(mean), g["mean"], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_nhwc(logvar), g["logvar"], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_nhwc(decoded), g["decoded"], rtol=5e-3, atol=5e-3)
