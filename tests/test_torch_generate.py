"""The port's generate() on the CPU against the JAX package's solve.

Small model (the smoke topology in fp32, conditional), weights from the JAX
init carried over by ``from_jax_variables`` and written with
``save_weights``; 5 samples at batch 4, so the tail batch is padded. Each PNG
the port writes must decode to JAX's ``device_denormalize_uint8`` of the JAX
Heun solve of the same noise, within 1 level (the fp32 solves differ by about
1e-6 relative; a pixel near a level boundary may truncate either way).
"""

from __future__ import annotations

import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests._torch_parity import small_models
from tinyedm_tpu.data.datamodules import RandomNoiseDataModule as JaxNoise
from tinyedm_tpu.diffusion.solver import DeterministicSolver as JaxSolver
from tinyedm_tpu.generate import device_denormalize_uint8 as jax_denormalize
from tinyedm_tpu_torch import configs
from tinyedm_tpu_torch.generate import (
    CIFAR10_MEAN,
    CIFAR10_STD,
    device_denormalize_uint8,
    generate,
    main,
)
from tinyedm_tpu_torch.training.callbacks import encode_png
from tinyedm_tpu_torch.utils.interop import save_weights

NUM_SAMPLES, BATCH, STEPS, SEED = 5, 4, 3, 7


@pytest.fixture
def smoke_fp32_weights(tmp_path, monkeypatch):
    cfg = {
        "embedding": configs.SMOKE["embedding"],
        "denoiser": {**configs.SMOKE["denoiser"], "dtype": "float32"},
    }
    monkeypatch.setitem(configs.CONFIGS, "smoke_fp32", cfg)
    jmodel, variables, port = small_models(10, torch.float32)
    path = tmp_path / "weights.pt"
    save_weights(port, path, "smoke_fp32")
    return jmodel, variables, path


def _jax_images(jmodel, variables):
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    solve = jax.jit(
        lambda x, lab: jax_denormalize(
            JaxSolver(num_steps=STEPS).solve(lambda x, s, l: jmodel.apply(jvars, x, s, l), x, lab),
            CIFAR10_MEAN, CIFAR10_STD,
        )
    )
    images = []
    noise_feed = JaxNoise(batch_size=BATCH, image_size=16, num_samples=NUM_SAMPLES,
                          num_classes=10, seed=SEED)
    for noise, labels, indices in noise_feed.predict_batches():
        n = len(indices)
        pad = BATCH - n
        noise = np.concatenate([noise, noise[:1].repeat(pad, 0)])
        labels = np.concatenate([labels, labels[:1].repeat(pad, 0)])
        images.append(np.asarray(solve(jnp.asarray(noise), jnp.asarray(labels)))[:n])
    return np.concatenate(images)


def test_generate_matches_jax_solve(smoke_fp32_weights, tmp_path):
    jmodel, variables, weights = smoke_fp32_weights
    out_dir = tmp_path / "samples"
    result = generate(
        str(out_dir), NUM_SAMPLES, 16, BATCH,
        weights=str(weights), device="cpu", num_steps=STEPS, seed=SEED, keep_samples=True,
    )
    assert result["images"] == NUM_SAMPLES and result["peak_bytes"] is None
    assert result["samples"].shape == (NUM_SAMPLES, 16, 16, 3)
    assert sorted(p.name for p in out_dir.iterdir()) == [f"{i}.png" for i in range(NUM_SAMPLES)]
    ref = _jax_images(jmodel, variables)
    for i in range(NUM_SAMPLES):
        got = np.asarray(Image.open(out_dir / f"{i}.png").convert("RGB"))
        assert got.dtype == np.uint8 and got.shape == (16, 16, 3)
        assert np.abs(got.astype(int) - ref[i].astype(int)).max() <= 1


@pytest.mark.parametrize("shape", [(5, 7, 3), (4, 6), (3, 2, 1)])
def test_encode_png_roundtrip(shape, tmp_path):
    img = np.random.default_rng(0).integers(0, 256, size=shape, dtype=np.uint8)
    path = tmp_path / "x.png"
    path.write_bytes(encode_png(img))
    got = np.asarray(Image.open(path))
    np.testing.assert_array_equal(got, img.reshape(got.shape))


def _decode_png(data: bytes) -> tuple[int, np.ndarray]:
    """(color type, pixels) of an 8-bit PNG with filter type 0 on every
    scanline, decoded with zlib alone (the card has no Pillow)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        assert struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0] == zlib.crc32(tag + body)
        chunks.append((tag, body))
        pos += 12 + length
    assert [t for t, _ in chunks][0] == b"IHDR" and chunks[-1][0] == b"IEND"
    w, h, depth, color_type, *_ = struct.unpack(">IIBBBBB", chunks[0][1])
    channels = {0: 1, 2: 3, 6: 4}[color_type]
    raw = zlib.decompress(b"".join(b for t, b in chunks if t == b"IDAT"))
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + w * channels)
    assert depth == 8 and not rows[:, 0].any()
    return color_type, rows[:, 1:].reshape(h, w, channels)


def test_encode_png_rgba_decodes_with_zlib():
    """(H, W, 4) uint8 is written as color type 6 (RGBA, 8-bit), as PIL
    writes it; every pixel decodes back."""
    img = np.random.default_rng(1).integers(0, 256, size=(5, 7, 4), dtype=np.uint8)
    color_type, got = _decode_png(encode_png(img))
    assert color_type == 6
    np.testing.assert_array_equal(got, img)
    with pytest.raises(ValueError, match="H, W, 4"):
        encode_png(np.zeros((2, 2, 5), np.uint8))


@pytest.fixture
def latent_config(monkeypatch):
    """The smoke topology on 4-channel latents, fp32, 10 classes."""
    cfg = {
        "embedding": configs.SMOKE["embedding"],
        "denoiser": {**configs.SMOKE["denoiser"], "in_channels": 4, "out_channels": 4,
                     "dtype": "float32"},
    }
    monkeypatch.setitem(configs.CONFIGS, "smoke_latent", cfg)
    return "smoke_latent"


def test_generate_writes_rgba_latents(latent_config, tmp_path):
    mean, std = (5.81, 3.25, 0.12, -2.15), (4.17, 4.62, 3.71, 3.28)
    result = generate(str(tmp_path), 3, 8, 2, config=latent_config, device="cpu", num_steps=2,
                      num_classes=10, mean=mean, std=std, keep_samples=True, seed=3)
    assert result["samples"].shape == (3, 8, 8, 4)
    x = torch.from_numpy(result["samples"]).permute(0, 3, 1, 2)
    expected = device_denormalize_uint8(x, mean, std).permute(0, 2, 3, 1).numpy()
    for i in range(3):
        color_type, got = _decode_png((tmp_path / f"{i}.png").read_bytes())
        assert color_type == 6
        np.testing.assert_array_equal(got, expected[i])


@pytest.mark.parametrize("num_classes", [5, 0])
def test_num_classes_must_match_the_model(latent_config, tmp_path, num_classes):
    """--num_classes with the JAX meaning (0 = unconditional) is checked
    against the model's class count before anything is written."""
    with pytest.raises(ValueError, match="num_classes"):
        main(["--config", latent_config, "--output_dir", str(tmp_path), "--num_samples", "1",
              "--batch_size", "1", "--image_size", "8", "--device", "cpu",
              "--num_classes", str(num_classes)])
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize(
    "flag", [["--guidance_scale", "2.0"], ["--S_churn", "1.0"], ["--solver", "dpmpp2m"],
             ["--ckpt_path", "runs/x"], ["--load_ema"]],
)
def test_unported_flags_raise(flag, tmp_path):
    with pytest.raises(NotImplementedError, match="not ported"):
        main(["--output_dir", str(tmp_path), "--num_samples", "1", "--batch_size", "1",
              "--device", "cpu", *flag])
    assert not any(tmp_path.iterdir())


def test_default_device_is_the_card(tmp_path):
    """No silent CPU fallback: without CUDA the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate(str(tmp_path), 1, 16, 1, config="smoke")
