"""The port's generate() on the CPU against the JAX package's solve.

Small model (the smoke topology in fp32, conditional), weights from the JAX
init carried over by ``from_jax_variables`` and written with
``save_weights``; 5 samples at batch 4, so the tail batch is padded. Each PNG
the port writes must decode to JAX's ``device_denormalize_uint8`` of the JAX
Heun solve of the same noise, within 1 level (the fp32 solves differ by about
1e-6 relative; a pixel near a level boundary may truncate either way).
"""

from __future__ import annotations

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
from tinyedm_tpu_torch.generate import CIFAR10_MEAN, CIFAR10_STD, generate, main
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
