"""The port's generate() on the CPU against the JAX package's solve.

Small model (the smoke topology in fp32, conditional), weights from the JAX
init carried over by ``from_jax_variables`` and written with
``save_weights``; 5 samples at batch 4, so the tail batch is padded. Each PNG
the port writes must decode to JAX's ``device_denormalize_uint8`` of the JAX
Heun solve of the same noise, within 1 level (the fp32 solves differ by about
1e-6 relative; a pixel near a level boundary may truncate either way).
``generate --ckpt_path --load_ema`` from a port checkpoint agrees with the
JAX CLI's from a JAX checkpoint of the same state within the same 1 level.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

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
        "embedding": configs.CONFIGS["smoke"]["embedding"],
        "denoiser": {**configs.CONFIGS["smoke"]["denoiser"], "dtype": "float32"},
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
        "embedding": configs.CONFIGS["smoke"]["embedding"],
        "denoiser": {**configs.CONFIGS["smoke"]["denoiser"], "in_channels": 4, "out_channels": 4,
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


# what each flag below raises without what it needs: tensor-parallel
# sampling needs a world that the model group divides (one process: none
# of 2), the checkpoint flags refuse to run without their checkpoint or
# their guidance scale
_FLAG_ERRORS = {
    "--guide_ckpt_path": (ValueError, "needs --guidance_scale"),
    "--ckpt_step": (ValueError, "need --ckpt_path"),
    "--model_parallel": (ValueError, "1 ranks not divisible by model_parallel=2"),
    "--ckpt_path": (FileNotFoundError, "no checkpoint found"),
    "--load_ema": (ValueError, "need --ckpt_path"),
}


@pytest.mark.parametrize(
    "flag", [["--guide_ckpt_path", "runs/g"], ["--ckpt_step", "3"], ["--model_parallel", "2"],
             ["--ckpt_path", "runs/x"], ["--load_ema"]],
)
def test_unported_flags_raise(flag, tmp_path):
    """The JAX CLI's tensor-parallel flag raises the grid's ``ValueError`` in
    one process (it runs over ranks: ``tests/test_torch_tensor_parallel.py``);
    its checkpoint flags (``tests/test_torch_trainer.py``, the JAX comparison
    below) raise without their checkpoint or scale, before anything is
    written (the sampler and guidance flags: ``tests/test_torch_guidance.py``)."""
    error, match = _FLAG_ERRORS[flag[0]]
    args = ["--output_dir", str(tmp_path / "out"), "--num_samples", "1", "--batch_size", "1",
            "--image_size", "16", "--device", "cpu", *flag]
    if flag[0] != "--ckpt_path":  # a checkpoint carries its config
        args += ["--config", "smoke"]
    with pytest.raises(error, match=match):
        main(args)
    assert not any(tmp_path.iterdir())


def test_default_device_is_the_card(tmp_path):
    """No silent CPU fallback: without CUDA the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate(str(tmp_path), 1, 16, 1, config="smoke")


def _smoke_fp32_model_block() -> dict:
    from tinyedm_tpu.config.registry import load_config

    model = load_config(Path(__file__).resolve().parent.parent / "experiments" / "conf" / "smoke.yaml")["model"]
    model["denoiser"]["dtype"] = "float32"
    return model


def test_generate_from_checkpoint_matches_jax_cli(tmp_path, capsys):
    """``generate --ckpt_path --load_ema`` from a port checkpoint against the
    JAX CLI from a JAX (orbax) checkpoint of the same state (train weights
    and a different EMA tree): the PNGs agree within 1 level. 5 samples at
    batch 8 in both (the JAX CLI rounds its batch up to the 8 CPU devices,
    and the noise stream depends on the batch)."""
    from tinyedm_tpu.config.registry import deinstantiate as jax_deinstantiate
    from tinyedm_tpu.config.registry import instantiate as jax_instantiate
    from tinyedm_tpu.generate import main as jax_main
    from tinyedm_tpu.training.checkpoint import save_checkpoint as jax_save_checkpoint
    from tinyedm_tpu_torch.config.registry import deinstantiate, instantiate
    from tinyedm_tpu_torch.training.checkpoint import save_checkpoint
    from tinyedm_tpu_torch.utils.interop import train_state_from_jax

    from tests._torch_parity import smoke_jax_state

    model = _smoke_fp32_model_block()
    jax_state = smoke_jax_state()
    jax_save_checkpoint(tmp_path / "jax_ckpt", jax_state,
                        config={"model": jax_deinstantiate(jax_instantiate(model)), "seed": 0})
    save_checkpoint(tmp_path / "port_ckpt", train_state_from_jax(jax_state),
                    config={"model": deinstantiate(instantiate(model)), "seed": 0})
    common = ["--load_ema", "--num_samples", "5", "--batch_size", "8", "--image_size", "16",
              "--num_classes", "10", "--num_steps", "3", "--seed", str(SEED)]
    jax_main(["--ckpt_path", str(tmp_path / "jax_ckpt"), "--output_dir", str(tmp_path / "jax"), *common])
    main(["--ckpt_path", str(tmp_path / "port_ckpt"), "--output_dir", str(tmp_path / "port"), "--device", "cpu",
          *common])
    assert capsys.readouterr().out.count("EMA weights loaded.") == 2
    train = tmp_path / "train_weights"
    main(["--ckpt_path", str(tmp_path / "port_ckpt"), "--output_dir", str(train), "--device", "cpu",
          *common[1:]])
    differs = 0
    for i in range(5):
        ours = np.asarray(Image.open(tmp_path / "port" / f"{i}.png").convert("RGB")).astype(int)
        theirs = np.asarray(Image.open(tmp_path / "jax" / f"{i}.png").convert("RGB")).astype(int)
        assert np.abs(ours - theirs).max() <= 1
        differs += np.abs(ours - np.asarray(Image.open(train / f"{i}.png").convert("RGB")).astype(int)).max() > 1
    assert differs == 5  # the EMA tree, not the train weights, was sampled


def test_checkpoint_flags_exclude_weights_and_config(tmp_path):
    for extra in (["--weights", "w.pt"], ["--config", "smoke"]):
        with pytest.raises(ValueError, match="--ckpt_path excludes"):
            main(["--ckpt_path", str(tmp_path), "--output_dir", str(tmp_path / "o"), "--num_samples", "1",
                  "--batch_size", "1", "--device", "cpu", *extra])
    with pytest.raises(ValueError, match="exclude each other"):
        main(["--config", "smoke", "--guide_ckpt_path", str(tmp_path), "--guide_weights", "w.pt",
              "--output_dir", str(tmp_path / "o"), "--num_samples", "1", "--batch_size", "1", "--device", "cpu"])
    assert not (tmp_path / "o").exists()
