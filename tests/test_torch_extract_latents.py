"""The port's latent extraction (``tinyedm_tpu_torch/data/extract_latents.py``)
against the JAX package's ``extract`` on the same PNG folder and the same
VAE weights (``tests/test_vae_latents.py``'s synthetic state dict, base 32,
mults (1, 2): one downsampling, latents at half the image side).

The port's VAE is fed JAX's noise (the key split per batch as the JAX
``extract`` splits it), so the comparison covers the whole pipeline: the
file list and labels (equal), the crops fed to the VAE (equal, bit for bit),
the latents (relative L2 <= 1e-5, fp32), the HWC layout the readers take.
Also: the bounded write queue, JPEGs on the CPU, the CLI with the VAE found
by name.
"""

from __future__ import annotations

import contextlib
import io
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_vae_latents import _synthetic_diffusers_state_dict
from tinyedm_tpu.data import extract_latents as jex
from tinyedm_tpu.data import vae as jvae
from tinyedm_tpu_torch.data import extract_latents as pex
from tinyedm_tpu_torch.data import vae as pvae

torch.set_num_threads(1)
BASE, MULTS = 32, (1, 2)


def _folder(root, seed: int = 0):
    """Two classes of PNGs in every mode PIL reads, at sizes that take the
    BOX halvings (short side >= 128 at image_size 64) and plain bicubic."""
    rng = np.random.default_rng(seed)
    specs = [("cat", "a", "RGB", 150, 131), ("cat", "b", "L", 70, 90), ("cat", "c", "RGBA", 64, 64),
             ("dog", "d", "P", 200, 260), ("dog", "e", "LA", 45, 80)]
    for cls, name, mode, h, w in specs:
        (root / cls).mkdir(parents=True, exist_ok=True)
        yy, xx = np.mgrid[0:h, 0:w]
        img = ((3 * yy + 5 * xx)[..., None] + 60 * np.arange(4) + rng.integers(0, 50, (h, w, 4))) % 256
        img = img.astype(np.uint8)
        if mode == "P":
            im = Image.fromarray(img[..., :3]).quantize(150)
        elif mode in ("L", "LA"):
            im = Image.fromarray(img[..., :len(mode)].squeeze(-1) if mode == "L" else img[..., :2], mode)
        else:
            im = Image.fromarray(img[..., :len(mode)], mode)
        im.save(root / cls / f"{name}.png")
    return len(specs)


class _JaxRecorder(jvae.JaxVAE):
    """The JAX VAE, recording the images each encode is given."""

    def __post_init__(self):
        super().__post_init__()
        self.inputs = []

    def encode(self, images, rng):
        self.inputs.append(np.asarray(images))
        return super().encode(images, rng)


class _PortWithJaxNoise:
    """The port's VAE, fed the noise the JAX ``extract`` draws: its key
    split once per batch from PRNGKey(seed)."""

    def __init__(self, vae, seed: int):
        self.vae, self.rng, self.inputs = vae, jax.random.PRNGKey(seed), []

    def encode_sample(self, x, generator=None):
        self.rng, sub = jax.random.split(self.rng)
        self.inputs.append(x.permute(0, 2, 3, 1).numpy())
        b, _, h, w = x.shape
        noise = jax.random.normal(sub, (b, h // 2, w // 2, 4), jnp.float32)  # encode_sample's draw
        return self.vae.encode_sample(x, noise=torch.from_numpy(np.array(noise).transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def vaes():
    sd = _synthetic_diffusers_state_dict(base=BASE, mults=MULTS, rng_seed=2)
    params = jvae.convert_torch_vae(sd, channel_mults=MULTS)
    jax_vae = _JaxRecorder(jvae.AutoencoderKL(base_channels=BASE, channel_mults=MULTS), params)
    port = pvae.build_vae(pvae.diffusers_state_dict_to_port(sd), "cpu", base_channels=BASE, channel_mults=MULTS)
    return jax_vae, port


@pytest.mark.parametrize("flip,batch_size", [(True, 4), (False, 3)])
def test_extract_matches_jax(vaes, tmp_path, flip, batch_size):
    jax_vae, port_vae = vaes
    jax_vae.inputs.clear()
    n_files = _folder(tmp_path / "data")
    kw = dict(image_size=64, batch_size=batch_size, seed=11, flip=flip)
    n_jax = jex.extract(str(tmp_path / "data"), str(tmp_path / "jax"), vae=jax_vae, **kw)
    port = _PortWithJaxNoise(port_vae, seed=11)
    timings = {}
    n = pex.extract(str(tmp_path / "data"), str(tmp_path / "port"), vae=port, device="cpu", timings=timings,
                    **kw)
    assert n == n_jax == n_files * (2 if flip else 1)
    assert set(timings) == {"decode", "crop", "encode", "write", "total"} and all(v >= 0 for v in timings.values())
    # the crops fed to the VAE, batch by batch (the tail padded alike)
    assert len(port.inputs) == len(jax_vae.inputs) == -(-n // batch_size)
    for a, b in zip(port.inputs, jax_vae.inputs):
        np.testing.assert_array_equal(a, b)
    for sub in ("latents", "labels"):
        names = sorted(p.name for p in (tmp_path / "port" / sub).iterdir())
        assert names == sorted(p.name for p in (tmp_path / "jax" / sub).iterdir())
        assert names == sorted(f"{i}.npy" for i in range(n))
    for i in range(n):
        ours, theirs = (np.load(tmp_path / d / "latents" / f"{i}.npy") for d in ("port", "jax"))
        assert ours.dtype == np.float32 and ours.shape == theirs.shape == (32, 32, 4)
        assert np.linalg.norm(ours - theirs) <= 1e-5 * np.linalg.norm(theirs), i
        assert np.load(tmp_path / "port" / "labels" / f"{i}.npy") == np.load(tmp_path / "jax" / "labels" / f"{i}.npy")


def test_extracted_latents_feed_both_readers(vaes, tmp_path):
    """The HWC files load in the JAX and the port ImageNet latent modules
    unchanged, as the same arrays."""
    from tinyedm_tpu.data.datamodules import ImageNetLatentsDataModule as JaxLatents
    from tinyedm_tpu_torch.data.datamodules import ImageNetLatentsDataModule as PortLatents

    _, port_vae = vaes
    _folder(tmp_path / "data")
    pex.extract(str(tmp_path / "data"), str(tmp_path / "out"), image_size=64, batch_size=4,
                vae=_PortWithJaxNoise(port_vae, 0), device="cpu")
    mods = [m(batch_size=2, data_dir=str(tmp_path / "out"), image_size=32) for m in (JaxLatents, PortLatents)]
    for m in mods:
        m.setup()
    np.testing.assert_array_equal(mods[0].train_images, mods[1].train_images)
    want = np.stack([np.load(tmp_path / "out" / "latents" / f"{i}.npy") for i in range(10)])
    assert mods[1].train_images.shape[1:] == (32, 32, 4)
    np.testing.assert_array_equal(np.concatenate([mods[1].train_images, mods[1].val_images]), want)


def test_the_write_queue_is_bounded(tmp_path, monkeypatch):
    """``put`` blocks while ``depth`` writes wait; a writer's error comes
    back from ``close``."""
    release = threading.Event()
    saved = []

    def slow_save(path, array):
        release.wait(10)
        saved.append(path)

    monkeypatch.setattr(pex.np, "save", slow_save)
    writer = pex.BoundedWriter(threads=1, depth=2)
    done = []
    putter = threading.Thread(target=lambda: ([writer.put(tmp_path / f"{i}", None) for i in range(6)],
                                              done.append(True)))
    putter.start()
    time.sleep(0.3)
    assert not done and writer._queue.qsize() <= 2  # one in the writer's hands, two queued, the putter waits
    release.set()
    putter.join(10)
    assert not putter.is_alive() and done
    writer.close()
    assert len(saved) == 6

    def failing_save(path, array):
        raise OSError(f"disk full writing {path}")

    monkeypatch.setattr(pex.np, "save", failing_save)
    writer = pex.BoundedWriter(threads=2, depth=4)
    writer.put(tmp_path / "x", None)
    with pytest.raises(OSError, match="disk full"):
        writer.close()


def test_jpeg_on_the_cpu_raises_naming_the_file(vaes, tmp_path):
    _, port_vae = vaes
    _folder(tmp_path / "data")
    Image.fromarray(np.zeros((80, 80, 3), np.uint8)).save(tmp_path / "data" / "cat" / "photo.jpg")
    with pytest.raises(ValueError, match="photo.jpg.*no JPEG decoder"):
        pex.extract(str(tmp_path / "data"), str(tmp_path / "out"), image_size=64, batch_size=4,
                    vae=_PortWithJaxNoise(port_vae, 0), device="cpu")
    (tmp_path / "data" / "cat" / "photo.jpg").unlink()
    (tmp_path / "data" / "dog" / "x.bmp").write_bytes(b"BM" + b"\0" * 64)
    with pytest.raises(ValueError, match="x.bmp"):
        pex.extract(str(tmp_path / "data"), str(tmp_path / "out2"), image_size=64, batch_size=4,
                    vae=_PortWithJaxNoise(port_vae, 0), device="cpu")


def test_cli_finds_the_vae_by_name(tmp_path, monkeypatch):
    """``python -m tinyedm_tpu_torch.data.extract_latents`` with the JAX
    CLI's flags and ``--device cpu``: sd-vae-ft-ema's width, seeded weights
    in a fake Hugging Face cache, 64x64 crops -> 8x8x4 latents."""
    from tinyedm_tpu_torch.utils.safetensors import save_safetensors

    snap = tmp_path / "hub" / "models--stabilityai--sd-vae-ft-ema" / "snapshots" / "0"
    snap.mkdir(parents=True)
    save_safetensors(pvae.random_state_dict(0), snap / "diffusion_pytorch_model.safetensors")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    for cls in ("a", "b"):
        (tmp_path / "data" / cls).mkdir(parents=True)
        Image.fromarray(np.full((70, 90, 3), 40 if cls == "a" else 200, np.uint8)).save(tmp_path / "data" / cls / "x.png")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        n = pex.main(["--data-dir", str(tmp_path / "data"), "--out-dir", str(tmp_path / "out"), "--image-size",
                      "64", "--batch-size", "3", "--seed", "1", "--device", "cpu"])
    assert n == 4 and "wrote 4 latents" in out.getvalue() and "img/s" in out.getvalue()
    lat = np.load(tmp_path / "out" / "latents" / "3.npy")
    assert lat.shape == (8, 8, 4) and lat.dtype == np.float32 and np.isfinite(lat).all()
    assert [int(np.load(tmp_path / "out" / "labels" / f"{i}.npy")) for i in range(4)] == [0, 1, 0, 1]
    with pytest.raises(SystemExit):
        pex.main(["--data-dir", "x", "--out-dir", "y", "--vae", "some/other-vae"])
