"""``LatentsGenerateCallback``'s decoded previews against the JAX callback:
the same latents, the same VAE weights (``tests/test_vae_latents.py``'s
synthetic state dict, base 32, mults (1, 2)), one stub trainer each whose
solve returns those latents.

Tolerances: the decode, relative L2 <= 3e-5 (fp32; the reason is in
``tests/test_torch_vae.py``); the clamp and uint8 mapping exact (JAX's
mapping applied to the port's decoded values gives the port's grid bit for
bit); the two grids then within one level. Also the chunked decode, the
load at train start and the raw-latent grid with JAX's warning when no VAE
is found.
"""

from __future__ import annotations

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_vae_latents import _synthetic_diffusers_state_dict
from tinyedm_tpu.data import vae as jvae
from tinyedm_tpu.training import callbacks as jcb
from tinyedm_tpu_torch.data import vae as pvae
from tinyedm_tpu_torch.training import callbacks as pcb

torch.set_num_threads(1)
BASE, MULTS = 32, (1, 2)
MEAN, STD = [5.81, 3.25, 0.12, -2.15], [4.17, 4.62, 3.71, 3.28]
CLASSES, PER_CLASS, SIDE = 3, 2, 16


class _Logger:
    def __init__(self):
        self.images, self.texts = {}, []

    def log_image(self, key, image, step):
        self.images[(key, step)] = np.asarray(image)

    def log_text(self, key, text):
        self.texts.append((key, text))


def _trainer(xT, device=None):
    return SimpleNamespace(epoch=0, use_ema=False, logger=_Logger(), device=device, seed=3,
                           solve=lambda *a, **k: xT,
                           model=SimpleNamespace(num_classes=10, embedding=SimpleNamespace(num_classes=10)))


@pytest.fixture(scope="module")
def setup():
    sd = _synthetic_diffusers_state_dict(base=BASE, mults=MULTS, rng_seed=4)
    jax_vae = jvae.JaxVAE(jvae.AutoencoderKL(base_channels=BASE, channel_mults=MULTS),
                          jvae.convert_torch_vae(sd, channel_mults=MULTS))
    port_vae = pvae.build_vae(pvae.diffusers_state_dict_to_port(sd), "cpu", base_channels=BASE, channel_mults=MULTS)
    # normalized latents as the solver returns them, NHWC
    xT = np.random.default_rng(0).standard_normal((CLASSES * PER_CLASS, SIDE, SIDE, 4)).astype(np.float32) * 0.3
    return jax_vae, port_vae, xT


def _callbacks(value_range):
    common = dict(solver=None, img_shape=(4, SIDE, SIDE), mean=MEAN, std=STD, value_range=value_range,
                  num_samples_per_class=PER_CLASS, num_classes=CLASSES, every_n_epochs=1)
    ours, theirs = pcb.LatentsGenerateCallback(**common), jcb.LatentsGenerateCallback(**common)
    ours.x0 = theirs.x0 = "drawn"  # on_validation_end only checks that train start ran
    return ours, theirs


@pytest.mark.parametrize("value_range", [(0.0, 1.0), (-1.0, 1.0)])
def test_decoded_grid_matches_jax(setup, value_range):
    jax_vae, port_vae, xT = setup
    ours, theirs = _callbacks(value_range)
    ours._vae, theirs._vae = port_vae, jax_vae
    t_ours, t_theirs = _trainer(torch.from_numpy(xT.transpose(0, 3, 1, 2)), "cpu"), _trainer(jnp.asarray(xT))
    ours.on_validation_end(t_ours)
    theirs.on_validation_end(t_theirs)
    grid, want = t_ours.logger.images[("Generated", 0)], t_theirs.logger.images[("Generated", 0)]
    side = 2 * SIDE
    assert grid.shape == want.shape == (PER_CLASS * (side + 2) + 2, CLASSES * (side + 2) + 2, 3)
    # the decode, in float
    lat = xT * np.asarray(STD, np.float32) * 2.0 + np.asarray(MEAN, np.float32)
    decoded = ours.decode(lat, "cpu")
    ref = np.asarray(jax_vae.decode(jnp.asarray(lat)))
    assert np.linalg.norm(decoded - ref) <= 3e-5 * np.linalg.norm(ref)
    assert ours.last_decode_seconds is not None and ours.last_decode_seconds >= 0
    # JAX's clamp and uint8 mapping on the port's decode gives the port's grid
    lo, hi = value_range
    mapped = ((np.clip(decoded, lo, hi) - lo) / max(hi - lo, 1e-12) * 255.0).astype(np.uint8)
    np.testing.assert_array_equal(grid, jcb.make_grid(mapped, nrow=CLASSES))
    assert np.abs(grid.astype(int) - want.astype(int)).max() <= 1
    assert 0 < grid.std()  # the clamp keeps some contrast


def test_chunked_decode_equals_one_batch(setup, monkeypatch):
    _, port_vae, xT = setup
    cb = _callbacks((0.0, 1.0))[0]
    cb._vae = port_vae
    a = cb.decode(xT, "cpu")  # 6 latents: one chunk of DECODE_BATCH
    monkeypatch.setattr(pcb, "DECODE_BATCH", 4)
    b = cb.decode(xT, "cpu")
    assert a.shape == b.shape == (CLASSES * PER_CLASS, 2 * SIDE, 2 * SIDE, 3)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)  # GroupNorm is per sample


def test_train_start_loads_the_vae_on_the_trainers_device(setup, monkeypatch):
    _, port_vae, _ = setup
    seen = []
    monkeypatch.setattr(pcb, "_load_vae", lambda name, device: seen.append((name, device)) or port_vae)
    ours, _ = _callbacks((0.0, 1.0))
    trainer = _trainer(None, "cpu")
    ours.on_train_start(trainer)
    assert ours._vae is port_vae and seen == [("stabilityai/sd-vae-ft-ema", "cpu")] and not trainer.logger.texts
    assert ours.x0.shape == (CLASSES * PER_CLASS, 4, SIDE, SIDE)


def test_no_weights_logs_jaxs_warning_and_the_raw_grid(setup, tmp_path, monkeypatch):
    """No VAE weights anywhere: the JAX callback's warning (with the places
    looked in) and its grid of the first three latent channels, bit for bit."""
    _, _, xT = setup
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "empty"))
    monkeypatch.setattr(pvae, "GOLDEN_STATE_DICT", tmp_path / "none.npz")
    ours, theirs = _callbacks((0.0, 1.0))
    trainer = _trainer(torch.from_numpy(xT.transpose(0, 3, 1, 2)), "cpu")
    ours.on_train_start(trainer)
    assert ours._vae is None
    (key, text), = trainer.logger.texts
    assert key == "warn" and text.startswith("LatentsGenerateCallback: VAE unavailable (no VAE weights for")
    assert text.endswith("; logging latents") and "nothing is downloaded" in text
    ours.on_validation_end(trainer)
    theirs._vae = None
    t_theirs = _trainer(jnp.asarray(xT))
    theirs.on_validation_end(t_theirs)
    np.testing.assert_array_equal(trainer.logger.images[("Generated", 0)], t_theirs.logger.images[("Generated", 0)])
