"""FID of the port against the JAX package: numpy code, PNG reading,
InceptionV3, proxy features, the eval CLI and ``FIDCallback``.

- Every copied numpy function (``compute_stats``,
  ``compute_stats_and_features`` with its reservoir, ``kid_score``,
  ``prdc``, ``frechet_distance``, the stats files, ``fid_between_dirs``)
  equals the JAX one on the same features within 1e-10.
- ``read_png`` equals PIL's ``convert("RGB")`` bit for bit on PIL-written
  grey, grey + alpha, RGB, RGBA and palette files and on files whose rows
  cycle through all five filters; other PNGs and JPEGs raise with the file
  name. ``png_dir_batches``: order, the short tail, early close.
- ``InceptionV3Pool3`` through ``convert_torch_inception`` equals the flax
  module on a He-scaled random state dict with random BatchNorm statistics
  (features' RMS above 0.3, so a relative tolerance means something), in
  both pool semantics, on 2 images at 299 and 2 each resized from 32 and
  512 by ``preprocess_uint8``: fp32 relative L2 <= 1e-4. The resize alone:
  max abs <= 1e-5 against ``jax.image.resize`` up (32 -> 299) and down
  (512 -> 299). The average pools at 17x17 and 8x8 within 1e-6.
- ``.npz`` weight files written by either package load in the other; an
  unstamped file raises ``UnverifiedInceptionWeights``; no weights and no
  ``--features`` raise instead of falling back to proxy features.
- ``proxy_feature_fn`` equals the JAX one within 1e-5 (32x32 RGB, 28x28
  grey, 64x64 RGB).
- ``eval_fid stats`` equals the JAX CLI's on the same CIFAR-format files
  with proxy features (mu and sigma within 1e-5 of their scale);
  ``score`` and ``sweep`` run from a checkpoint; ``FIDCallback`` logs
  ``fid`` and ``kid`` in a smoke-width CPU run and a checkpoint monitor
  selects on ``fid``.
"""

from __future__ import annotations

import json
import pickle
import struct
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tinyedm_tpu.utils import fid as jfid
from tinyedm_tpu.utils import inception as jinc
from tinyedm_tpu_torch import eval_fid, train
from tinyedm_tpu_torch.training.callbacks import read_png
from tinyedm_tpu_torch.utils import fid as pfid
from tinyedm_tpu_torch.utils import inception as pinc

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-10, atol=1e-10)


def _feats(n=300, d=16, seed=0, shift=0.0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32) + shift


# ----------------------------------------------------------------- numpy code
def test_stats_kid_prdc_and_frechet_equal_jax():
    a, b = _feats(), _feats(seed=1, shift=0.3)
    batches = [a[:128], a[128:256], a[256:]]
    for ours, theirs in zip(pfid.compute_stats(batches), jfid.compute_stats(batches)):
        np.testing.assert_allclose(ours, theirs, **TOL)
    for cap in (None, 50):
        ours = pfid.compute_stats_and_features(batches, max_features=cap, seed=3)
        theirs = jfid.compute_stats_and_features(batches, max_features=cap, seed=3)
        for x, y in zip(ours, theirs):
            np.testing.assert_allclose(x, y, **TOL)
        assert len(ours[2]) == (cap or len(a))
    assert abs(pfid.kid_score(a, b, 100, 5) - jfid.kid_score(a, b, 100, 5)) <= 1e-10
    ours, theirs = pfid.prdc(a, b, k=5, chunk=64), jfid.prdc(a, b, k=5, chunk=64)
    assert ours.keys() == theirs.keys() and all(abs(ours[k] - theirs[k]) <= 1e-10 for k in ours)
    mu1, s1 = pfid.compute_stats(a)
    mu2, s2 = pfid.compute_stats(b)
    assert abs(pfid.frechet_distance(mu1, s1, mu2, s2) - jfid.frechet_distance(mu1, s1, mu2, s2)) <= 1e-10
    for fn in (pfid.compute_stats, jfid.compute_stats):
        with pytest.raises(ValueError, match="at least 2"):
            fn(a[:1])


def test_stats_files_cross_load(tmp_path):
    a = _feats()
    mu, sigma, rows = pfid.compute_stats_and_features(a, max_features=20)
    for save, load, load_features, name in ((pfid.save_stats, jfid.load_stats, jfid.load_features, "p"),
                                            (jfid.save_stats, pfid.load_stats, pfid.load_features, "j")):
        save(tmp_path / f"{name}.npz", mu, sigma, features=rows)
        save(tmp_path / f"{name}_bare.npz", mu, sigma)
        for x, y in zip(load(tmp_path / f"{name}.npz"), (mu, sigma)):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(load_features(tmp_path / f"{name}.npz"), rows)
        assert load_features(tmp_path / f"{name}_bare.npz") is None


def test_fid_between_dirs_equals_jax(tmp_path):
    sys.path.insert(0, str(ROOT))
    from tests import fake_features

    rng = np.random.default_rng(0)
    for name, shift in (("a", 0), ("b", 40)):
        (tmp_path / name).mkdir()
        for i in range(24):
            img = np.clip(rng.integers(0, 200, (16, 16, 3)) + shift, 0, 255).astype(np.uint8)
            Image.fromarray(img).save(tmp_path / name / f"{i:03d}.png")
    fn = fake_features.feature_fn()
    ours = pfid.fid_between_dirs(tmp_path / "a", tmp_path / "b", fn, batch_size=5)
    theirs = jfid.fid_between_dirs(tmp_path / "a", tmp_path / "b", fn, batch_size=5)
    assert abs(ours - theirs) <= 1e-10 * max(1.0, theirs) and ours > 0
    mu, sigma = pfid.compute_stats(pfid.png_dir_batches(tmp_path / "b", 7), fn)
    pfid.save_stats(tmp_path / "b.npz", mu, sigma)
    assert abs(pfid.fid_between_dirs(tmp_path / "a", tmp_path / "b.npz", fn) - theirs) <= 1e-10 * max(1.0, theirs)


# ------------------------------------------------------------------------ PNG
def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _png_cycling_filters(pixels: np.ndarray, color: int, palette=None) -> bytes:
    """An 8-bit PNG whose row y is written with filter y % 5."""
    h, w = pixels.shape[:2]
    bpp = 1 if pixels.ndim == 2 else pixels.shape[2]
    rows = pixels.reshape(h, -1).astype(np.int64)
    prev = np.zeros(rows.shape[1], np.int64)
    raw = b""
    for y in range(h):
        cur = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        pred = [0, left, prev, (left + prev) // 2, _paeth(left, prev, upleft)][y % 5]
        raw += bytes([y % 5]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
    if palette is not None:
        body += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return b"\x89PNG\r\n\x1a\n" + body + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def _structured(h, w, c, seed=0):
    """Gradients plus noise: rows on which PIL's adaptive filtering picks
    different filters."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (3 * yy + 5 * xx)[..., None] + 40 * np.arange(c)
    return ((base + rng.integers(0, 30, (h, w, c))) % 256).astype(np.uint8)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_read_png_equals_pil(mode, tmp_path):
    img = _structured(23, 37, 4)
    if mode == "P":
        pil = Image.fromarray(img[..., :3]).quantize(64)  # 64 colors: an 8-bit palette
    else:
        pil = Image.fromarray(img[..., : len(mode)].squeeze())
    pil.save(tmp_path / "pil.png")
    want = np.asarray(Image.open(tmp_path / "pil.png").convert("RGB"))
    got = read_png(tmp_path / "pil.png")
    assert got.dtype == np.uint8 and got.shape == (23, 37, 3) and np.array_equal(got, want)
    # every filter, written by hand
    color = {"L": 0, "LA": 4, "RGB": 2, "RGBA": 6, "P": 3}[mode]
    if mode == "P":
        indices = np.asarray(pil)
        pal = np.asarray(pil.getpalette()[: 3 * 64]).reshape(-1, 3)
        data = _png_cycling_filters(indices, color, pal)
    else:
        data = _png_cycling_filters(img[..., : len(mode)].squeeze(), color)
    (tmp_path / "cycled.png").write_bytes(data)
    want = np.asarray(Image.open(tmp_path / "cycled.png").convert("RGB"))
    assert np.array_equal(read_png(tmp_path / "cycled.png"), want)


def test_read_png_refuses_what_it_does_not_read(tmp_path):
    img = _structured(8, 8, 3)
    Image.fromarray(img).quantize(8).save(tmp_path / "p4.png")  # 8 colors: PIL writes 4-bit indices
    Image.fromarray(img.astype(np.uint16)[..., 0] * 200).save(tmp_path / "grey16.png")
    Image.fromarray(img).save(tmp_path / "photo.jpg")
    interlaced = bytearray(_png_cycling_filters(img, 2))
    interlaced[28] = 1  # IHDR's interlace byte
    (tmp_path / "adam7.png").write_bytes(bytes(interlaced))
    (tmp_path / "cut.png").write_bytes(_png_cycling_filters(img, 2)[:60])
    for name in ("p4.png", "grey16.png", "photo.jpg", "adam7.png", "cut.png"):
        with pytest.raises(ValueError, match=name):
            read_png(tmp_path / name)


def test_png_dir_batches_order_tail_early_close_and_jpg(tmp_path):
    for i in range(10):
        Image.fromarray(np.full((4, 4, 3), i * 20, np.uint8)).save(tmp_path / f"{i:03d}.png")
    batches = list(pfid.png_dir_batches(tmp_path, batch_size=4, workers=3))
    assert [b.shape for b in batches] == [(4, 4, 4, 3)] * 2 + [(2, 4, 4, 3)]
    assert [int(im[0, 0, 0]) for im in np.concatenate(batches)] == [i * 20 for i in range(10)]
    for ours, theirs in zip(batches, jfid.png_dir_batches(tmp_path, batch_size=4)):
        assert np.array_equal(ours, theirs)
    gen = pfid.png_dir_batches(tmp_path, batch_size=2, prefetch=1)
    assert next(gen).shape == (2, 4, 4, 3)
    gen.close()
    empty = tmp_path / "empty"
    empty.mkdir()
    assert list(pfid.png_dir_batches(empty)) == []
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(tmp_path / "zz.jpg")
    with pytest.raises(ValueError, match="zz.jpg"):
        list(pfid.png_dir_batches(tmp_path, batch_size=4))


# ------------------------------------------------------------------ Inception
@pytest.fixture(scope="module")
def weights():
    sd = pinc.random_torch_state_dict(0)
    return sd, jinc.convert_torch_inception(sd), pinc.convert_torch_inception(sd)


@pytest.mark.parametrize("tf_avgpool", [False, True])
def test_inception_equals_flax(weights, tf_avgpool):
    _, jparams, pparams = weights
    rng = np.random.default_rng(1)
    sources = [rng.integers(0, 256, (2, side, side, 3), dtype=np.uint8) for side in (299, 32, 512)]
    x_jax = jnp.concatenate([jinc.preprocess_uint8(s) for s in sources])
    theirs = np.asarray(jax.jit(lambda x: jinc.InceptionV3Pool3(tf_avgpool=tf_avgpool).apply(
        {"params": jparams}, x))(x_jax))
    model = pinc.InceptionV3Pool3(tf_avgpool)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in pparams.items()})
    with torch.inference_mode():
        ours = model(torch.cat([pinc.preprocess_uint8(s) for s in sources])).numpy()
    assert ours.shape == (6, 2048)
    for i, side in enumerate((299, 32, 512)):
        a, b = ours[2 * i : 2 * i + 2], theirs[2 * i : 2 * i + 2]
        assert np.sqrt(np.mean(b**2)) > 0.3, side  # features of scale, not vanished
        assert np.linalg.norm(a - b) / np.linalg.norm(b) <= 1e-4, side


@pytest.mark.parametrize("side", [32, 512])
def test_preprocess_resize_equals_jax(side):
    imgs = np.random.default_rng(side).integers(0, 256, (2, side, side, 3), dtype=np.uint8)
    theirs = np.asarray(jinc.preprocess_uint8(imgs)).transpose(0, 3, 1, 2)
    ours = pinc.preprocess_uint8(imgs).numpy()
    assert ours.shape == (2, 3, 299, 299) and np.abs(ours - theirs).max() <= 1e-5
    grey = imgs[..., 0]  # (N, H, W) grey, repeated to 3 channels
    np.testing.assert_allclose(pinc.preprocess_uint8(grey).numpy(),
                               np.asarray(jinc.preprocess_uint8(grey)).transpose(0, 3, 1, 2), rtol=0, atol=1e-5)


@pytest.mark.parametrize("side", [17, 8])
@pytest.mark.parametrize("tf_avgpool", [False, True])
def test_average_pool_semantics(side, tf_avgpool):
    x = np.random.default_rng(side).standard_normal((2, side, side, 5)).astype(np.float32)
    theirs = np.asarray(jinc._avgpool3(jnp.asarray(x), not tf_avgpool))
    ours = pinc._avgpool3(torch.from_numpy(x).permute(0, 3, 1, 2), tf_avgpool).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)
    corner = x[0, :2, :2, 0].sum() / (4 if tf_avgpool else 9)
    assert abs(ours[0, 0, 0, 0] - corner) <= 1e-6


def test_weight_files_load_in_both_packages(weights, tmp_path):
    sd, jparams, pparams = weights
    pinc.save_converted(pparams, tmp_path / "port.npz", tf_avgpool=True, pretrained=False)
    loaded, tf, pre = jinc.load_converted(tmp_path / "port.npz")
    assert (tf, pre) == (True, False)
    assert jax.tree_util.tree_structure(loaded) == jax.tree_util.tree_structure(jparams)
    for x, y in zip(jax.tree_util.tree_leaves(loaded), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(x, y)
    jinc.save_converted(jparams, tmp_path / "jax.npz", tf_avgpool=False, pretrained=True)
    loaded, tf, pre = pinc.load_converted(tmp_path / "jax.npz")
    assert (tf, pre) == (False, True) and loaded.keys() == pparams.keys()
    for k, v in pparams.items():
        assert loaded[k].flags["C_CONTIGUOUS"] and np.array_equal(loaded[k], v), k


def test_unverified_weights_and_missing_weights_fail_hard(weights, tmp_path, monkeypatch):
    _, _, pparams = weights
    path = tmp_path / "rehearsal.npz"
    pinc.save_converted(pparams, path, pretrained=False)
    with pytest.raises(pinc.UnverifiedInceptionWeights, match="not stamped pretrained"):
        pinc.inception_feature_fn(path, device="cpu")
    monkeypatch.setattr(pinc, "DEFAULT_WEIGHTS", path)
    with pytest.raises(pinc.UnverifiedInceptionWeights):
        pfid.resolve_feature_fn("inception", device="cpu")
    fn, kind = pfid.resolve_feature_fn("inception-unverified", device="cpu")
    imgs = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    assert kind == "inception-unverified" and fn(imgs).shape == (3, 2048)
    assert np.array_equal(fn.gather(fn.dispatch(imgs)), fn(imgs))
    monkeypatch.setattr(pinc, "DEFAULT_WEIGHTS", tmp_path / "missing.npz")
    with pytest.raises(FileNotFoundError, match="--features proxy"):
        pfid.resolve_feature_fn(None, device="cpu")
    with pytest.raises(FileNotFoundError, match="convert_torch_inception"):
        pfid.resolve_feature_fn("inception", device="cpu")
    if not torch.cuda.is_available():  # the card by default, never a quiet CPU fallback
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pfid.resolve_feature_fn("proxy")


@pytest.mark.parametrize("shape", [(5, 32, 32, 3), (5, 28, 28), (5, 64, 64, 3)])
def test_proxy_features_equal_jax(shape):
    imgs = np.random.default_rng(len(shape)).integers(0, 256, shape, dtype=np.uint8)
    ours = pfid.proxy_features(device="cpu")(imgs)
    theirs = np.asarray(jfid.proxy_features()(imgs))
    assert ours.shape == theirs.shape == (5, 256) and np.abs(ours - theirs).max() <= 1e-5


# -------------------------------------------------------------- CLI, callback
def _write_cifar(directory: Path, n: int = 40, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    base = directory / "cifar-10-batches-py"
    base.mkdir(parents=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        batch = {b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8), b"labels": list(rng.integers(0, 10, n))}
        with open(base / name, "wb") as f:
            pickle.dump(batch, f)


def test_eval_fid_stats_equals_the_jax_cli(tmp_path):
    sys.path.insert(0, str(ROOT / "experiments"))
    import eval_fid as jax_eval_fid

    _write_cifar(tmp_path / "cifar10")
    common = ["--data-dir", str(tmp_path / "cifar10"), "--features", "proxy", "--batch-size", "32",
              "--kid-features", "64"]
    eval_fid.main(["stats", "--out", str(tmp_path / "port.npz"), "--device", "cpu", *common])
    jax_eval_fid.main(["stats", "--out", str(tmp_path / "jax.npz"), *common])
    ours, theirs = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert ours.files == theirs.files == ["mu", "sigma", "features"]
    for k in ours.files:
        assert ours[k].shape == theirs[k].shape
        assert np.abs(ours[k] - theirs[k]).max() <= 1e-5 * max(1.0, np.abs(theirs[k]).max()), k


@pytest.fixture(scope="module")
def fid_run(tmp_path_factory):
    """The smoke config through the CLI with FIDCallback on proxy features
    (KID too), every epoch, and the checkpoint monitor on fid."""
    tmp = tmp_path_factory.mktemp("fidcb")
    imgs = np.random.default_rng(0).integers(0, 256, (64, 16, 16, 3), dtype=np.uint8)
    mu, sigma, rows = pfid.compute_stats_and_features(imgs, pfid.proxy_features(device="cpu"), max_features=64)
    pfid.save_stats(tmp / "stats.npz", mu, sigma, features=rows)
    cb = "callbacks.fid_callback"
    run = tmp / "run"
    trainer = train.main([
        "--config-name=smoke", "--device", "cpu", f"trainer.out_dir={run}", "trainer.max_epochs=2",
        "datamodule.num_samples=64", "callbacks.checkpoint_callback.monitor=fid",
        f"{cb}._target_=tinyedm_tpu.training.callbacks.FIDCallback", f"{cb}.img_shape=[3, 16, 16]",
        f"{cb}.stats_path={tmp / 'stats.npz'}", f"{cb}.num_samples=24", f"{cb}.batch_size=16",
        f"{cb}.every_n_epochs=1", f"{cb}.features=proxy", f"{cb}.kid=True", f"{cb}.kid_subset_size=16",
        f"{cb}.kid_subsets=2", f"{cb}.solver._target_=tinyedm_tpu.diffusion.solver.DeterministicSolver",
        f"{cb}.solver.num_steps=2"])
    return tmp, run, trainer


def test_fid_callback_logs_fid_and_kid(fid_run):
    _, run, trainer = fid_run
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    fid_rows = [r for r in rows if "fid" in r]
    assert [r["step"] for r in fid_rows] == [4, 8]
    assert all(np.isfinite(r["fid"]) and r["fid"] > 0 and np.isfinite(r["kid"]) for r in fid_rows)
    for step in (4, 8):
        metrics = json.loads((run / "checkpoints" / str(step) / "metrics.json").read_text())
        assert metrics["fid"] == next(r["fid"] for r in fid_rows if r["step"] == step)
    assert trainer.ckpt.monitor == "fid"


def test_fid_callback_checks_its_inputs_at_train_start(fid_run, tmp_path):
    from tinyedm_tpu_torch.diffusion.solver import DeterministicSolver
    from tinyedm_tpu_torch.training.callbacks import FIDCallback

    tmp, _, trainer = fid_run
    bare = tmp_path / "bare.npz"
    pfid.save_stats(bare, *pfid.compute_stats(_feats(d=256)))
    cb = FIDCallback(DeterministicSolver(num_steps=2), (3, 16, 16), str(bare), features="proxy", kid=True)
    with pytest.raises(ValueError, match="no stored feature rows"):
        cb.on_train_start(trainer)
    with pytest.raises(FileNotFoundError):
        FIDCallback(DeterministicSolver(num_steps=2), (3, 16, 16), str(tmp_path / "none.npz"),
                    features="proxy").on_train_start(trainer)


def test_eval_fid_score_and_sweep_from_a_checkpoint(fid_run, capsys):
    tmp, run, _ = fid_run
    common = ["--ckpt_path", str(run / "checkpoints"), "--stats", str(tmp / "stats.npz"), "--num_samples", "20",
              "--batch_size", "16", "--image_size", "16", "--num_steps", "2", "--features", "proxy", "--device",
              "cpu", "--load_ema"]
    res = eval_fid.main(["score", *common, "--sample_dir", str(tmp / "samples"), "--kid", "--kid_subset_size", "16",
                         "--kid_subsets", "2", "--prdc"])
    out = capsys.readouterr().out
    assert "FID[proxy]:" in out and "KID[proxy]:" in out and "PRDC[proxy]:" in out
    assert len(list((tmp / "samples").glob("*.png"))) == 20 and np.isfinite(res["fid"])
    again = eval_fid.main(["score", *common, "--sample_dir", str(tmp / "samples"), "--skip_generate"])
    assert again["fid"] == res["fid"]
    rows = eval_fid.main(["sweep", *common, "--sample_dir", str(tmp / "sweep"), "--posthoc_sigma_rels", "0.1",
                          "0.13"])
    assert [r[0] for r in rows] == ["sigma_rel 0.1", "sigma_rel 0.13"] and "BEST:" in capsys.readouterr().out
    rows = eval_fid.main(["sweep", *common, "--sample_dir", str(tmp / "steps")])
    assert [r[0].split()[1] for r in rows] == ["4", "8"]
    with pytest.raises(SystemExit, match="needs at least one value"):
        eval_fid.main(["sweep", *common, "--posthoc_sigma_rels"])
