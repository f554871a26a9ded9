"""The port's data modules against the JAX package's, on synthetic files.

MNIST (plain and ``.gz`` IDX files, in ``data_dir`` and in the torchvision
``MNIST/raw`` layout), CIFAR-10 (python pickle batches) and ImageNet latents
(per-sample ``.npy``, single-directory and train/val layouts) are written as
``tests/test_datamodules.py`` writes them. For two epochs, ``train_batches``
(with and without ``skip``), ``train_batches_raw`` and ``val_batches`` of
each port module equal the JAX module's bit for bit (exact equality of the
arrays and their dtypes), and so do ``steps_per_epoch``, ``num_classes``,
``denormalize`` and the synthetic modules. A ``.latpack`` store beside the
``.npy`` directories loads bit-equal to the JAX module's (two raise
``ValueError``, in both). A real resize raises ``NotImplementedError`` in
the port.
"""

from __future__ import annotations

import gzip
import pickle
import struct

import numpy as np
import pytest

from tinyedm_tpu.data import datamodules as jdm
from tinyedm_tpu_torch.data import datamodules as pdm

EPOCHS = 2


def _write_idx(path, array, gz=False):
    opener = gzip.open if gz else open
    with opener(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, 0x08, array.ndim))
        f.write(struct.pack(">" + "I" * array.ndim, *array.shape))
        f.write(np.ascontiguousarray(array, np.uint8).tobytes())


@pytest.fixture
def mnist_dir(tmp_path, request):
    rng = np.random.default_rng(0)
    d = tmp_path / "mnist"
    raw = d / "MNIST" / "raw" if request.param == "raw" else d
    raw.mkdir(parents=True)
    gz = request.param == "gz"
    _write_idx(raw / "train-images-idx3-ubyte", rng.integers(0, 256, (40, 28, 28)))
    _write_idx(raw / "train-labels-idx1-ubyte", rng.integers(0, 10, 40))
    _write_idx(raw / f"t10k-images-idx3-ubyte{'.gz' if gz else ''}", rng.integers(0, 256, (19, 28, 28)), gz=gz)
    _write_idx(raw / f"t10k-labels-idx1-ubyte{'.gz' if gz else ''}", rng.integers(0, 10, 19), gz=gz)
    return d


@pytest.fixture
def cifar_dir(tmp_path):
    rng = np.random.default_rng(1)
    d = tmp_path / "cifar10" / "cifar-10-batches-py"
    d.mkdir(parents=True)
    for name, n in [(f"data_batch_{i}", 9) for i in range(1, 6)] + [("test_batch", 13)]:
        batch = {b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                 b"labels": rng.integers(0, 10, n).tolist()}
        with open(d / name, "wb") as f:
            pickle.dump(batch, f)
    return tmp_path / "cifar10"


def _write_latents(root, n, rng):
    (root / "latents").mkdir(parents=True)
    (root / "labels").mkdir()
    for i in range(n):
        np.save(root / "latents" / f"{i}.npy", rng.standard_normal((4, 8, 8)).astype(np.float32))
        np.save(root / "labels" / f"{i}.npy", np.asarray(rng.integers(0, 1000)))


@pytest.fixture
def latents_dir(tmp_path, request):
    rng = np.random.default_rng(2)
    d = tmp_path / "latents"
    if request.param == "split":
        _write_latents(d / "train", 30, rng)
        _write_latents(d / "val", 7, rng)
    else:
        _write_latents(d, 37, rng)
    return d


def _assert_same_stream(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) and a
    for xa, xb in zip(a, b):
        assert len(xa) == len(xb)
        for ya, yb in zip(xa, xb):
            if ya is None or yb is None:
                assert ya is None and yb is None
                continue
            assert ya.dtype == yb.dtype and ya.shape == yb.shape
            np.testing.assert_array_equal(ya, yb)


def _assert_modules_equal(ours, theirs):
    for m in (ours, theirs):
        m.prepare_data()
        m.setup("fit")
    np.testing.assert_array_equal(ours.train_images, theirs.train_images)
    np.testing.assert_array_equal(ours.val_labels, theirs.val_labels)
    assert ours.steps_per_epoch() == theirs.steps_per_epoch()
    assert ours.steps_per_epoch(drop_last=False) == theirs.steps_per_epoch(drop_last=False)
    assert ours.num_classes == theirs.num_classes
    assert (ours.raw_uint8, ours.raw_flip) == (theirs.raw_uint8, theirs.raw_flip)
    for epoch in range(EPOCHS):
        for kw in ({}, {"skip": 2}, {"drop_last": False}):
            _assert_same_stream(ours.train_batches(epoch, **kw), theirs.train_batches(epoch, **kw))
            if ours.raw_uint8:
                _assert_same_stream(ours.train_batches_raw(epoch, **kw), theirs.train_batches_raw(epoch, **kw))
    _assert_same_stream(ours.val_batches(), theirs.val_batches())
    x = next(ours.train_batches(0))[0]
    np.testing.assert_array_equal(ours.denormalize(x), theirs.denormalize(x))


@pytest.mark.parametrize("mnist_dir", ["plain", "gz", "raw"], indirect=True)
def test_mnist_matches_jax(mnist_dir):
    kw = dict(batch_size=8, num_workers=2, image_size=28, data_dir=str(mnist_dir), seed=5)
    _assert_modules_equal(pdm.MNISTDataModule(**kw), jdm.MNISTDataModule(**kw))


def test_cifar10_matches_jax(cifar_dir):
    kw = dict(batch_size=8, num_workers=8, image_size=32, data_dir=str(cifar_dir), seed=3)
    ours = pdm.CIFAR10DataModule(**kw)
    _assert_modules_equal(ours, jdm.CIFAR10DataModule(**kw))
    # the flips happen: raw flags set, and a flipped sample is the mirror image
    u8, flags, _ = next(ours.train_batches_raw(0))
    host = next(ours.train_batches(0))[0]
    assert flags.any() and not flags.all()
    i = int(np.argmax(flags))
    np.testing.assert_array_equal(host[i], ours._normalize(u8[i][:, ::-1]))
    # the val tail: 13 samples in batches of 8
    assert [len(b[0]) for b in ours.val_batches()] == [8, 5]


@pytest.mark.parametrize("latents_dir", ["single", "split"], indirect=True)
def test_imagenet_latents_match_jax(latents_dir):
    kw = dict(batch_size=4, num_workers=2, image_size=8, data_dir=str(latents_dir), seed=1)
    ours = pdm.ImageNetLatentsDataModule(**kw)
    _assert_modules_equal(ours, jdm.ImageNetLatentsDataModule(**kw))
    assert ours.train_images.shape[1:] == (8, 8, 4) and ours.num_classes == 1000


def test_synthetic_modules_match_jax():
    kw = dict(batch_size=16, image_size=8, num_channels=1, num_samples=70, seed=3)
    _assert_modules_equal(pdm.SyntheticDataModule(**kw), jdm.SyntheticDataModule(**kw))
    kw = dict(batch_size=4, image_size=8, num_samples=10, num_classes=10, num_channels=3, seed=2)
    _assert_same_stream(pdm.RandomNoiseDataModule(**kw).predict_batches(),
                        jdm.RandomNoiseDataModule(**kw).predict_batches())


def test_resize_and_packed_latents_are_not_ported(mnist_dir_plain):
    """The resize to another image_size, once not ported, now equals the JAX
    module's PIL BILINEAR resize bit for bit (the packed store: see
    test_packed_latents_beside_the_npy_dirs_match_jax)."""
    kw = dict(batch_size=2, num_workers=2, image_size=32, data_dir=str(mnist_dir_plain), seed=2)
    ours = pdm.MNISTDataModule(**kw)
    _assert_modules_equal(ours, jdm.MNISTDataModule(**kw))
    assert ours.train_images.shape == (8, 32, 32, 1)


@pytest.mark.parametrize("image_size", [16, 45])
def test_cifar10_resize_matches_jax(cifar_dir, image_size):
    """CIFAR-10 reduced and enlarged to another image_size: batches equal to
    the JAX module's (PIL BILINEAR on RGB) bit for bit."""
    kw = dict(batch_size=8, num_workers=2, image_size=image_size, data_dir=str(cifar_dir), seed=4)
    ours = pdm.CIFAR10DataModule(**kw)
    _assert_modules_equal(ours, jdm.CIFAR10DataModule(**kw))
    assert ours.val_images.shape == (13, image_size, image_size, 3)


def test_packed_latents_beside_the_npy_dirs_match_jax(tmp_path):
    """One ``*.latpack`` per split, packed from the ``.npy`` files, loads
    bit-equal to the JAX module and to the files themselves; two raise."""
    from tinyedm_tpu_torch.data.latpack import pack

    npy, packed = tmp_path / "npy", tmp_path / "packed"
    _write_latents(npy, 37, np.random.default_rng(2))
    packed.mkdir()
    assert pack(npy / "latents", npy / "labels", packed / "all.latpack") == 37
    kw = dict(batch_size=4, num_workers=2, image_size=8, seed=1)
    ours = pdm.ImageNetLatentsDataModule(data_dir=str(packed), **kw)
    _assert_modules_equal(ours, jdm.ImageNetLatentsDataModule(data_dir=str(packed), **kw))
    files = pdm.ImageNetLatentsDataModule(data_dir=str(npy), **kw)
    files.setup()
    for name in ("train_images", "train_labels", "val_images", "val_labels"):
        a, b = getattr(ours, name), getattr(files, name)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    (packed / "stale.latpack").write_bytes((packed / "all.latpack").read_bytes())
    for module in (pdm, jdm):
        with pytest.raises(ValueError, match="multiple .latpack files"):
            module.ImageNetLatentsDataModule(data_dir=str(packed), **kw).setup()


@pytest.fixture
def mnist_dir_plain(tmp_path):
    rng = np.random.default_rng(0)
    d = tmp_path / "mnist_plain"
    d.mkdir()
    _write_idx(d / "train-images-idx3-ubyte", rng.integers(0, 256, (8, 28, 28)))
    _write_idx(d / "train-labels-idx1-ubyte", rng.integers(0, 10, 8))
    _write_idx(d / "t10k-images-idx3-ubyte", rng.integers(0, 256, (4, 28, 28)))
    _write_idx(d / "t10k-labels-idx1-ubyte", rng.integers(0, 10, 4))
    return d


def test_missing_files_raise():
    with pytest.raises(FileNotFoundError, match="MNIST"):
        pdm.MNISTDataModule(batch_size=8, data_dir="/nonexistent/mnist").setup()
    with pytest.raises(FileNotFoundError, match="CIFAR-10"):
        pdm.CIFAR10DataModule(batch_size=8, data_dir="/nonexistent/cifar").setup()
    with pytest.raises(RuntimeError, match="setup"):
        next(pdm.CIFAR10DataModule(batch_size=8).train_batches(0))
