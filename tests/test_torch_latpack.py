"""The port's latpack store and data module against the JAX package's.

Both packages compile ``native/latpack.cc`` (each into its own build
directory) and read the same synthetic store, 23 samples of CHW 4x8x8
latents written as ``tests/test_latpack.py`` writes them. Equal means equal
bit for bit, dtypes included: the packed file, ``gather`` and
``gather_async``, the epochs of ``PackedLatentsDataModule`` with and without
prefetch and with ``skip``, the validation batches, and the rank slices of
explicit ``process_index``/``process_count``, which tile the one-process
stream as the JAX module's do. The lifetimes: the out-of-range raise and
its remembered failure, an abandoned prefetching generator, ``close``
draining in-flight gathers, a gather on a closed store.
"""

from __future__ import annotations

import gc
import warnings

import numpy as np
import pytest

from tinyedm_tpu.data import latpack as jlp
from tinyedm_tpu_torch.data import latpack as plp

N = 23


def _write_npy(tmp, n=N, seed=0):
    lat_dir, lab_dir = tmp / "latents", tmp / "labels"
    lat_dir.mkdir()
    lab_dir.mkdir()
    rng = np.random.default_rng(seed)
    lats = rng.standard_normal((n, 4, 8, 8)).astype(np.float32)  # CHW, as the extractor writes
    for i in range(n):
        np.save(lat_dir / f"{i}.npy", lats[i])
        np.save(lab_dir / f"{i}.npy", np.int64(i % 7))
    return lat_dir, lab_dir, lats.transpose(0, 2, 3, 1), np.arange(n) % 7


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("latpack")
    lat_dir, lab_dir, ref_lat, ref_lab = _write_npy(tmp)
    plp.main([str(lat_dir), str(lab_dir), str(tmp / "port.latpack")])  # the pack CLI
    assert jlp.pack(lat_dir, lab_dir, tmp / "jax.latpack") == N
    return tmp / "port.latpack", tmp / "jax.latpack", ref_lat, ref_lab


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _same_stream(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs)
    for (la, ya), (lb, yb) in zip(ours, theirs):
        _same(la, lb)
        _same(ya, yb)


def test_pack_cli_writes_the_jax_file(store, capsys):
    path, jax_path, _, _ = store
    assert path.read_bytes() == jax_path.read_bytes()
    assert plp.pack(path.parent / "latents", path.parent / "labels", path.parent / "again.latpack") == N
    s = plp.PackedLatents(path)
    assert len(s) == N and (s.h, s.w, s.c) == (8, 8, 4)
    s.close()
    assert plp.library_path().exists()


def test_gather_and_gather_async_equal_jax(store):
    path, _, ref_lat, ref_lab = store
    ours, theirs = plp.PackedLatents(path, gather_threads=3), jlp.PackedLatents(path, gather_threads=3)
    idx = np.asarray([0, 22, 7, 7, 13])
    lat, lab = ours.gather(idx)
    for a, b in zip((lat, lab), theirs.gather(idx)):
        _same(a, b)
    _same(lat, ref_lat[idx])
    np.testing.assert_array_equal(lab, ref_lab[idx])
    idx = np.asarray([5, 0, 19, 5])
    pending = ours.gather_async(idx)
    idx[:] = 0  # the indices are copied at submit
    lat, lab = pending.wait()
    assert pending.wait()[0] is lat  # idempotent
    for a, b in zip((lat, lab), theirs.gather_async(np.asarray([5, 0, 19, 5])).wait()):
        _same(a, b)
    ours.close()
    theirs.close()


@pytest.mark.parametrize("prefetch", [True, False])
def test_epochs_skip_and_val_equal_jax(store, prefetch):
    path = str(store[0])
    kw = dict(batch_size=4, data_file=path, val_fraction=0.15, seed=5, prefetch=prefetch)
    ours = plp.PackedLatentsDataModule(**kw)
    theirs = jlp.PackedLatentsDataModule(process_index=0, process_count=1, **kw)
    ours.setup()
    theirs.setup()
    assert ours.steps_per_epoch() == theirs.steps_per_epoch() == 5
    for epoch in range(2):
        _same_stream(ours.train_batches(epoch), theirs.train_batches(epoch))
        _same_stream(ours.train_batches(epoch, skip=2), theirs.train_batches(epoch, skip=2))
    _same_stream(ours.val_batches(), theirs.val_batches())
    assert [len(v[1]) for v in ours.val_batches()] == [3]  # the held-out tail, one short batch
    with pytest.raises(NotImplementedError, match="tail batch"):
        ours.steps_per_epoch(drop_last=False)


@pytest.mark.parametrize("process_count", [2, 4])
def test_rank_slices_tile_the_stream_as_jax(store, process_count):
    path = str(store[0])
    kw = dict(batch_size=4, data_file=path, val_fraction=0.15, seed=11)
    whole = plp.PackedLatentsDataModule(**kw)
    whole.setup()
    ranks = []
    for pi in range(process_count):
        ours = plp.PackedLatentsDataModule(process_index=pi, process_count=process_count, **kw)
        theirs = jlp.PackedLatentsDataModule(process_index=pi, process_count=process_count, **kw)
        ours.setup()
        theirs.setup()
        ranks.append(list(ours.train_batches(2)))
        _same_stream(ranks[-1], theirs.train_batches(2))
    for b, (lat, lab) in enumerate(whole.train_batches(2)):
        assert all(len(r[b][1]) == 4 // process_count for r in ranks)
        _same(np.concatenate([r[b][0] for r in ranks]), lat)
        _same(np.concatenate([r[b][1] for r in ranks]), lab)
    odd = plp.PackedLatentsDataModule(batch_size=5, data_file=path, process_index=0, process_count=2)
    odd.setup()
    with pytest.raises(ValueError, match="not divisible"):
        next(odd.train_batches(0))


def test_out_of_range_raises_and_is_remembered(store):
    s = plp.PackedLatents(store[0])
    with pytest.raises(IndexError):
        s.gather(np.asarray([100]))
    pending = s.gather_async(np.asarray([0, 999]))
    for _ in range(2):
        with pytest.raises(IndexError):
            pending.wait()
    s.close()
    with pytest.raises(FileNotFoundError):
        plp.PackedLatents(store[0].parent / "missing.latpack")


def test_abandoned_prefetch_and_abandoned_failure(store):
    dm = plp.PackedLatentsDataModule(batch_size=4, data_file=str(store[0]), val_fraction=0.15, prefetch=True)
    dm.setup()
    it = dm.train_batches(0)
    next(it)
    del it  # closed with one gather in flight: PendingGather.__del__ waits
    gc.collect()
    assert len(list(dm.train_batches(0))) == dm.steps_per_epoch()
    s = plp.PackedLatents(store[0])
    pending = s.gather_async(np.asarray([1, 500]))
    s._pending.clear()  # as if the store no longer tracked it: only the finalizer waits
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        del pending
        gc.collect()
    assert any(issubclass(w.category, RuntimeWarning) and "abandoned" in str(w.message) for w in caught)
    s.close()


def test_close_drains_in_flight_gathers_and_refuses_later_ones(store):
    path, _, ref_lat, ref_lab = store
    s = plp.PackedLatents(path, gather_threads=3)
    idx = np.asarray([2, 11, 2, 20])
    pending = s.gather_async(idx)
    s.close()  # waits for the native threads, then unmaps
    lat, lab = pending.wait()
    _same(lat, ref_lat[idx])
    np.testing.assert_array_equal(lab, ref_lab[idx])
    for call in (s.gather, s.gather_async):
        with pytest.raises(ValueError, match="closed"):
            call(idx)
    s.close()  # idempotent
