"""ctypes bindings and the data module of the packed latent store.

Counterpart of ``tinyedm_tpu/data/latpack.py`` over the same native source,
``native/latpack.cc`` (one file of per-sample latents and labels, read by
mmap'd multithreaded gathers; see the source for the file layout). The
first use compiles it with ``g++ -O3 -shared -fPIC -std=c++17 -pthread``
into the git-ignored ``tinyedm_tpu_torch/build/``, under a name that carries
the source's hash: each process compiles to a name of its own and renames
it into place, so concurrent builders (test workers, the JAX package's own
build of the same source) never load a half-written library.

Batches are NHWC fp32 with int32 labels, as the JAX module gives them (the
trainer's ``to_device`` makes them NCHW). Three lifetimes are guarded, as
in the JAX module: ``close`` waits for in-flight gathers before unmapping,
a gather on a closed store raises ``ValueError`` (never a NULL handle into
native code), and an abandoned ``PendingGather`` waits in ``__del__`` before
numpy frees its buffers.

    python -m tinyedm_tpu_torch.data.latpack <latents_dir> <labels_dir> <out.latpack>
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import warnings
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from tinyedm_tpu_torch.parallel.mesh import data_world

_REPO_ROOT = Path(__file__).resolve().parents[2]
_SRC = _REPO_ROOT / "native" / "latpack.cc"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
_CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_CXX_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"liblatpack-{digest[:16]}.so"


def _build_library() -> Path:
    lib = library_path()
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f".{lib.stem}.{os.getpid()}.tmp.so")
    try:
        done = subprocess.run(["g++", *_CXX_FLAGS, str(_SRC), "-o", str(tmp)], capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"g++ failed to build {_SRC}:\n{done.stderr}")
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build_library()))
        lib.latpack_pack.restype = ctypes.c_long
        lib.latpack_pack.argtypes = [ctypes.c_char_p] * 3
        lib.latpack_open.restype = ctypes.c_void_p
        lib.latpack_open.argtypes = [ctypes.c_char_p]
        lib.latpack_info.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_uint32)] * 4
        lib.latpack_gather.restype = ctypes.c_int
        lib.latpack_gather.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
        ]
        lib.latpack_gather_async.restype = ctypes.c_void_p
        lib.latpack_gather_async.argtypes = lib.latpack_gather.argtypes
        lib.latpack_wait.restype = ctypes.c_int
        lib.latpack_wait.argtypes = [ctypes.c_void_p]
        lib.latpack_close.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def pack(latents_dir: str | Path, labels_dir: str | Path, out_path: str | Path) -> int:
    """Pack per-sample ``{i}.npy`` latents (CHW) and labels into one store;
    returns the sample count."""
    n = _load().latpack_pack(str(latents_dir).encode(), str(labels_dir).encode(), str(out_path).encode())
    if n < 0:
        raise RuntimeError(f"latpack_pack failed with code {n}")
    return int(n)


class PackedLatents:
    """A read-only store, mmap'd: random-access gathers on native threads."""

    def __init__(self, path: str | Path, gather_threads: int = 4):
        self._lib = _load()
        self._handle = self._lib.latpack_open(str(path).encode())
        if not self._handle:
            raise FileNotFoundError(f"cannot open latpack file {path}")
        dims = [ctypes.c_uint32() for _ in range(4)]
        self._lib.latpack_info(self._handle, *(ctypes.byref(d) for d in dims))
        self.n, self.h, self.w, self.c = (d.value for d in dims)
        self.gather_threads = gather_threads
        self._pending: set = set()  # in-flight async gathers, drained by close()

    def __len__(self) -> int:
        return self.n

    def _live_handle(self):
        if not self._handle:
            raise ValueError("PackedLatents store is closed")
        return self._handle

    def _submit(self, fn, indices: np.ndarray):
        handle = self._live_handle()
        indices = np.ascontiguousarray(indices, np.int64)
        out = np.empty((len(indices), self.h, self.w, self.c), np.float32)
        labels = np.empty((len(indices),), np.int32)
        rc = fn(
            handle,
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(indices),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self.gather_threads,
        )
        return rc, out, labels

    def gather(self, indices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(latents NHWC fp32, labels int32) of ``indices``."""
        rc, out, labels = self._submit(self._lib.latpack_gather, indices)
        if rc != 0:
            raise IndexError("latpack_gather: index out of range")
        return out, labels

    def gather_async(self, indices: np.ndarray) -> "PendingGather":
        """Start a gather on native threads (the indices are copied at
        submit); ``.wait()`` on the result gives (latents, labels)."""
        req, out, labels = self._submit(self._lib.latpack_gather_async, indices)
        if not req:
            raise RuntimeError("latpack_gather_async failed to submit")
        pending = PendingGather(self, req, out, labels)
        self._pending.add(pending)
        return pending

    def close(self) -> None:
        if self._handle:
            for pending in list(self._pending):  # no unmapping under native copies
                try:
                    pending.wait()
                except IndexError:
                    pass
            self._lib.latpack_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class PendingGather:
    """An in-flight gather: holds the store and the output buffers until the
    native threads are done. ``wait`` is idempotent, and a failure is
    remembered: every later ``wait`` raises it again."""

    def __init__(self, store: PackedLatents, req: int, out: np.ndarray, labels: np.ndarray):
        self._store = store
        self._req = req
        self._out = out
        self._labels = labels
        self._rc = 0

    def wait(self) -> tuple[np.ndarray, np.ndarray]:
        if self._req:
            self._rc = self._store._lib.latpack_wait(self._req)
            self._req = None
            self._store._pending.discard(self)
        if self._rc != 0:
            raise IndexError("latpack_gather: index out of range")
        return self._out, self._labels

    def __del__(self):
        # a finalizer never raises, but a failed gather of an abandoned
        # generator must not vanish: it becomes a warning
        try:
            self.wait()
        except Exception as e:
            try:
                warnings.warn(f"latpack: an abandoned async gather failed: {e!r}", RuntimeWarning)
            except Exception:
                pass


class PackedLatentsDataModule:
    """ImageNet latents from one latpack store, batches gathered from the
    mmap'd file (the dataset never loads into Python memory). The last
    ``val_fraction`` of the store is the validation set. With ``prefetch``
    batch k+1's gather runs on native threads while batch k trains.

    ``process_index`` of ``process_count`` processes gathers its contiguous
    slice of each global batch (one shared-seed order, so the slices of all
    processes, concatenated, are the one-process stream); by default the
    data rank and data size of the grid (``parallel.mesh.data_world``: the
    ranks of a model group share their rows), and the trainer slices these
    batches no further (``yields_process_local``)."""

    yields_process_local = True

    def __init__(
        self,
        batch_size: int,
        data_file: str,
        num_workers: int = 4,  # native gather threads
        val_fraction: float = 0.01,
        num_classes: int = 1000,
        seed: int = 0,
        prefetch: bool = True,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ):
        self.batch_size = batch_size
        self.data_file = data_file
        self.num_workers = max(1, num_workers)
        self.val_fraction = val_fraction
        self.num_classes = num_classes
        self.seed = seed
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        self._store: Optional[PackedLatents] = None
        self._n_val = 0

    def prepare_data(self) -> None: ...

    def setup(self, stage: str = "fit") -> None:
        self._store = PackedLatents(self.data_file, gather_threads=self.num_workers)
        self._n_val = max(1, int(self._store.n * self.val_fraction))

    def _require(self) -> PackedLatents:
        if self._store is None:
            raise RuntimeError("PackedLatentsDataModule: call setup() first")
        return self._store

    @property
    def _n_train(self) -> int:
        return self._require().n - self._n_val

    def steps_per_epoch(self, drop_last: bool = True) -> int:
        if not drop_last:
            raise NotImplementedError(
                "PackedLatentsDataModule always drops the tail batch (one batch shape, rank slices that divide "
                "it); drop_last=False would train a different step count"
            )
        return self._n_train // self.batch_size

    def train_batches(self, epoch: int, drop_last: bool = True, skip: int = 0) -> Iterator:
        """This process's slice of each shuffled batch of the epoch; ``skip``
        passes over the first batches without gathering them."""
        store = self._require()
        if not drop_last:
            raise NotImplementedError("PackedLatentsDataModule always drops the tail batch (see steps_per_epoch)")
        rank, size = data_world()
        rank = rank if self.process_index is None else self.process_index
        size = size if self.process_count is None else self.process_count
        if self.batch_size % size != 0:
            raise ValueError(f"global batch {self.batch_size} not divisible by {size} processes")
        per = self.batch_size // size
        lo = rank * per
        n_train = self._n_train
        order = np.random.default_rng((self.seed, epoch)).permutation(n_train)
        stop = n_train - n_train % self.batch_size
        starts = range(skip * self.batch_size, stop, self.batch_size)
        if not self.prefetch:
            for start in starts:
                yield store.gather(order[start + lo : start + lo + per])
            return
        pending = None
        for start in starts:
            nxt = store.gather_async(order[start + lo : start + lo + per])
            if pending is not None:
                yield pending.wait()
            pending = nxt
        if pending is not None:
            yield pending.wait()

    def val_batches(self) -> Iterator:
        """The held-out tail in batches, the last one short."""
        store = self._require()
        idx = np.arange(self._n_train, store.n)
        for start in range(0, len(idx), self.batch_size):
            yield store.gather(idx[start : start + self.batch_size])

    def denormalize(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x)


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="Pack per-sample .npy latents and labels into one latpack file")
    p.add_argument("latents_dir")
    p.add_argument("labels_dir")
    p.add_argument("out_path")
    args = p.parse_args(argv)
    n = pack(args.latents_dir, args.labels_dir, args.out_path)
    print(f"packed {n} samples -> {args.out_path}")


if __name__ == "__main__":
    main()
