"""FID, KID and precision/recall/density/coverage over image features.

Counterpart of ``tinyedm_tpu/utils/fid.py``, whose numpy code is copied here
(the port imports nothing of the JAX package): streaming moments
(``compute_stats``, ``compute_stats_and_features`` with a reservoir of
feature rows for KID), ``kid_score``, ``prdc``, ``frechet_distance``, the
``.npz`` stats files, ``png_dir_batches`` (threaded, order-preserving
decode, on ``training.callbacks.read_png``) and ``fid_between_dirs``.

Features come from a function ``uint8 NHWC images -> (N, D)``:
``inception_features`` (the port's InceptionV3 pool3 on converted local
weights, ``utils/inception.py``; there is no torchvision branch), the
``proxy_features`` random projections, or any module exposing
``feature_fn()``. ``resolve_feature_fn`` never falls back: a missing weight
file raises, and proxy features are used only when asked for.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterator, Optional

import numpy as np
import torch

FeatureFn = Callable[[np.ndarray], np.ndarray]


def _feature_stream(features_or_batches, feature_fn: Optional[FeatureFn]):
    """Feature arrays per input batch. A feature function with the
    ``dispatch``/``gather`` protocol keeps one batch of device work in
    flight while the previous batch's features come to the host; the values
    are the same either way."""
    it = features_or_batches
    if isinstance(it, np.ndarray):
        it = [it]
    dispatch = getattr(feature_fn, "dispatch", None)
    gather = getattr(feature_fn, "gather", None)
    if feature_fn is None or dispatch is None or gather is None:
        for batch in it:
            yield np.asarray(feature_fn(batch) if feature_fn is not None else batch)
        return
    pending = None
    for batch in it:
        handles = dispatch(batch)
        if pending is not None:
            yield gather(pending)
        pending = handles
    if pending is not None:
        yield gather(pending)


def compute_stats(features_or_batches, feature_fn: Optional[FeatureFn] = None) -> tuple[np.ndarray, np.ndarray]:
    """Streaming (mu, sigma) over feature batches, in fp64."""
    n = 0
    s = None
    ss = None
    for f in _feature_stream(features_or_batches, feature_fn):
        f = f.astype(np.float64)
        if s is None:
            s = np.zeros(f.shape[1])
            ss = np.zeros((f.shape[1], f.shape[1]))
        n += f.shape[0]
        s += f.sum(axis=0)
        ss += f.T @ f
    if n < 2:
        raise ValueError("need at least 2 samples for covariance")
    mu = s / n
    sigma = (ss - n * np.outer(mu, mu)) / (n - 1)
    return mu, sigma


def compute_stats_and_features(
    features_or_batches,
    feature_fn: Optional[FeatureFn] = None,
    max_features: Optional[int] = None,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One streaming pass: (mu, sigma, features), the feature rows a uniform
    subsample of at most ``max_features`` (reservoir sampling, Algorithm R,
    deterministic in ``seed``)."""
    rng = np.random.default_rng(seed)
    n = 0
    s = None
    ss = None
    reservoir: list[np.ndarray] = []
    for f in _feature_stream(features_or_batches, feature_fn):
        f64 = f.astype(np.float64)
        if s is None:
            s = np.zeros(f64.shape[1])
            ss = np.zeros((f64.shape[1], f64.shape[1]))
        s += f64.sum(axis=0)
        ss += f64.T @ f64
        for row in f.astype(np.float32):
            n += 1
            if max_features is None or len(reservoir) < max_features:
                reservoir.append(row)
            else:
                j = int(rng.integers(0, n))
                if j < max_features:
                    reservoir[j] = row
    if n < 2:
        raise ValueError("need at least 2 samples for covariance")
    mu = s / n
    sigma = (ss - n * np.outer(mu, mu)) / (n - 1)
    return mu, sigma, np.stack(reservoir)


def kid_score(
    feats1: np.ndarray,
    feats2: np.ndarray,
    subset_size: int = 1000,
    num_subsets: int = 100,
    seed: int = 0,
) -> float:
    """Kernel Inception Distance (Binkowski et al. 2018): the unbiased
    squared MMD under k(x, y) = (x.y / d + 1)^3, averaged over
    ``num_subsets`` random subsets of ``subset_size`` rows of each set (the
    raw estimate, which can be slightly negative at small n)."""
    f1 = np.asarray(feats1, np.float64)
    f2 = np.asarray(feats2, np.float64)
    d = f1.shape[1]
    if f2.shape[1] != d:
        raise ValueError(f"feature dims differ: {d} vs {f2.shape[1]}")
    m = min(subset_size, len(f1), len(f2))
    if m < 2:
        raise ValueError("need at least 2 samples per set for unbiased MMD")
    rng = np.random.default_rng(seed)
    total = 0.0
    for _ in range(num_subsets):
        x = f1[rng.choice(len(f1), m, replace=False)]
        y = f2[rng.choice(len(f2), m, replace=False)]
        kxx = (x @ x.T / d + 1.0) ** 3
        kyy = (y @ y.T / d + 1.0) ** 3
        kxy = (x @ y.T / d + 1.0) ** 3
        off = m * (m - 1)
        total += (kxx.sum() - np.trace(kxx)) / off + (kyy.sum() - np.trace(kyy)) / off - 2.0 * kxy.mean()
    return float(total / num_subsets)


def _sq_dists(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise squared euclidean distances, clipped at 0."""
    d2 = (a * a).sum(axis=1)[:, None] + (b * b).sum(axis=1)[None, :] - 2.0 * (a @ b.T)
    return np.clip(d2, 0.0, None)


def _knn_sq_radii(x: np.ndarray, k: int, chunk: int) -> np.ndarray:
    """Squared distance of each row to its k-th nearest other row."""
    out = np.empty(len(x))
    for s in range(0, len(x), chunk):
        d2 = _sq_dists(x[s : s + chunk], x)
        out[s : s + chunk] = np.partition(d2, k, axis=1)[:, k]
    return out


def prdc(real_feats: np.ndarray, fake_feats: np.ndarray, k: int = 5, chunk: int = 1024) -> dict:
    """Precision, recall, density and coverage (Naeem et al. 2020) over k-NN
    balls of the feature rows, in chunks of ``chunk`` rows."""
    real = np.asarray(real_feats, np.float64)
    fake = np.asarray(fake_feats, np.float64)
    if real.shape[1] != fake.shape[1]:
        raise ValueError(f"feature dims differ: {real.shape[1]} vs {fake.shape[1]}")
    if k >= len(real) or k >= len(fake):
        raise ValueError(f"k={k} needs more than k rows in each set")
    real_r2 = _knn_sq_radii(real, k, chunk)
    fake_r2 = _knn_sq_radii(fake, k, chunk)
    precision_hits = 0
    density_sum = 0.0
    min_d2_to_fake = np.full(len(real), np.inf)
    for s in range(0, len(fake), chunk):
        d2 = _sq_dists(fake[s : s + chunk], real)
        inside = d2 <= real_r2[None, :]
        precision_hits += int(inside.any(axis=1).sum())
        density_sum += float(inside.sum())
        np.minimum(min_d2_to_fake, d2.min(axis=0), out=min_d2_to_fake)
    recall_hits = 0
    for s in range(0, len(real), chunk):
        d2 = _sq_dists(real[s : s + chunk], fake)
        recall_hits += int((d2 <= fake_r2[None, :]).any(axis=1).sum())
    return {
        "precision": precision_hits / len(fake),
        "recall": recall_hits / len(real),
        "density": density_sum / (k * len(fake)),
        "coverage": float((min_d2_to_fake <= real_r2).mean()),
    }


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Matrix square root by eigendecomposition (symmetric PSD up to noise)."""
    vals, vecs = np.linalg.eigh(mat)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray) -> float:
    """FID between two Gaussians; tr((S1 S2)^1/2) from the eigenvalues of
    S1^1/2 S2 S1^1/2."""
    diff = mu1 - mu2
    s1_half = _sqrtm_psd(sigma1)
    inner = s1_half @ sigma2 @ s1_half
    vals = np.linalg.eigvalsh((inner + inner.T) / 2.0)
    tr_sqrt = np.sum(np.sqrt(np.clip(vals, 0.0, None)))
    fid = float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * tr_sqrt)
    return max(fid, 0.0)  # rank-deficient covariances give small negative noise


def save_stats(path: str | Path, mu: np.ndarray, sigma: np.ndarray, features: Optional[np.ndarray] = None) -> None:
    """FID reference stats; ``features`` (a feature subsample) enables KID."""
    extra = {} if features is None else {"features": np.asarray(features, np.float32)}
    np.savez(path, mu=mu, sigma=sigma, **extra)


def load_stats(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    d = np.load(path)
    return d["mu"], d["sigma"]


def load_features(path: str | Path) -> Optional[np.ndarray]:
    """The feature subsample stored with the stats, None without one."""
    d = np.load(path)
    return d["features"] if "features" in d.files else None


def png_dir_batches(
    directory: str | Path,
    batch_size: int = 256,
    workers: int = 8,
    prefetch: int = 2,
) -> Iterator[np.ndarray]:
    """A directory of images as uint8 NHWC RGB batches, in sorted path order.

    ``workers`` threads decode (zlib's inflate releases the GIL) and up to
    ``prefetch`` whole batches are assembled ahead of the consumer on a
    thread of their own; the futures are taken in submission order, so the
    batches equal the serial path's. A ``.jpg`` (or any PNG that
    ``read_png`` does not read) raises with its name. Closing the generator
    early stops the producer."""
    import queue
    import threading
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from tinyedm_tpu_torch.training.callbacks import read_png

    paths = sorted(p for p in Path(directory).iterdir() if p.suffix.lower() in (".png", ".jpg"))
    if not paths:
        return
    q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        # a bounded put that gives up once the consumer has gone away
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                batch: list[np.ndarray] = []
                window: deque = deque()  # futures in submission order, bounded
                it = iter(paths)
                exhausted = False
                while window or not exhausted:
                    while not exhausted and len(window) < workers * 4:
                        p = next(it, None)
                        if p is None:
                            exhausted = True
                        else:
                            window.append(pool.submit(read_png, p))
                    if not window:
                        break
                    if stop.is_set():
                        return
                    batch.append(window.popleft().result())
                    if len(batch) == batch_size:
                        if not put(np.stack(batch)):
                            return
                        batch = []
                if batch:
                    put(np.stack(batch))
            put(end)
        except BaseException as e:  # decode errors reach the consumer
            put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
        t.join()
    finally:
        stop.set()


def inception_features(
    weights_path: Optional[str | Path] = None,
    allow_unverified: bool = False,
    device: Optional[str | torch.device] = None,
) -> FeatureFn:
    """InceptionV3 pool3 features (2048-d) from converted local weights
    (``utils/inception.py``), on ``device`` (the card unless ``"cpu"``).
    Raises ``FileNotFoundError`` with the conversion steps when there is no
    weight file, and ``UnverifiedInceptionWeights`` when the file lacks the
    ``pretrained`` stamp and ``allow_unverified`` is not set."""
    from tinyedm_tpu_torch.utils import inception

    path = Path(weights_path or inception.DEFAULT_WEIGHTS)
    if not path.exists():
        raise FileNotFoundError(
            f"no InceptionV3 weights available at {path}: convert a torchvision state dict via "
            "tinyedm_tpu_torch.utils.inception.convert_torch_inception + save_converted, or pass feature_fn "
            "explicitly (utils.inception.proxy_feature_fn is the validated fallback)"
        )
    return inception.inception_feature_fn(path, allow_unverified=allow_unverified, device=device)


def proxy_features(dim: int = 256, seed: int = 0, device: Optional[str | torch.device] = None) -> FeatureFn:
    """Deterministic random-projection features (``proxy_feature_fn``): for
    relative tracking and pipeline checks; NOT comparable to Inception FID."""
    from tinyedm_tpu_torch.utils.inception import proxy_feature_fn

    return proxy_feature_fn(dim=dim, seed=seed, device=device)


def resolve_feature_fn(spec: Optional[str], device: Optional[str | torch.device] = None) -> tuple[FeatureFn, str]:
    """(feature function, kind) of a spec shared by the eval CLI and
    ``FIDCallback``: ``"inception"`` (verified local weights),
    ``"inception-unverified"`` (the same graph on a rehearsal weight file
    without the ``pretrained`` stamp: its numbers are NOT Inception FIDs),
    ``"proxy"``, a module path exposing ``feature_fn()``, or None, which is
    ``"inception"`` and raises when no verified weights exist. There is no
    silent fallback: a proxy or random-weight FID recorded under the default
    spec would read as an Inception FID."""
    import importlib

    if spec == "inception":
        return inception_features(device=device), "inception"
    if spec == "inception-unverified":
        return inception_features(allow_unverified=True, device=device), "inception-unverified"
    if spec == "proxy":
        return proxy_features(device=device), "proxy"
    if spec is not None:
        return importlib.import_module(spec).feature_fn(), spec
    try:
        return inception_features(device=device), "inception"
    except FileNotFoundError as e:
        raise FileNotFoundError(
            f"{e}\nRefusing to fall back to proxy features implicitly - a proxy-FID is not comparable to "
            "Inception-FID. Pass --features proxy (CLI) or features='proxy' (FIDCallback) to score with proxy "
            "features explicitly."
        ) from None


def fid_between_dirs(
    dir1: str | Path,
    dir2_or_stats: str | Path,
    feature_fn: Optional[FeatureFn] = None,
    batch_size: int = 256,
) -> float:
    """FID between a sample directory and another directory or a saved
    ``.npz`` stats file."""
    if feature_fn is None:
        feature_fn = inception_features()
    mu1, s1 = compute_stats(png_dir_batches(dir1, batch_size), feature_fn)
    p2 = Path(dir2_or_stats)
    if p2.suffix == ".npz":
        mu2, s2 = load_stats(p2)
    else:
        mu2, s2 = compute_stats(png_dir_batches(p2, batch_size), feature_fn)
    return frechet_distance(mu1, s1, mu2, s2)
