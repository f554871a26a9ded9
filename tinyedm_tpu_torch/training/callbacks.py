"""Training callbacks (sample previews) and the PNG writer.

Counterpart of ``tinyedm_tpu/training/callbacks.py``: ``Callback``, the
``make_grid`` tiling, ``GenerateCallback`` (every N epochs, solve from a
fixed noise batch drawn at train start and log a grid of the samples),
``LatentsGenerateCallback`` and ``PreditionWriter`` (the reference's
spelling kept). The trainer drives the callbacks and hands them itself.
PNGs are encoded and read with the standard library (zlib + struct): the
machine with the card has no Pillow. ``read_png`` decodes what PIL writes
for 8-bit images (grey, grey + alpha, RGB, RGBA, palette; every row filter)
into RGB, as PIL's ``convert("RGB")`` does, and raises on anything else.
``FIDCallback`` scores samples during training (FID, and KID when asked;
``utils/fid.py``).

Over several ranks the previews and the scoring run on rank 0 alone, as the
JAX callbacks guard on ``jax.process_index()`` (under ZeRO-1 the trainer
gathers its EMA trees on every rank before it calls the callbacks). Under
tensor parallelism every forward is collective, so rank 0's whole model
group (data rank 0) solves; rank 0 alone decodes, scores and writes.
``FIDCallback`` checks its files on every rank at train start, so that a
bad path stops every rank, not rank 0 alone.

``LatentsGenerateCallback`` decodes its latent previews with the SD VAE
(``data/vae.py``) on the trainer's device; where no VAE weights can be found
it logs the JAX callback's warning and a grid of the latents' first three
channels, as the JAX callback does.
"""

from __future__ import annotations

import struct
import time
import zlib
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from tinyedm_tpu_torch.parallel.mesh import data_world, world


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def encode_png(image: np.ndarray, palette: Optional[np.ndarray] = None) -> bytes:
    """8-bit PNG of a (H, W) grey, (H, W, 1) grey, (H, W, 2) grey + alpha,
    (H, W, 3) RGB or (H, W, 4) RGBA uint8 image: the color types PIL writes
    for those shapes (0, 4, 2 and 6), so a 4-channel latent sample is written
    as RGBA, as the JAX package's PreditionWriter writes it. With a
    ``palette`` ((entries, 3) uint8, at most 256), ``image`` is (H, W)
    palette indices, written as color type 3."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {image.dtype}")
    if image.ndim == 3 and image.shape[-1] == 1:
        image = image[..., 0]
    color_types = {2: 4, 3: 2, 4: 6}
    plte = b""
    if palette is not None:
        palette = np.asarray(palette, np.uint8)
        if image.ndim != 2 or palette.ndim != 2 or palette.shape[1] != 3 or not 0 < len(palette) <= 256:
            raise ValueError(f"a palette PNG takes (H, W) indices and an (entries <= 256, 3) palette, got "
                             f"{image.shape} and {palette.shape}")
        if int(image.max(initial=0)) >= len(palette):
            raise ValueError(f"palette index past the {len(palette)}-entry palette")
        color_type, plte = 3, _chunk(b"PLTE", palette.tobytes())
    elif image.ndim == 2:
        color_type = 0
    elif image.ndim == 3 and image.shape[-1] in color_types:
        color_type = color_types[image.shape[-1]]
    else:
        raise ValueError(
            f"encode_png takes (H, W), (H, W, 1), (H, W, 2), (H, W, 3) or (H, W, 4), got {image.shape}"
        )
    h, w = image.shape[:2]
    rows = np.ascontiguousarray(image).reshape(h, -1)
    # filter type 0 (none) in front of every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _chunk(b"IHDR", header)
        + plte
        + _chunk(b"IDAT", zlib.compress(raw))
        + _chunk(b"IEND", b"")
    )


def read_png(path: str | Path) -> np.ndarray:
    """The (H, W, 3) uint8 RGB pixels of an 8-bit, non-interlaced PNG (grey,
    grey + alpha, RGB, RGBA or palette), as PIL's ``convert("RGB")`` gives
    them: grey repeated, alpha dropped, palette indices looked up. Any other
    file raises ``ValueError`` naming it."""
    from tinyedm_tpu_torch.data.images import read_png_native
    from tinyedm_tpu_torch.data.resample import to_rgb

    image = read_png_native(path)
    return to_rgb(image.pixels, image.mode, image.palette)


class PreditionWriter:
    """Writes generated NHWC batches as PNGs named by global sample index:
    pred * std * 2 + mean, clamp [0, 1], * 255, uint8 (a uint8 batch is taken
    as already mapped)."""

    def __init__(self, output_dir: str, write_interval: str, mean: Sequence[float], std: Sequence[float]):
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.write_interval = write_interval
        self.mean = np.asarray(mean, np.float32).reshape(1, 1, 1, -1)
        self.std = np.asarray(std, np.float32).reshape(1, 1, 1, -1)

    def write_batch(self, prediction: np.ndarray, batch_indices: Sequence[int]) -> None:
        prediction = np.asarray(prediction)
        if prediction.dtype == np.uint8:
            images = prediction
        else:
            images = prediction.astype(np.float32) * self.std * 2.0 + self.mean
            images = (np.clip(images, 0.0, 1.0) * 255.0).astype(np.uint8)
        for index, image in zip(batch_indices, images):
            (self.output_dir / f"{index}.png").write_bytes(encode_png(image))


class Callback:
    """The hooks the trainer calls (a subset of Lightning's)."""

    def on_train_start(self, trainer) -> None: ...

    def on_train_epoch_end(self, trainer) -> None: ...

    def on_validation_end(self, trainer) -> None: ...

    def on_fit_end(self, trainer) -> None: ...


def make_grid(images: np.ndarray, nrow: int = 8, padding: int = 2) -> np.ndarray:
    """Tile a batch of NHWC uint8 images into one HWC grid image."""
    n, h, w, c = images.shape
    ncol = nrow
    nrows = (n + ncol - 1) // ncol
    grid = np.zeros((nrows * (h + padding) + padding, ncol * (w + padding) + padding, c), dtype=images.dtype)
    for idx in range(n):
        r, cl = divmod(idx, ncol)
        y = r * (h + padding) + padding
        x = cl * (w + padding) + padding
        grid[y : y + h, x : x + w] = images[idx]
    return grid


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.float().permute(0, 2, 3, 1).cpu().numpy()


class GenerateCallback(Callback):
    """Every ``every_n_epochs`` epochs: solve the ODE from a fixed noise batch
    drawn at train start (a generator seeded ``seed ^ 0x5EED`` on the
    trainer's device), with the EMA weights where the trainer tracks them,
    denormalize through the datamodule and log the grid as "Generated".
    Conditional models get labels ``arange(num_samples) % num_classes``."""

    def __init__(
        self,
        solver,
        img_shape: tuple[int, int, int],  # (C, H, W)
        num_samples: int = 8,
        every_n_epochs: int = 5,
        guidance_scale: Optional[float] = None,
    ):
        self.solver = solver
        self.img_shape = tuple(img_shape)
        self.num_samples = num_samples
        self.every_n_epochs = every_n_epochs
        self.guidance_scale = guidance_scale  # CFG previews of label-dropout runs
        self.x0: Optional[torch.Tensor] = None
        self.class_labels: Optional[torch.Tensor] = None

    def on_train_start(self, trainer) -> None:
        if data_world()[0] != 0:
            return
        gen = torch.Generator(device=trainer.device).manual_seed(trainer.seed ^ 0x5EED)
        self.x0 = torch.randn((self.num_samples, *self.img_shape), generator=gen, device=trainer.device)
        self.class_labels = None
        if trainer.model.conditional:
            n_cls = trainer.model.embedding.num_classes
            self.class_labels = torch.arange(self.num_samples, device=trainer.device) % n_cls

    def on_train_epoch_end(self, trainer) -> None:
        if data_world()[0] != 0 or self.x0 is None or trainer.epoch % self.every_n_epochs != 0:
            return
        xT = trainer.solve(self.solver, self.x0, self.class_labels, use_ema=trainer.use_ema,
                           guidance_scale=self.guidance_scale)
        if world()[0] != 0:
            return
        images = trainer.datamodule.denormalize(_nhwc(xT))
        trainer.logger.log_image("Generated", make_grid(images), step=trainer.epoch)


# latents per VAE decode of a preview: at 512x512 in fp32 a decode of 32
# peaks at 24 GiB and one of 80 (imagenet.yaml's preview) at 60 GiB, at the
# same img/s on an H100 (chip_smoke.py phase 29), so chunks of 32 keep the larger
# preview beside a training state
DECODE_BATCH = 32


def _load_vae(name: str, device):
    from tinyedm_tpu_torch.data.vae import load_vae

    return load_vae(name, device=device)


class LatentsGenerateCallback(Callback):
    """Latent-space previews after validation, every ``every_n_epochs``
    epochs: solve from fixed noise (generator seeded ``seed ^ 0x1A7E``) for
    ``num_classes`` drawn labels, ``num_samples_per_class`` each, un-normalize
    with the dataset's latent ``mean`` and ``std``, decode with the VAE
    ``vae_name`` (loaded at train start on the trainer's device; local files
    only, ``data.vae.load_vae``), clamp to ``value_range``, map it onto
    [0, 255] and log the grid, one column per class. The latents are decoded
    ``DECODE_BATCH`` at a time (GroupNorm is per sample, so the images do not
    depend on it). Without VAE weights,
    the grid shows the latents' first three channels scaled to [0, 255],
    after a warning. ``last_decode_seconds`` holds the latest decode's wall
    time, the copy back to the host included."""

    def __init__(
        self,
        solver,
        img_shape: tuple[int, int, int],
        mean: Sequence[float],
        std: Sequence[float],
        value_range: tuple[float, float] = (0.0, 1.0),
        num_samples_per_class: int = 8,
        num_classes: int = 10,
        every_n_epochs: int = 100,
        vae_name: str = "stabilityai/sd-vae-ft-ema",
        guidance_scale: Optional[float] = None,
    ):
        self.guidance_scale = guidance_scale
        self.solver = solver
        self.img_shape = tuple(img_shape)
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.value_range = value_range
        self.num_samples_per_class = num_samples_per_class
        self.num_classes = num_classes
        self.every_n_epochs = every_n_epochs
        self.vae_name = vae_name
        self.x0: Optional[torch.Tensor] = None
        self.class_labels: Optional[torch.Tensor] = None
        self._vae = None
        self.last_decode_seconds: Optional[float] = None

    def on_train_start(self, trainer) -> None:
        if data_world()[0] != 0:
            return
        n = self.num_samples_per_class * self.num_classes
        gen = torch.Generator(device=trainer.device).manual_seed(trainer.seed ^ 0x1A7E)
        self.x0 = torch.randn((n, *self.img_shape), generator=gen, device=trainer.device)
        labels = torch.randint(0, trainer.model.embedding.num_classes, (self.num_classes,), generator=gen,
                               device=trainer.device)
        self.class_labels = labels.repeat(self.num_samples_per_class)
        if world()[0] != 0:
            return
        try:
            self._vae = _load_vae(self.vae_name, trainer.device)
        except (OSError, ValueError, RuntimeError) as e:  # no weights, or weights that do not fit
            trainer.logger.log_text("warn", f"LatentsGenerateCallback: VAE unavailable ({e}); logging latents")
            self._vae = None

    def decode(self, lat: np.ndarray, device) -> np.ndarray:
        """NHWC latents -> NHWC fp32 images, decoded on ``device``."""
        t0 = time.perf_counter()
        z = torch.from_numpy(np.ascontiguousarray(lat)).to(device).permute(0, 3, 1, 2).contiguous()
        step = DECODE_BATCH
        with torch.no_grad():
            out = [self._vae.decode(z[i : i + step]).float().permute(0, 2, 3, 1).cpu().numpy()
                   for i in range(0, len(z), step)]
        self.last_decode_seconds = time.perf_counter() - t0
        return np.concatenate(out)

    def on_validation_end(self, trainer) -> None:
        if data_world()[0] != 0 or self.x0 is None or trainer.epoch % self.every_n_epochs != 0:
            return
        xT = trainer.solve(self.solver, self.x0, self.class_labels, use_ema=trainer.use_ema,
                           guidance_scale=self.guidance_scale)
        if world()[0] != 0:
            return
        lat = _nhwc(xT) * self.std.reshape(1, 1, 1, -1) * 2.0 + self.mean.reshape(1, 1, 1, -1)
        if self._vae is not None:
            # clamp to value_range, then map it onto [0, 1] for the uint8 grid
            lo, hi = self.value_range
            images = np.clip(self.decode(lat, trainer.device), lo, hi)
            images = (images - lo) / max(hi - lo, 1e-12)
            images = (images * 255.0).astype(np.uint8)
        else:
            lo, hi = lat.min(), lat.max()
            vis = (lat[..., :3] - lo) / max(hi - lo, 1e-6)
            images = (vis * 255.0).astype(np.uint8)
        trainer.logger.log_image("Generated", make_grid(images, nrow=self.num_classes), step=trainer.epoch)


class FIDCallback(Callback):
    """Every ``every_n_epochs`` epochs: sample ``num_samples`` images with
    the EMA tree ``ema_index`` (the train weights without EMA), featurize
    them and log ``fid`` (and ``kid`` when asked) against a stats file of
    ``eval_fid stats``; the values also go to the epoch's checkpoint
    metrics, so a checkpoint monitor can select on ``fid``.

    The stats file and the feature extractor are checked at train start
    (``features``: a ``utils.fid.resolve_feature_fn`` spec, on the trainer's
    device), so a missing weight file fails the run before its first step.
    Image-space models only (a latent model would need the VAE decode).
    Noise comes from a generator seeded ``seed ^ 0xF1D`` folded with the
    epoch, on the trainer's device: each evaluation draws fresh samples,
    the same ones for a given epoch."""

    def __init__(
        self,
        solver,
        img_shape: tuple[int, int, int],  # (C, H, W)
        stats_path: str,
        num_samples: int = 1024,
        batch_size: int = 128,
        every_n_epochs: int = 100,
        features: Optional[str] = None,
        kid: bool = False,
        kid_subset_size: int = 1000,
        kid_subsets: int = 100,
        ema_index: int = 0,
        guidance_scale: Optional[float] = None,
    ):
        self.solver = solver
        self.img_shape = tuple(img_shape)
        self.stats_path = stats_path
        self.num_samples = num_samples
        self.batch_size = batch_size
        self.every_n_epochs = every_n_epochs
        self.features = features
        self.kid = kid
        self.kid_subset_size = kid_subset_size
        self.kid_subsets = kid_subsets
        self.ema_index = ema_index
        self.guidance_scale = guidance_scale
        self._ref = None  # (mu, sigma, feature rows or None) of the stats file
        self._feature_fn = None

    def on_train_start(self, trainer) -> None:
        # deliberately on every rank: a raise on rank 0 alone would leave the
        # others waiting in the first step's all-reduce
        from tinyedm_tpu_torch.utils.fid import load_features, load_stats, resolve_feature_fn

        self._feature_fn, _ = resolve_feature_fn(self.features, trainer.device)
        mu, sigma = load_stats(self.stats_path)
        ref_feats = load_features(self.stats_path)
        if self.kid and ref_feats is None:
            raise ValueError(
                f"{self.stats_path} has no stored feature rows - regenerate it with `eval_fid stats "
                "--kid-features N` to track KID"
            )
        self._ref = (mu, sigma, ref_feats)

    def _sample_batches(self, trainer):
        """Denormalized uint8 NHWC sample batches, one solve per batch."""
        from tinyedm_tpu_torch.utils.cuda import folded_generator

        n_cls = trainer.model.embedding.num_classes if trainer.model.conditional else None
        gen = folded_generator(trainer.seed ^ 0xF1D, trainer.epoch, trainer.device)
        done = 0
        while done < self.num_samples:
            n = min(self.batch_size, self.num_samples - done)
            # one batch shape throughout; the tail is trimmed after the solve
            x0 = torch.randn((self.batch_size, *self.img_shape), generator=gen, device=trainer.device)
            labels = None
            if n_cls:
                labels = torch.arange(done, done + self.batch_size, device=trainer.device) % n_cls
            xT = trainer.solve(self.solver, x0, labels, use_ema=trainer.use_ema, ema_index=self.ema_index,
                               guidance_scale=self.guidance_scale)
            yield trainer.datamodule.denormalize(_nhwc(xT[:n]))
            done += n

    def on_train_epoch_end(self, trainer) -> None:
        # the (epoch + 1) cadence of validation and checkpoints, so that fid
        # lands in the same epoch's save
        if data_world()[0] != 0 or self._ref is None or (trainer.epoch + 1) % self.every_n_epochs != 0:
            return
        if world()[0] != 0:  # rank 0's model group: the solves alone
            for _ in self._sample_batches(trainer):
                pass
            return
        from tinyedm_tpu_torch.utils.fid import (
            compute_stats,
            compute_stats_and_features,
            frechet_distance,
            kid_score,
        )

        mu2, s2, ref_feats = self._ref
        if self.kid:
            mu1, s1, feats = compute_stats_and_features(self._sample_batches(trainer), self._feature_fn,
                                                        max_features=max(self.kid_subset_size, len(ref_feats)))
        else:
            mu1, s1 = compute_stats(self._sample_batches(trainer), self._feature_fn)
        metrics = {"fid": frechet_distance(mu1, s1, mu2, s2)}
        if self.kid:
            metrics["kid"] = kid_score(feats, ref_feats, subset_size=self.kid_subset_size,
                                       num_subsets=self.kid_subsets)
        trainer.logger.log_metrics(metrics, step=trainer.global_step)
        trainer.extra_ckpt_metrics.update(metrics)
