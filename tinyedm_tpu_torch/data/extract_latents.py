"""Latent extraction: encode an ImageFolder through the SD VAE on the card
and write per-sample ``{idx}.npy`` latents and labels.

Counterpart of ``tinyedm_tpu/data/extract_latents.py``, with its flags:

    python -m tinyedm_tpu_torch.data.extract_latents --data-dir DIR --out-dir OUT \\
        [--image-size 256] [--batch-size 64] [--vae stabilityai/sd-vae-ft-ema] [--seed 42] \\
        [--no-flip] [--device cuda]

The same steps: the ADM center crop (``data/images.py``, PIL's resampler in
numpy), flipped copies appended after the originals, pixels normalized with
``(x / 255 - 0.5) / 0.5``, ``encode_sample`` (one generator seeded ``seed``
on the device, drawn batch after batch), latents mapped to
``(z - LATENT_MEAN) / (LATENT_STD * 2)`` and written as float32 HWC, the
JAX package's layout, so both packages' readers and the latpack CLI take
them unchanged. The tail batch is padded with copies of its first image and
every sample is kept. The VAE weights are found by ``data.vae.load_vae``
(local files only).

Decoding and cropping run on a thread pool while the card encodes the
previous batch; the writes go through a bounded queue to writer threads, so
a slow disk holds the encoder back instead of growing a backlog in memory.
"""

from __future__ import annotations

import argparse
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from tinyedm_tpu_torch.data.images import JpegDecoder, center_crop_arr, list_image_folder, read_image
from tinyedm_tpu_torch.data.vae import DEFAULT_VAE

# the reference's latent statistics (tinyedm_tpu/data/extract_latents.py:25-26)
LATENT_MEAN = np.asarray([5.81, 3.25, 0.12, -2.15], np.float32)
LATENT_STD = np.asarray([4.17, 4.62, 3.71, 3.28], np.float32)
VAE_CHOICES = ("stabilityai/sd-vae-ft-ema", "stabilityai/sd-vae-ft-mse")
STAGES = ("decode", "crop", "encode", "write")


class BoundedWriter:
    """``np.save`` of (path, array) pairs on ``threads`` writer threads, fed
    through a queue of at most ``depth`` items: ``put`` blocks while it is
    full. The first error of a writer is raised by the next ``put`` or by
    ``close``, which waits for every write."""

    def __init__(self, threads: int = 4, depth: int = 256):
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self.seconds = 0.0  # summed over the writer threads
        self._threads = [threading.Thread(target=self._run, daemon=True) for _ in range(threads)]
        for t in self._threads:
            t.start()

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            t0 = time.perf_counter()
            try:
                np.save(*item)
            except OSError as e:
                with self._lock:
                    self._error = self._error or e
            with self._lock:
                self.seconds += time.perf_counter() - t0

    def _raise(self) -> None:
        if self._error is not None:
            raise self._error

    def put(self, path: Path, array: np.ndarray) -> None:
        self._raise()
        self._queue.put((path, array))

    def close(self) -> None:
        for _ in self._threads:
            self._queue.put(None)
        for t in self._threads:
            t.join()
        self._raise()


def extract(
    data_dir: str,
    out_dir: str,
    image_size: int = 256,
    batch_size: int = 64,
    vae_name: str = DEFAULT_VAE,
    seed: int = 42,
    flip: bool = True,
    vae=None,
    device=None,
    timings: Optional[dict] = None,
) -> int:
    """Encode the ImageFolder ``data_dir`` into ``out_dir/latents`` and
    ``out_dir/labels``; returns the number of samples written (twice the
    files with flips). ``vae``: an ``AutoencoderKL`` on ``device`` (loaded
    by ``vae_name`` when None). ``timings``, when given, receives the
    seconds of each stage: decode, crop and write summed over their threads,
    encode on the card's clock (CUDA events; the host clock on the CPU), and
    the wall time as ``total``."""
    from tinyedm_tpu_torch.utils.cuda import resolve_device

    t_start = time.perf_counter()
    dev = resolve_device(device)
    out_p = Path(out_dir)
    (out_p / "latents").mkdir(parents=True, exist_ok=True)
    (out_p / "labels").mkdir(parents=True, exist_ok=True)
    if vae is None:
        from tinyedm_tpu_torch.data.vae import load_vae

        vae = load_vae(vae_name, device=dev)
    files, labels, _ = list_image_folder(data_dir)
    # nvJPEG is built and loaded only for a folder with JPEGs in it
    has_jpeg = any(f.suffix.lower() in (".jpg", ".jpeg") for f in files)
    jpeg = JpegDecoder(dev) if dev.type == "cuda" and has_jpeg else None
    # originals, then the flipped copies (the reference's hflip-expanded dataset)
    entries = [(f, lab, False) for f, lab in zip(files, labels)]
    if flip:
        entries += [(f, lab, True) for f, lab in zip(files, labels)]
    n = len(entries)
    spent = dict.fromkeys(STAGES, 0.0)
    spent_lock = threading.Lock()

    def load_one(entry):
        path, label, flipped = entry
        t0 = time.perf_counter()
        image = read_image(path, jpeg)
        t1 = time.perf_counter()
        arr = center_crop_arr(image.pixels, image.mode, image_size, image.palette)
        if flipped:
            arr = arr[:, ::-1]
        x = (arr.astype(np.float32) / 255.0 - 0.5) / 0.5
        with spent_lock:
            spent["decode"] += t1 - t0
            spent["crop"] += time.perf_counter() - t1
        return x, label

    gen = torch.Generator(device=dev).manual_seed(seed)
    writer = BoundedWriter(depth=4 * batch_size)
    written = 0
    encode_events = []

    def drain(lat_dev, labs, start, real) -> None:
        nonlocal written
        lat = (lat_dev.permute(0, 2, 3, 1).float().cpu().numpy() - LATENT_MEAN) / (LATENT_STD * 2.0)
        for i in range(real):
            writer.put(out_p / "latents" / f"{start + i}.npy", lat[i])
            writer.put(out_p / "labels" / f"{start + i}.npy", np.asarray(labs[i]))
        written += real
        if (start // batch_size) % 20 == 0:
            print(f"{written}/{n} latents written", flush=True)

    # one-deep pipeline: batch k encodes on the card while the pool decodes
    # and crops batch k + 1; k's latents are copied back before k + 1's
    # encode is queued (a copy queued behind it would wait for it too)
    in_flight = None
    try:
        with ThreadPoolExecutor(max_workers=8) as pool, torch.no_grad():
            for start in range(0, n, batch_size):
                loaded = list(pool.map(load_one, entries[start : start + batch_size]))
                imgs = np.stack([x for x, _ in loaded])
                real = len(imgs)
                if real < batch_size:  # pad the tail: one batch shape throughout
                    imgs = np.concatenate([imgs, np.repeat(imgs[:1], batch_size - real, axis=0)])
                if in_flight is not None:
                    drain(*in_flight)
                x = torch.from_numpy(imgs).to(dev).permute(0, 3, 1, 2).contiguous()  # NCHW in memory too
                if dev.type == "cuda":
                    ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                    lat = vae.encode_sample(x, generator=gen)
                    ev[1].record()
                    encode_events.append(ev)
                else:
                    t0 = time.perf_counter()
                    lat = vae.encode_sample(x, generator=gen)
                    spent["encode"] += time.perf_counter() - t0
                in_flight = (lat, [lab for _, lab in loaded], start, real)
            if in_flight is not None:
                drain(*in_flight)
    finally:
        writer.close()
        if jpeg is not None:
            jpeg.close()
    spent["encode"] += sum(a.elapsed_time(b) for a, b in encode_events) / 1e3
    spent["write"] = writer.seconds
    if timings is not None:
        timings.update(spent, total=time.perf_counter() - t_start)
    return written


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Extract SD-VAE latents of an ImageFolder on the card")
    parser.add_argument("--data-dir", required=True, help="ImageFolder root")
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--image-size", type=int, default=256)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--vae", default=DEFAULT_VAE, choices=VAE_CHOICES)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--no-flip", action="store_true")
    parser.add_argument("--device", default=None, help="the card by default; 'cpu' to run there")
    args = parser.parse_args(argv)
    timings: dict = {}
    n = extract(args.data_dir, args.out_dir, args.image_size, args.batch_size, args.vae, args.seed,
                flip=not args.no_flip, device=args.device, timings=timings)
    stages = ", ".join(f"{k} {timings[k]:.3f} s" for k in STAGES)
    print(f"wrote {n} latents to {args.out_dir} in {timings['total']:.3f} s ({n / timings['total']:.2f} img/s; "
          f"{stages})", flush=True)
    return n


if __name__ == "__main__":
    main()
