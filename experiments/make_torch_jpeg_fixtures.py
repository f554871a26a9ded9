"""Write the small JPEG fixtures of the port's JPEG reader, and PIL's decode
of each, into tests/torch_fixtures/.

    python experiments/make_torch_jpeg_fixtures.py [--out-dir tests/torch_fixtures]

Needs Pillow (the machine with the card has none; the files are committed).
Each fixture is a seeded structured image (gradients, a disc, mild noise)
saved by PIL at quality 90: 4:2:0, 4:2:2 and 4:4:4 chroma subsampling at odd
sizes, a greyscale JPEG, a progressive one, and a CMYK one (Adobe
transform 0, 4:4:4). Beside each file, ``<name>.npy`` holds PIL's pixels as
RGB uint8 (``convert("RGB")``: grey repeated, CMYK through Pillow's
``cmyk2rgb``), the reference that chip_smoke.py holds nvJPEG's decode
against (mean abs <= 1 level).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

# name -> (width, height, PIL mode, save options)
FIXTURES = {
    "rgb420": (67, 45, "RGB", {"subsampling": "4:2:0"}),
    "rgb422": (50, 37, "RGB", {"subsampling": "4:2:2"}),
    "rgb444": (53, 71, "RGB", {"subsampling": "4:4:4"}),
    "grey": (41, 33, "L", {}),
    "progressive": (64, 48, "RGB", {"subsampling": "4:2:0", "progressive": True}),
    "cmyk": (32, 24, "CMYK", {}),
}


def structured(w: int, h: int, channels: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    disc = ((yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (min(w, h) / 3) ** 2) * 90.0
    planes = [(255 * xx / w * (c + 1) / channels + 200 * yy / h * (channels - c) / channels + disc) % 256
              for c in range(channels)]
    img = np.stack(planes, axis=-1) + rng.normal(0, 6, (h, w, channels))
    return np.clip(img, 0, 255).astype(np.uint8)


def main() -> None:
    from PIL import Image

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out-dir", default=str(Path(__file__).resolve().parent.parent / "tests" / "torch_fixtures"))
    out = Path(p.parse_args().out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for seed, (name, (w, h, mode, options)) in enumerate(FIXTURES.items()):
        img = structured(w, h, len(mode), seed)
        pil = Image.fromarray(img[..., 0] if mode == "L" else img, mode)
        path = out / f"{name}.jpg"
        pil.save(path, quality=90, **options)
        with Image.open(path) as im:
            np.save(out / f"{name}.npy", np.asarray(im.convert("RGB")))
        print(f"{path.name}: {w}x{h} {mode} {options} {path.stat().st_size} bytes, "
              f"PIL's RGB decode in {name}.npy")


if __name__ == "__main__":
    main()
