"""Reference PNGs of the soak's synthetic data law, for FID sweeps.

Counterpart of ``experiments/soak_reference_pngs.py``. The soak
(``tinyedm_tpu_torch.soak``) trains on smooth class templates plus pixel
noise in normalized space. To score its checkpoints with ``eval_fid sweep``,
reference statistics need a sample of that same law rendered as generated
samples are: ``PreditionWriter``'s ``x * std * 2 + mean -> clamp [0, 1] ->
uint8`` with the CIFAR-10 mean and std. For the same arguments the pixels
are the JAX script's.

    python -m tinyedm_tpu_torch.soak_reference_pngs --out soak_ref/ --num 2048
    python -m tinyedm_tpu_torch.eval_fid stats --data-dir soak_ref/ --format png_dir --out soak_ref.npz
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np

from tinyedm_tpu_torch.generate import CIFAR10_MEAN, CIFAR10_STD
from tinyedm_tpu_torch.soak import make_templates
from tinyedm_tpu_torch.training.callbacks import PreditionWriter


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True)
    ap.add_argument("--num", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args(argv)

    templates = make_templates()
    rng = np.random.default_rng(args.seed)
    writer = PreditionWriter(args.out, "batch", CIFAR10_MEAN, CIFAR10_STD)
    for start in range(0, args.num, args.batch):
        n = min(args.batch, args.num - start)
        cls = rng.integers(0, templates.shape[0], n)
        x = templates[cls] + rng.normal(scale=0.1, size=(n, 32, 32, 3)).astype(np.float32)
        writer.write_batch(x, list(range(start, start + n)))
    print(f"wrote {args.num} reference PNGs to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
