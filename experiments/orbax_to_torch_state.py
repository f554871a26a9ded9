"""Convert a JAX package checkpoint (orbax) into the port's checkpoint layout.

    python experiments/orbax_to_torch_state.py --ckpt_dir runs/cifar10/checkpoints \
        --out_dir runs/cifar10_torch [--step N]

Runs where JAX and orbax are installed (the port itself imports neither). It
restores the step with ``tinyedm_tpu/training/checkpoint.py::load_checkpoint``,
unstacks ``scan_blocks`` groups, reads the Adam moments in whatever form orbax
restores them (the optax namedtuple, a ``{"0", "1", "2"}`` mapping or a
3-list), and writes ``<out_dir>/<step>/state.pt`` and ``config.json`` with the
params, constants, moments, Adam count, step, every EMA tree and the embedded
config, all through ``tinyedm_tpu_torch.utils.interop.train_state_from_jax``.
The port's trainer resumes from the result (``--resume`` with
``trainer.out_dir`` pointing at it) and ``generate --ckpt_path`` samples from it.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def convert(ckpt_dir: str | Path, out_dir: str | Path, step: Optional[int] = None):
    """Convert one step (the latest by default); returns the port's state."""
    import jax
    import numpy as np

    from tinyedm_tpu.training.checkpoint import load_checkpoint
    from tinyedm_tpu_torch.training.checkpoint import save_checkpoint
    from tinyedm_tpu_torch.utils.interop import train_state_from_jax

    jax_state, config = load_checkpoint(ckpt_dir, step)
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jax_state))
    save_checkpoint(out_dir, state, config)
    print(f"converted {ckpt_dir} (step {state.step}, {len(state.ema)} EMA tree(s)) -> {out_dir}")
    return state


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt_dir", required=True, help="the JAX package's checkpoint directory")
    p.add_argument("--out_dir", required=True, help="where the port's checkpoint goes")
    p.add_argument("--step", type=int, default=None, help="the step to convert (latest)")
    args = p.parse_args(argv)
    convert(args.ckpt_dir, args.out_dir, args.step)


if __name__ == "__main__":
    main()
