"""Post-hoc EMA reconstruction CLI (EDM2, Karras et al. 2023, Algorithm 3).

Counterpart of ``tinyedm_tpu/posthoc_ema.py`` over the port's checkpoints:
the EMA snapshots of every tracked profile at the checkpoint steps given
(the latest by default) are combined into the EMA that a run tracking the
target ``sigma_rel`` would hold at the latest of them, and written as a new
checkpoint whose params and one EMA tree are that combination; its embedded
config declares that one profile (``ema_length`` the target,
``ema_lengths`` None, ``val_ema_index`` 0), so a resume finds the one tree
it expects. ``generate --ckpt_path <out_dir> --load_ema`` samples from it.
The weights are solved in numpy fp64, the trees combined in fp32 on
``--device`` (the card unless ``cpu`` is asked for).

    python -m tinyedm_tpu_torch.posthoc_ema --ckpt_path runs/imagenet512/checkpoints \\
        --target_sigma_rel 0.10 --out_dir runs/imagenet512/posthoc_010 [--steps 5000 10000]
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import torch

from tinyedm_tpu_torch.config.registry import deinstantiate, instantiate
from tinyedm_tpu_torch.training.checkpoint import CheckpointManager, save_checkpoint
from tinyedm_tpu_torch.training.ema import reconstruct_posthoc_ema, sigma_rel_to_gamma
from tinyedm_tpu_torch.training.state import TrainState
from tinyedm_tpu_torch.utils.cuda import resolve_device


def reconstruct(
    ckpt_path: str,
    target_sigma_rel: float,
    out_dir: str,
    steps: Optional[list[int]] = None,
    device: Optional[str | torch.device] = None,
) -> TrainState:
    """Write the reconstruction of ``target_sigma_rel`` from the checkpoints
    at ``steps`` (None or empty: the latest) to ``out_dir``; returns the
    written state (its trees on ``device``)."""
    dev = resolve_device(device)
    mngr = CheckpointManager(ckpt_path, max_to_keep=None, monitor=None)
    all_steps = steps or [mngr.latest_step]
    snapshots, snap_steps, snap_gammas = [], [], []
    state = config = spec = None
    for s in all_steps:
        state, config = mngr.restore(s, device=dev)
        if not config or "model" not in config:
            raise ValueError("checkpoint lacks embedded config")
        spec = instantiate(config["model"])
        ema_cfg = spec.build_ema_config()
        if ema_cfg is None or not state.ema:
            raise ValueError(f"checkpoint step {s} has no EMA profiles")
        if len(state.ema) != len(ema_cfg.gammas):
            # zipping would pair trees with the wrong gammas: a plausible
            # but wrong reconstruction
            raise ValueError(
                f"checkpoint step {s} stores {len(state.ema)} EMA tree(s) but its config declares "
                f"{len(ema_cfg.gammas)} profile(s) (sigma_rels {tuple(ema_cfg.sigma_rels)}); cannot pair "
                "trees with gammas unambiguously"
            )
        for tree, gamma in zip(state.ema, ema_cfg.gammas):
            snapshots.append(tree)
            snap_steps.append(int(state.step))
            snap_gammas.append(gamma)
    print(
        f"combining {len(snapshots)} EMA snapshots (gammas {[round(g, 2) for g in snap_gammas]}, "
        f"steps {snap_steps}) -> sigma_rel={target_sigma_rel} (gamma={sigma_rel_to_gamma(target_sigma_rel):.3f})"
    )
    combined = reconstruct_posthoc_ema(snapshots, snap_steps, snap_gammas, target_sigma_rel)
    del snapshots
    new_state = dataclasses.replace(state, params=combined, ema=(combined,))
    out_spec = dataclasses.replace(spec, use_ema=True, ema_length=target_sigma_rel, ema_lengths=None,
                                   val_ema_index=0)
    out_config = {**config, "model": deinstantiate(out_spec)}
    save_checkpoint(out_dir, new_state, out_config)
    print(f"wrote reconstructed checkpoint to {out_dir}")
    return new_state


def main(argv=None) -> TrainState:
    p = argparse.ArgumentParser(description="Post-hoc EMA reconstruction")
    p.add_argument("--ckpt_path", required=True)
    p.add_argument("--target_sigma_rel", type=float, required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--steps", type=int, nargs="*", default=None,
                   help="checkpoint steps to combine (default, or an empty list: the latest only)")
    p.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    return reconstruct(args.ckpt_path, args.target_sigma_rel, args.out_dir, args.steps, args.device)


if __name__ == "__main__":
    main()
