"""Long-horizon training soak at the full CIFAR-10 recipe.

Counterpart of ``experiments/soak.py``. It runs the 35.62 M-parameter
CIFAR-10 train step of ``experiments/conf/cifar10.yaml`` (bf16 U-Net, forced
weight norm, EMA sigma_rel 0.13, lr 0.02), built through the port's
``load_config``, ``apply_overrides`` and ``instantiate``, for thousands of
steps on structured synthetic data (10 smooth class templates plus pixel
noise, std matched to sigma_data 0.5). At every logged step it checks that
the learning rate is the reference scheduler's formula (``ref_lr``, relative
5e-5) and that the loss is finite; a fresh run must also end below its first
logged loss. Class labels are fed where the recipe is conditional.

    python -m tinyedm_tpu_torch.soak --steps 8000 --mod_fp32 true --tag parity
    python -m tinyedm_tpu_torch.soak --rampup 100 --steady 200 --decay 100 \\
        --ckpt_every 200 --stop_at 300 --tag resume
    python -m tinyedm_tpu_torch.soak --rampup 100 --steady 200 --decay 100 \\
        --ckpt_every 200 --resume --tag resume     # continues at 300, in the decay phase

It writes ``runs/soak_<tag>/metrics.jsonl`` and ``summary.json`` (and with
``--ckpt_every``/``--save_ckpt`` checkpoints in the trainer's layout, with the
embedded config), prints ``RESULT: PASS|FAIL`` and exits 1 on FAIL. Batch i
is drawn from a generator seeded (seed, i), and step i's noise from
``folded_generator(seed + 1, i)``, so a resumed run trains on what an
unbroken one would have. ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from tinyedm_tpu_torch.config.registry import apply_overrides, deinstantiate, instantiate, load_config
from tinyedm_tpu_torch.models.edm import init_weights
from tinyedm_tpu_torch.training.checkpoint import CheckpointManager, save_checkpoint
from tinyedm_tpu_torch.training.state import TrainState
from tinyedm_tpu_torch.training.train_step import init_train_state, make_train_step
from tinyedm_tpu_torch.utils.cuda import folded_generator, resolve_device

CONFIG = Path(__file__).resolve().parents[1] / "experiments" / "conf" / "cifar10.yaml"
SIZE, CHANNELS = 32, 3


def make_templates(num_classes=10, size=32, channels=3, seed=7):
    """Smooth per-class templates (num_classes, size, size, channels):
    low-frequency random fields of std 0.5, validate_learning's data law at
    CIFAR's shape; bit-equal to the JAX experiment's."""
    rng = np.random.default_rng(seed)
    coeffs = rng.normal(size=(num_classes, channels, 4, 4))
    xs = np.linspace(0, 2 * np.pi, size)
    templates = np.zeros((num_classes, size, size, channels), np.float32)
    for c in range(num_classes):
        for ch in range(channels):
            field = sum(
                coeffs[c, ch, i, j]
                * np.outer(np.sin((i + 1) * xs + c), np.cos((j + 1) * xs - ch))
                for i in range(4)
                for j in range(4)
            )
            templates[c, :, :, ch] = field / (np.std(field) + 1e-8) * 0.5
    return templates


def draw_batch(templates: np.ndarray, seed: int, i: int, batch: int) -> tuple[np.ndarray, np.ndarray]:
    """Batch ``i`` (NHWC images, int32 classes), from ``default_rng((seed, i))``."""
    rng = np.random.default_rng((seed, i))
    cls = rng.integers(0, templates.shape[0], batch)
    noise = rng.normal(scale=0.1, size=(batch, SIZE, SIZE, CHANNELS)).astype(np.float32)
    return templates[cls] + noise, cls.astype(np.int32)


def ref_lr(step: int, lr: float, rampup: int, steady: int) -> float:
    """The reference scheduler's lr at ``step``, in float64: linear rampup
    from 1e-8 of ``lr``, steady, then ``lr / sqrt(1 + t / steady)``."""
    if step < rampup:
        return lr * (1e-8 + (1.0 - 1e-8) * step / max(rampup, 1))
    if step < rampup + steady:
        return lr
    return lr / math.sqrt(1.0 + (step - rampup - steady) / steady)


def spec_overrides(args: argparse.Namespace, steady_steps: int) -> list[str]:
    """The recipe's five overrides: modulation precision, lr, rampup, steady
    (the whole run without ``--decay``), and a per-step schedule."""
    return [
        f"model.denoiser.mod_fp32={args.mod_fp32}",
        f"model.lr={args.lr}",
        f"model.rampup_steps={args.rampup}",
        f"model.steady_steps={steady_steps}",
        "model.scheduler_interval=step",
    ]


def _restore(mngr: CheckpointManager, model, device) -> TrainState:
    """The latest checkpoint into ``model`` and a state over its parameters."""
    saved, _ = mngr.restore(device=device)
    model.load_state_dict({**saved.params, **saved.constants})
    return TrainState(step=saved.step, params=dict(model.named_parameters()),
                      constants=dict(model.named_buffers()), mu=saved.mu, nu=saved.nu,
                      count=saved.count, ema=saved.ema)


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--steps", type=int, default=8000)
    parser.add_argument("--mod_fp32", choices=["true", "false"], default="true")
    parser.add_argument("--rampup", type=int, default=500, help="LR rampup steps")
    parser.add_argument("--steady", type=int, default=None,
                        help="steady-phase steps; with --decay the run crosses the steady -> decay boundary "
                        "(default: the whole run is steady)")
    parser.add_argument("--decay", type=int, default=0,
                        help="inverse-sqrt decay steps past the steady phase; total = rampup + steady + decay")
    parser.add_argument("--lr", type=float, default=0.02)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tag", default="soak")
    parser.add_argument("--ckpt_every", type=int, default=0,
                        help="save a checkpoint (checkpoints/<step>/, embedded config) every N steps")
    parser.add_argument("--stop_at", type=int, default=None,
                        help="stop after this step (a checkpoint saved with --ckpt_every); --resume continues")
    parser.add_argument("--resume", action="store_true",
                        help="restore the latest checkpoints/<step>/ and continue the same schedule")
    parser.add_argument("--save_ckpt", action="store_true", help="save a checkpoint at the end, under ckpt/")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    if args.decay and args.steady is None:
        parser.error("--decay needs --steady (total = rampup + steady + decay)")
    steady_steps = args.steady if args.steady is not None else args.steps
    total_steps = args.rampup + args.steady + args.decay if args.decay else args.steps
    device = resolve_device(args.device)

    cfg = apply_overrides(load_config(CONFIG, resolve=False), spec_overrides(args, steady_steps))
    spec = instantiate(cfg["model"])
    model = spec.build_model()
    init_weights(model, torch.Generator().manual_seed(args.seed))
    model.to(device)
    opt_cfg = spec.build_optimizer_config()
    ema_cfg = spec.build_ema_config()
    conditional = model.conditional

    out_dir = Path("runs") / f"soak_{args.tag}"
    out_dir.mkdir(parents=True, exist_ok=True)
    log_path = out_dir / "metrics.jsonl"
    templates = make_templates()
    config = {"model": deinstantiate(spec), "seed": args.seed}

    ckpt_mngr = None
    if args.ckpt_every or args.resume:
        ckpt_mngr = CheckpointManager(out_dir / "checkpoints", max_to_keep=None, monitor=None)
    start_step = 0
    if args.resume:
        state = _restore(ckpt_mngr, model, device)
        start_step = state.step
        phase = "decay" if start_step >= args.rampup + steady_steps else "pre-decay"
        print(f"soak: resumed at step {start_step} ({phase} phase)", flush=True)
    else:
        state = init_train_state(model, opt_cfg, ema_cfg)
    step = make_train_step(model, spec.diffuser, opt_cfg, ema_cfg)

    stop_step = min(args.stop_at, total_steps) if args.stop_at else total_steps
    if start_step >= stop_step:
        print(f"soak: resumed step {start_step} >= stop step {stop_step}; nothing to do", flush=True)
        print("RESULT: PASS", flush=True)
        return 0
    # dense logging around both phase boundaries
    boundaries = {args.rampup, args.rampup + steady_steps}

    def logged(i: int) -> bool:
        return i % 100 == 0 or i == stop_step - 1 or any(abs(i - b) <= 2 for b in boundaries)

    print(f"soak: steps {start_step}..{stop_step} of {total_steps} (rampup {args.rampup} / steady "
          f"{steady_steps} / decay {total_steps - args.rampup - steady_steps}), mod_fp32={args.mod_fp32}, "
          f"lr {args.lr}, batch {args.batch}, {'conditional' if conditional else 'unconditional'}, device "
          f"{device} -> {log_path}", flush=True)
    first_loss, lr_checked, m = None, 0, None
    t_start = time.time()
    t_warm = None
    with open(log_path, "a" if args.resume else "w") as log_f:
        for i in range(start_step, stop_step):
            images, cls = draw_batch(templates, args.seed, i, args.batch)
            x = torch.from_numpy(images).to(device).permute(0, 3, 1, 2).contiguous()
            labels = torch.from_numpy(cls.astype(np.int64)).to(device) if conditional else None
            state, m = step(state, (x, labels), folded_generator(args.seed + 1, i, device), i)
            if i == start_step:
                float(m["train_loss"])  # the first step's set-up stays out of the rate
                t_warm = time.time()
            if logged(i):
                loss, lr = float(m["train_loss"]), float(m["learning_rate"])
                if first_loss is None:
                    first_loss = loss
                expect = ref_lr(i, args.lr, args.rampup, steady_steps)
                if not math.isclose(lr, expect, rel_tol=5e-5, abs_tol=1e-12):
                    print(f"RESULT: FAIL (lr off formula at step {i}: emitted {lr!r} vs reference {expect!r})",
                          flush=True)
                    return 1
                lr_checked += 1
                rec = {"step": i, "train_loss": loss, "lr": lr, "elapsed_s": round(time.time() - t_start, 1)}
                log_f.write(json.dumps(rec) + "\n")
                log_f.flush()
                print(f"step {i}: loss {loss:.4f} lr {lr:.6f}", flush=True)
                if not math.isfinite(loss):
                    print("RESULT: FAIL (non-finite loss)", flush=True)
                    return 1
            if ckpt_mngr and args.ckpt_every and ((i + 1) % args.ckpt_every == 0 or i == stop_step - 1):
                ckpt_mngr.save(i + 1, state, config=config)
    final_loss = float(m["train_loss"])
    elapsed = time.time() - t_warm
    steps_run = stop_step - start_step
    sps = max(steps_run - 1, 1) * args.batch / elapsed
    summary = {
        "mod_fp32": args.mod_fp32, "steps": stop_step,
        "rampup": args.rampup, "steady": steady_steps,
        "decay": total_steps - args.rampup - steady_steps,
        "resumed_at": start_step if args.resume else None,
        "first_loss": first_loss, "final_loss": final_loss,
        "lr_points_on_formula": lr_checked,
        "samples_per_s": round(sps, 1),
    }
    (out_dir / "summary.json").write_text(json.dumps(summary, indent=1))
    print("SUMMARY:", json.dumps(summary), flush=True)
    if args.save_ckpt:
        save_checkpoint(out_dir / "ckpt", state, config=config)
        print(f"checkpoint: {out_dir / 'ckpt'}", flush=True)
    # a short resumed tail sits on the loss plateau: descent is asserted for
    # fresh runs, finiteness and the lr formula for all
    ok = math.isfinite(final_loss) and (args.resume or final_loss < first_loss)
    print("RESULT:", "PASS" if ok else "FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
