"""Generative-learning validation without external datasets.

Counterpart of ``experiments/validate_learning.py``. It trains a small
conditional EDM on a synthetic dataset with known structure (each class c
is a fixed smooth template T_c plus small pixel noise), samples from the EMA
weights, and checks that each class's sample mean recovers its template:
cosine similarity above 0.9 to its own template and 0.1 above the best
other. That closes diffuse -> train -> EMA -> sample with a criterion that
can fail, which the unit tests cannot.

    python -m tinyedm_tpu_torch.validate_learning             # the card; RESULT: PASS|FAIL
    python -m tinyedm_tpu_torch.validate_learning --guided --autoguided --solver dpmpp2m
    python -m tinyedm_tpu_torch.validate_learning --device cpu   # slow: 1500 steps at 256

``--guided`` trains with label dropout 0.15 and also requires classifier-free
guidance at scale 2 (plain and on the interval (0.1, 2.0)) to keep each
class above 0.9 with a margin no more than 0.02 below the unguided one;
``--autoguided`` does the same for autoguidance at 1.5 and 2.0 by the EMA
snapshot of step 300; ``--solver dpmpp2m`` samples with DPM-Solver++(2M)-18
instead of Heun-18. It exits 1 on FAIL.

The stages are functions (``make_dataset``, ``build_model``, ``train``,
``sample``, ``class_sims``) so that they can run at a few steps; ``run``
chains them, calling ``stage(name)`` after each, and returns the numbers.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from tinyedm_tpu_torch.diffusion.diffuser import Diffuser
from tinyedm_tpu_torch.diffusion.guidance import autoguidance_denoise_fn, cfg_denoise_fn
from tinyedm_tpu_torch.diffusion.solver import DeterministicSolver, MultistepSolver
from tinyedm_tpu_torch.models.edm import EDM, init_weights
from tinyedm_tpu_torch.models.layers import Embedding
from tinyedm_tpu_torch.models.unet import Denoiser
from tinyedm_tpu_torch.training.ema import EMAConfig
from tinyedm_tpu_torch.training.state import TrainState
from tinyedm_tpu_torch.training.train_step import OptimizerConfig, init_train_state, make_train_step
from tinyedm_tpu_torch.utils.cuda import folded_generator, resolve_device

NUM_CLASSES, SIZE = 4, 16
BATCH, STEPS, LOG_EVERY = 256, 1500, 300
GUIDE_STEP = 300  # the autoguide: the same run's EMA, a fifth trained
N_PER = 64  # samples a class
SOLVER_STEPS = 18
GUIDANCE_SCALE = 2.0
CFG_RUNS = (("cfg2", None), ("cfg2-interval", (0.1, 2.0)))
AUTO_SCALES = (1.5, 2.0)
BATCH_SEED, STEP_SEED, NOISE_SEED, INIT_SEED = 1, 2, 3, 0


def make_dataset(num_classes=4, size=16, n_per_class=512, seed=0):
    """(images (N, H, W, 1) fp32, labels (N,) int32, templates (C, H, W, 1)):
    smooth per-class templates (low-frequency random fields, std 0.5) plus
    pixel noise of std 0.1; bit-equal to the JAX experiment's."""
    rng = np.random.default_rng(seed)
    freqs = rng.normal(size=(num_classes, 3, 3, 1))
    xs = np.linspace(0, 2 * np.pi, size)
    templates = []
    for c in range(num_classes):
        field = sum(
            freqs[c, i, j, 0]
            * np.outer(np.sin((i + 1) * xs + c), np.cos((j + 1) * xs - c))
            for i in range(3)
            for j in range(3)
        )
        field = field / (np.std(field) + 1e-8) * 0.5
        templates.append(field[..., None].astype(np.float32))
    templates = np.stack(templates)

    images, labels = [], []
    for c in range(num_classes):
        noise = rng.normal(scale=0.1, size=(n_per_class, size, size, 1)).astype(np.float32)
        images.append(templates[c][None] + noise)
        labels.append(np.full((n_per_class,), c, np.int32))
    return np.concatenate(images), np.concatenate(labels), templates


def build_model(mod_fp32: bool = True, device=None, dtype: torch.dtype = torch.bfloat16) -> EDM:
    """The validation model (widths 64/96, attention at 8x8 with 2 heads of
    48, dropout 0.05), weights drawn from seed 0, on ``device``."""
    model = EDM(
        Embedding(fourier_dim=32, embedding_dim=64, num_classes=NUM_CLASSES),
        Denoiser(
            in_channels=1,
            out_channels=1,
            embedding_dim=64,
            num_heads=2,
            sigma_data=0.5,
            encoder_block_types=("Enc", "Enc", "EncD", "EncA"),
            decoder_block_types=("DecA", "Dec", "DecU", "Dec", "Dec", "Dec"),
            encoder_out_channels=(64, 64, 96, 96),
            decoder_out_channels=(96, 96, 64, 64, 64, 64),
            skip_connections=(True, True, False, True, True, True),
            dropout_rate=0.05,
            dtype=dtype,
            mod_fp32=mod_fp32,
        ),
    )
    init_weights(model, torch.Generator().manual_seed(INIT_SEED))
    return model.to(resolve_device(device))


def snapshot(tree: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A copy of ``tree`` that later steps leave alone: the step updates the
    state in place, so a view would follow the live tree."""
    return {k: v.detach().clone() for k, v in tree.items()}


def train(model: EDM, images: np.ndarray, labels: np.ndarray, steps: int = STEPS, guided: bool = False,
          batch_size: int = BATCH, guide_step: Optional[int] = None, log_every: int = LOG_EVERY,
          log: Callable[[str], None] = print) -> dict:
    """``steps`` train steps at ``batch_size`` (batches drawn with
    replacement by ``default_rng(1)``, as in the JAX experiment; step i's
    draws from ``folded_generator(2, i)``): lr 0.006 ramped over 100 steps,
    steady for 2000, per step; EMA sigma_rel 0.13; label dropout 0.15 when
    ``guided``. Returns the state, the EMA snapshot taken after step
    ``guide_step`` (or None), the losses logged, and the timings."""
    device = next(model.parameters()).device
    opt = OptimizerConfig(lr=0.006, rampup_steps=100, steady_steps=2000, scheduler_interval="step",
                          label_dropout=0.15 if guided else 0.0)
    ema_cfg = EMAConfig(sigma_rels=(0.13,))
    state = init_train_state(model, opt, ema_cfg)
    step = make_train_step(model, Diffuser(P_mean=-1.2, P_std=1.2), opt, ema_cfg)
    data = torch.from_numpy(images.transpose(0, 3, 1, 2).copy()).to(device)
    classes = torch.from_numpy(labels.astype(np.int64)).to(device)
    rng = np.random.default_rng(BATCH_SEED)
    guide, losses, m = None, {}, None
    t0 = time.perf_counter()
    t_warm = None
    for i in range(steps):
        idx = torch.from_numpy(rng.integers(0, len(images), batch_size)).to(device)
        state, m = step(state, (data[idx], classes[idx]), folded_generator(STEP_SEED, i, device), i)
        if i == 0:
            float(m["train_loss"])  # the first step's set-up stays out of the rate
            t_warm = time.perf_counter()
        if i == guide_step:
            guide = snapshot(state.ema[0])
        if i % log_every == 0:
            losses[i] = float(m["train_loss"])
            log(f"step {i}: loss {losses[i]:.4f}")
    final = float(m["train_loss"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    return {"state": state, "guide": guide, "losses": losses, "final_loss": final, "seconds": t1 - t0,
            "ms_per_step": 1e3 * (t1 - t_warm) / max(steps - 1, 1)}


def denoiser(model: EDM, weights: dict[str, torch.Tensor]):
    """``denoise_fn(x, sigma, labels)`` of ``model`` holding ``weights``
    (params by name, such as an EMA tree), without a swap."""
    def fn(x, sigma, labels):
        return torch.func.functional_call(model, weights, (x, sigma, labels))
    return fn


def make_solver(name: str, num_steps: int = SOLVER_STEPS):
    return MultistepSolver(num_steps=num_steps) if name == "dpmpp2m" else DeterministicSolver(num_steps=num_steps)


@torch.no_grad()
def sample(denoise_fn, solver, x0: torch.Tensor, labels: torch.Tensor) -> np.ndarray:
    """One solve from ``x0`` (NCHW); the samples as NHWC numpy."""
    return solver.solve(denoise_fn, x0, labels).float().permute(0, 2, 3, 1).cpu().numpy()


def class_sims(samples: np.ndarray, labels: np.ndarray, templates: np.ndarray) -> list[tuple[float, float]]:
    """(own-sim, best-other-sim) per class: the cosine similarity of each
    class's sample mean to the generating templates."""
    out = []
    for c in range(templates.shape[0]):
        mean_c = samples[labels == c].mean(axis=0).reshape(-1)
        sims = []
        for c2 in range(templates.shape[0]):
            t = templates[c2].reshape(-1)
            sims.append(float(mean_c @ t / (np.linalg.norm(mean_c) * np.linalg.norm(t) + 1e-8)))
        out.append((sims[c], max(s for i, s in enumerate(sims) if i != c)))
    return out


def identity_ok(own: float, best_other: float) -> bool:
    """The class-identity criterion of an unguided solve."""
    return own > 0.9 and own > best_other + 0.1


def guided_ok(own: float, best_other: float, base: tuple[float, float]) -> bool:
    """A guided solve keeps the identity and shrinks the class margin by no
    more than 0.02 from the unguided ``base``."""
    return own > 0.9 and own - best_other > base[0] - base[1] - 0.02


def run(mod_fp32: bool = True, guided: bool = False, solver: str = "heun", autoguided: bool = False,
        device=None, steps: int = STEPS, batch_size: int = BATCH, n_per: int = N_PER,
        guide_step: int = GUIDE_STEP, solver_steps: int = SOLVER_STEPS, log: Callable[[str], None] = print,
        stage: Callable[[str], None] = lambda name: None) -> dict:
    """The whole check; ``stage(name)`` is called after each of "train",
    "sample", the CFG runs and the autoguidance runs. Returns ``ok``, the
    sims (``base``, and ``guided[tag]`` as (own, best other, margin, base
    margin, ok) per class), the losses and the timings."""
    dev = resolve_device(device)
    images, labels, templates = make_dataset(NUM_CLASSES, SIZE)
    log(f"dataset: {images.shape}, {NUM_CLASSES} classes; device {dev}")
    model = build_model(mod_fp32, dev)
    trained = train(model, images, labels, steps, guided, batch_size,
                    guide_step if autoguided else None, log=log)
    stage("train")
    log(f"trained {steps} steps in {trained['seconds']:.1f}s ({trained['ms_per_step']:.3f} ms a step), "
        f"final loss {trained['final_loss']:.4f}")
    state: TrainState = trained["state"]

    sampler = make_solver(solver, solver_steps)
    ema = denoiser(model, state.ema[0])
    x0 = torch.randn((n_per * NUM_CLASSES, 1, SIZE, SIZE),
                     generator=torch.Generator(device=dev).manual_seed(NOISE_SEED), device=dev)
    labs = torch.arange(NUM_CLASSES, device=dev).repeat_interleave(n_per)
    labs_np = labs.cpu().numpy()
    seconds = {}

    def timed(tag, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[tag] = time.perf_counter() - t0
        stage(tag)
        return out

    base = class_sims(timed("sample", lambda: sample(ema, sampler, x0, labs)), labs_np, templates)
    ok = True
    for c, (own, best_other) in enumerate(base):
        good = identity_ok(own, best_other)
        ok &= good
        log(f"class {c}: own-sim {own:.3f}, best-other {best_other:.3f}  [{'OK' if good else 'FAIL'}]")

    runs = []
    if guided:
        runs += [(tag, cfg_denoise_fn(ema, GUIDANCE_SCALE, interval=interval)) for tag, interval in CFG_RUNS]
    if autoguided:
        guide = denoiser(model, trained["guide"])
        runs += [(f"auto{scale}", autoguidance_denoise_fn(ema, guide, scale)) for scale in AUTO_SCALES]
    guided_sims = {}
    for tag, fn in runs:
        rows = []
        for c, (own, best_other) in enumerate(class_sims(timed(tag, lambda: sample(fn, sampler, x0, labs)),
                                                          labs_np, templates)):
            good = guided_ok(own, best_other, base[c])
            ok &= good
            margin, margin_base = own - best_other, base[c][0] - base[c][1]
            rows.append((own, best_other, margin, margin_base, good))
            log(f"[{tag}] class {c}: own-sim {own:.3f} (margin {margin:.3f} vs base {margin_base:.3f})  "
                f"[{'OK' if good else 'FAIL'}]")
        guided_sims[tag] = rows
    log(f"RESULT: {'PASS' if ok else 'FAIL'}")
    return {"ok": ok, "base": base, "guided": guided_sims, "losses": trained["losses"],
            "final_loss": trained["final_loss"], "train_s": trained["seconds"],
            "ms_per_step": trained["ms_per_step"], "sample_s": seconds}


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--mod_fp32", choices=["true", "false"], default="true",
                        help="fp32 (reference-parity) or bf16 modulation islands")
    parser.add_argument("--guided", action="store_true",
                        help="train with label dropout 0.15; require CFG at scale 2, plain and on (0.1, 2.0), "
                        "to keep the class identity against the unguided baseline")
    parser.add_argument("--solver", default="heun", choices=["heun", "dpmpp2m"],
                        help="Heun-18 (35 forwards) or DPM-Solver++(2M)-18 (18 forwards)")
    parser.add_argument("--autoguided", action="store_true",
                        help="autoguide the final EMA with its own snapshot of step 300, at 1.5 and 2.0")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    result = run(mod_fp32=args.mod_fp32 == "true", guided=args.guided, solver=args.solver,
                 autoguided=args.autoguided, device=args.device)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
