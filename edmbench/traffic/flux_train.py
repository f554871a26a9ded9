"""Traffic kind ``flux_train``: the port's training step on a FLUX
configuration, batch after batch, on cached text embeddings.

Cell parameters (``params`` of the cell file), as the ``train`` kind's:
``batch`` (samples a step, split into the configuration's microbatches),
``pool`` (distinct batches drawn in set-up and fed in turn),
``check_steps`` (the first steps, which set-up drives and the reference
follows), ``trace_units`` (steps profiled in a traced run).

Set-up draws the batches on the host from the seed, as a fine-tune on
cached embeddings reads them: N(0, 1) latents (``image_size`` square,
``latent_channels`` deep), N(0, 1) text tokens (``txt_len`` of
``context_in_dim``) and pooled vectors (``vec_in_dim``), and the
configuration's guidance value. It draws the weights on the card
(``reference/flux.py::draw_weights``), builds the port's ``EDM`` of the
configuration's ``FluxEmbedding`` and ``FluxDenoiser``, one train state and
one ``make_train_step`` step (caption dropout, Adam at the recipe's constant
lr, the power-EMA profiles), and drives them through ``check_steps`` steps,
reading what ``correct`` compares (``harness.train_gaps`` against
``reference/flux.py::train``). The window goes on with that same state; each
step copies its latents and its ``TextConditioning`` to the card. A program
without ``models/flux.py`` fails at set-up, on the import.

The steps, the fence, the checked readings and the check are the ``train``
kind's (its ``Job``). ``work`` gives, per step, the model's operations (3
forwards a sample, ``work_flux.py``), the least times of the GEMMs and of
the flash kernels, and the forwards. Set-up prints the flash kernels' calls
and the QK-norm-RoPE Function's per step over the checked steps.
"""

from __future__ import annotations

import sys
import time
from collections import Counter

import numpy as np
import torch

from edmbench import work_flux
from edmbench.harness import derive_seed
from edmbench.reference.flux import draw_weights
from edmbench.reference.flux import train as train_flux
from edmbench.reference.precision import PRECISIONS
from edmbench.reference.train import Readings
from edmbench.traffic import train

UNIT = "step"
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def port_model(cfg: dict, device, weights: dict):
    """The port's EDM of the FLUX ``cfg``, built under the meta device,
    placed on ``device`` uninitialized and filled with ``weights`` (strictly)."""
    from tinyedm_tpu_torch.models.edm import EDM
    from tinyedm_tpu_torch.models.flux import FluxDenoiser, FluxEmbedding

    den = dict(cfg["denoiser"])
    dtype = DTYPES[den.pop("dtype")]
    with torch.device("meta"):
        model = EDM(FluxEmbedding(**cfg["embedding"]), FluxDenoiser(**den, dtype=dtype))
    model = model.to_empty(device=device)
    model.load_state_dict(weights)
    return model


def per_step(counts: Counter, before: dict, steps: int) -> str:
    return ", ".join(f"{kind} n={n}: {(v - before.get((kind, n), 0)) / steps:g}"
                     for (kind, n), v in sorted(counts.items()) if v != before.get((kind, n), 0)) or "none"


class Job(train.Job):
    """The ``train`` kind's job (its steps, fence, checked readings and
    check) on FLUX: its own model, inputs, weights, work and reference."""

    def __init__(self, ctx):
        from tinyedm_tpu_torch.data.datamodules import to_device
        from tinyedm_tpu_torch.diffusion.diffuser import Diffuser
        from tinyedm_tpu_torch.diffusion.protocols import TextConditioning
        from tinyedm_tpu_torch.ops.attention import launch_counts
        from tinyedm_tpu_torch.ops.rope import call_counts
        from tinyedm_tpu_torch.training.ema import EMAConfig
        from tinyedm_tpu_torch.training.train_step import (
            OptimizerConfig,
            init_train_state,
            make_train_step,
        )

        stamps = [time.perf_counter()]
        self.ctx, cfg, p = ctx, ctx.config, ctx.cell["params"]
        t = cfg["training"]
        self.dev = ctx.device
        self.batch = p["batch"]
        self.items_per_unit = self.batch
        self.trace_units = p["trace_units"]
        self.check_steps = p["check_steps"]
        self.first_unit = p["check_steps"]  # the window goes on after the checked steps

        def feed(images: np.ndarray, cond: tuple, device) -> tuple:
            txt, y, guidance = (torch.from_numpy(a).to(device) for a in cond)
            return to_device(images, None, device)[0], TextConditioning(txt, y, guidance)

        self.to_device = feed
        side, ch = cfg["image_size"], cfg["latent_channels"]
        rng = np.random.default_rng(derive_seed(ctx.seed, "data"))
        self.images, self.labels = [], []
        for _ in range(p["pool"]):
            self.images.append(rng.standard_normal((self.batch, side, side, ch), dtype=np.float32))
            self.labels.append((
                rng.standard_normal((self.batch, cfg["txt_len"], cfg["denoiser"]["context_in_dim"]),
                                    dtype=np.float32),
                rng.standard_normal((self.batch, cfg["embedding"]["vec_in_dim"]), dtype=np.float32),
                np.full((self.batch,), t["guidance"], np.float32)))
        stamps.append(time.perf_counter())
        self.model = port_model(cfg, self.dev, draw_weights(cfg, derive_seed(ctx.seed, "weights"), self.dev))
        self.opt = OptimizerConfig(lr=t["lr"], betas=tuple(t["betas"]), eps=t["eps"],
                                   rampup_steps=t["rampup_steps"], steady_steps=t["steady_steps"],
                                   scheduler_interval=t["scheduler_interval"], accum_steps=t["accum_steps"],
                                   label_dropout=t["label_dropout"])
        ema = EMAConfig(sigma_rels=tuple(t["ema_lengths"]), every_n_steps=t["every_n_steps"])
        self.state = init_train_state(self.model, self.opt, ema)
        self.step_fn = make_train_step(self.model, Diffuser(**t["diffuser"]), self.opt, ema)
        stamps.append(time.perf_counter())
        flash, rope = dict(launch_counts), dict(call_counts)
        self.readings = self._first_steps()
        print(f"flash kernel calls a step: {per_step(launch_counts, flash, self.check_steps)}; "
              f"qk_norm_rope calls a step: {per_step(call_counts, rope, self.check_steps)}", file=sys.stderr)
        stamps.append(time.perf_counter())
        self.setup_parts = dict(zip(("inputs", "weights and state", "checked steps"),
                                    (b - a for a, b in zip(stamps, stamps[1:]))))
        per_mb = self.batch // t["accum_steps"]
        self.work = {
            "flops": self.batch * 3 * work_flux.forward_flops(cfg),
            "gemm_bound_s": t["accum_steps"] * work_flux.gemm_bound_s(cfg, per_mb, train=True),
            "flash_bound_s": t["accum_steps"] * work_flux.flash_bound_s(cfg, per_mb, train=True),
            "forwards": t["accum_steps"],
        }

    def reference(self, precision: str = "fp32", half_batch: bool = False) -> Readings:
        """The reference (or the control, ``precision="fp8"``) over the checked steps."""
        cfg = self.ctx.config
        weights = draw_weights(cfg, derive_seed(self.ctx.seed, "weights"), self.dev)
        batches = [(torch.from_numpy(self.images[s]).permute(0, 3, 1, 2).contiguous().to(self.dev),
                    tuple(torch.from_numpy(a).to(self.dev) for a in self.labels[s]))
                   for s in range(self.check_steps)]
        seeds = [self.gen_seed(s) for s in range(self.check_steps)]
        return train_flux(cfg, weights, batches, seeds, self.check_steps, PRECISIONS[precision], half_batch)


def setup(ctx) -> Job:
    return Job(ctx)
