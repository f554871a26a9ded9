"""Traffic kind ``train``: the port's training step, batch after batch.

Cell parameters (``params`` of the cell file): ``batch`` (samples a step,
split into the configuration's microbatches), ``pool`` (distinct batches
drawn in set-up and fed in turn), ``check_steps`` (the first steps, which
set-up drives and the reference follows), ``trace_units`` (steps profiled in
a traced run).

Set-up draws the batches on the host from the seed (N(0, 0.5) images or
latents, labels uniform over the classes) and the weights on the card,
builds one train state and one step function, and drives them through
``check_steps`` steps, reading what ``correct`` compares. The window goes on
with that same state: each step copies its batch to the card with the data
modules' ``to_device`` and runs ``make_train_step``'s step with a generator
seeded for that step, at the recipe's full lr.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from edmbench import work
from edmbench.harness import checks_from, derive_seed, port_model, train_gaps
from edmbench.reference.model import conditional, draw_weights
from edmbench.reference.precision import PRECISIONS
from edmbench.reference.train import Readings, train

UNIT = "step"


class Job:
    def __init__(self, ctx):
        from tinyedm_tpu_torch.data.datamodules import to_device
        from tinyedm_tpu_torch.diffusion.diffuser import Diffuser
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
        self.to_device = to_device
        side, ch = cfg["image_size"], cfg["denoiser"]["in_channels"]
        rng = np.random.default_rng(derive_seed(ctx.seed, "data"))
        self.images = [rng.standard_normal((self.batch, side, side, ch), dtype=np.float32) * 0.5
                       for _ in range(p["pool"])]
        n_classes = cfg["embedding"]["num_classes"] if conditional(cfg) else None
        self.labels = [rng.integers(0, n_classes, self.batch) if n_classes else None for _ in range(p["pool"])]
        stamps.append(time.perf_counter())
        self.model = port_model(cfg, self.dev, draw_weights(cfg, derive_seed(ctx.seed, "weights"), self.dev))
        self.opt = OptimizerConfig(lr=t["lr"], betas=tuple(t["betas"]), eps=t["eps"],
                                   rampup_steps=t["rampup_steps"], steady_steps=t["steady_steps"],
                                   scheduler_interval=t["scheduler_interval"], accum_steps=t["accum_steps"])
        ema = EMAConfig(sigma_rels=tuple(t["ema_lengths"]), every_n_steps=t["every_n_steps"])
        self.state = init_train_state(self.model, self.opt, ema)
        self.step_fn = make_train_step(self.model, Diffuser(**t["diffuser"]), self.opt, ema)
        stamps.append(time.perf_counter())
        self.readings = self._first_steps()
        stamps.append(time.perf_counter())
        self.setup_parts = dict(zip(("inputs", "weights and state", "checked steps"),
                                    (b - a for a, b in zip(stamps, stamps[1:]))))
        per_mb = self.batch // t["accum_steps"]
        self.work = {
            "flops": self.batch * 3 * work.forward_flops(cfg, train=True),
            "attention_bound_s": t["accum_steps"] * work.attention_bound_s(cfg, per_mb, train=True),
            "conv_bound_s": t["accum_steps"] * work.conv_bound_s(cfg, per_mb, train=True),
            "forwards": t["accum_steps"],
        }

    def gen_seed(self, step: int) -> int:
        return derive_seed(self.ctx.seed, "step", step)

    def unit(self, step: int) -> dict:
        """Enqueue training step ``step``; its metrics, on the card."""
        t = self.ctx.config["training"]
        count = t["full_lr_count"] + (step if t["scheduler_interval"] == "step" else 0)
        with torch.profiler.record_function("edmbench.feed"):
            k = step % len(self.images)
            batch = self.to_device(self.images[k], self.labels[k], self.dev)
            gen = torch.Generator(device=self.dev).manual_seed(self.gen_seed(step))
        with torch.profiler.record_function("edmbench.train_step"):
            _, metrics = self.step_fn(self.state, batch, gen, count)
        return metrics

    @staticmethod
    def fence(metrics: dict) -> None:
        metrics["train_loss"].item()

    def _first_steps(self) -> Readings:
        """Drive the state through the checked steps; the program's readings."""
        params = self.state.params
        p0 = [p.detach().clone() for p in params.values()]
        b1 = self.opt.betas[0]
        sse, grads = [], None
        for step in range(self.check_steps):
            sse.append(self.unit(step)["sse"])
            if grads is None:  # Adam's first moment after one step is (1 - b1) g
                grads = torch._foreach_norm(list(self.state.mu.values()))
        change = torch._foreach_norm(torch._foreach_sub(list(params.values()), p0))
        emas = [torch._foreach_norm(torch._foreach_sub(list(e.values()), p0)) for e in self.state.ema]
        del p0
        names = list(params)

        def host(norms, scale=1.0):
            return dict(zip(names, (torch.stack(norms) * scale).tolist()))

        return Readings([float(v) for v in sse], host(grads, 1.0 / (1.0 - b1)), host(change),
                        [host(e) for e in emas])

    def release(self) -> None:
        del self.model, self.state, self.step_fn
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "fp32", half_batch: bool = False) -> Readings:
        """The reference (or the control, ``precision="fp8"``) over the checked steps."""
        cfg = self.ctx.config
        weights = draw_weights(cfg, derive_seed(self.ctx.seed, "weights"), self.dev)
        batches = [(torch.from_numpy(self.images[s]).permute(0, 3, 1, 2).contiguous().to(self.dev),
                    None if self.labels[s] is None else torch.from_numpy(self.labels[s]).to(self.dev))
                   for s in range(self.check_steps)]
        seeds = [self.gen_seed(s) for s in range(self.check_steps)]
        return train(cfg, weights, batches, seeds, self.check_steps, PRECISIONS[precision], half_batch)

    def check(self):
        """Free the program's state, run the reference, compare."""
        self.release()
        gaps = train_gaps(self.readings, self.reference())
        return checks_from(gaps, self.ctx.cell["limits"])


def setup(ctx) -> Job:
    return Job(ctx)
