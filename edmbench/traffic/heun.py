"""Traffic kind ``heun``: batches of samples through the port's Heun solver,
as the generation CLI makes them, without the PNG write.

Cell parameters (``params`` of the cell file): ``batch`` (images a solve),
``num_steps`` (Heun steps: 2 n - 1 denoiser forwards a batch), ``pool``
(distinct noise batches drawn in set-up and fed in turn), ``check_rows``
(rows of each batch kept for ``correct``), ``check_batches`` (batches whose
kept rows the reference solves again), ``trace_units`` (batches profiled in a
traced run).

Set-up draws the noise and the labels (uniform over the classes, for a
conditional model) on the host from the seed, the weights on the card, and
warms up with one Heun step (two forwards), the uint8 mapping and the copy
to the host. Each batch of the window is the CLI's per-batch body: the noise
and labels copied to the card, ``make_solver("heun", ...)``'s solve under
inference mode, ``device_denormalize_uint8`` and the copy to the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from edmbench import work
from edmbench.harness import checks_from, derive_seed, port_model, sample_gaps
from edmbench.reference.heun import heun, to_uint8
from edmbench.reference.model import conditional, draw_weights
from edmbench.reference.precision import PRECISIONS

UNIT = "batch"


class Job:
    def __init__(self, ctx):
        from tinyedm_tpu_torch.generate import device_denormalize_uint8, make_solver

        stamps = [time.perf_counter()]
        self.ctx, cfg, p = ctx, ctx.config, ctx.cell["params"]
        self.dev = ctx.device
        self.batch = p["batch"]
        self.items_per_unit = self.batch
        self.trace_units = p["trace_units"]
        self.num_steps = p["num_steps"]
        self.first_unit = 0
        self.mean, self.std = cfg["sampling"]["mean"], cfg["sampling"]["std"]
        self.to_uint8 = device_denormalize_uint8
        self.solver = make_solver("heun", self.num_steps, None, 0.0, 1.0, 0.0, float("inf"))
        side, ch = cfg["image_size"], cfg["denoiser"]["in_channels"]
        rng = np.random.default_rng(derive_seed(ctx.seed, "data"))
        self.noise = [rng.standard_normal((self.batch, side, side, ch), dtype=np.float32)
                      for _ in range(p["pool"])]
        n_classes = cfg["embedding"]["num_classes"] if conditional(cfg) else None
        self.labels = [rng.integers(0, n_classes, self.batch) if n_classes else None for _ in range(p["pool"])]
        self.rows = np.sort(rng.choice(self.batch, p["check_rows"], replace=False))
        self.check_batches = p["check_batches"]
        stamps.append(time.perf_counter())
        self.model = port_model(cfg, self.dev, draw_weights(cfg, derive_seed(ctx.seed, "weights"), self.dev))
        self.rows_dev = torch.from_numpy(self.rows).to(self.dev)
        self.kept = {}  # batch index -> (the kept rows' samples, their uint8 values), on the host
        stamps.append(time.perf_counter())
        self._warm_up()
        stamps.append(time.perf_counter())
        self.setup_parts = dict(zip(("inputs", "weights", "warm-up"), (b - a for a, b in zip(stamps, stamps[1:]))))
        forwards = 2 * self.num_steps - 1
        self.work = {
            "flops": forwards * self.batch * work.forward_flops(cfg),
            "attention_bound_s": forwards * work.attention_bound_s(cfg, self.batch, train=False),
            "conv_bound_s": forwards * work.conv_bound_s(cfg, self.batch, train=False),
            "forwards": forwards,
        }

    def _inputs(self, k: int):
        x0 = torch.from_numpy(self.noise[k]).to(self.dev).permute(0, 3, 1, 2).contiguous()
        lab = torch.from_numpy(self.labels[k]).to(self.dev) if self.labels[k] is not None else None
        return x0, lab

    def _warm_up(self) -> None:
        """One Heun step's two forwards at the first two sigmas, the uint8
        mapping and the copy to the host."""
        x0, lab = self._inputs(0)
        t = self.solver.t_steps
        with torch.inference_mode():
            for sigma in t[:2]:
                s = torch.full((self.batch,), float(sigma), dtype=torch.float32, device=self.dev)
                x = self.model(x0 * float(t[0]), s, lab)
            self.to_uint8(x, self.mean, self.std).permute(0, 2, 3, 1).cpu()

    def unit(self, i: int) -> None:
        """Solve batch ``i``, map it to uint8 and copy it to the host."""
        k = i % len(self.noise)
        with torch.profiler.record_function("edmbench.feed"):
            x0, lab = self._inputs(k)
        with torch.inference_mode():
            with torch.profiler.record_function("edmbench.solve"):
                x = self.solver.solve(self.model, x0, lab)
            with torch.profiler.record_function("edmbench.to_uint8"):
                images = self.to_uint8(x, self.mean, self.std).permute(0, 2, 3, 1)
            with torch.profiler.record_function("edmbench.to_host"):
                out = images.cpu().numpy()
            self.kept[i] = (x[self.rows_dev].float().cpu(), torch.from_numpy(out[self.rows]))

    @staticmethod
    def fence(_) -> None:
        """Each batch ends with its copy to the host."""

    def release(self) -> None:
        del self.model
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def checked(self) -> list[int]:
        """The batches the reference solves again: drawn from the seed among
        those the window finished."""
        done = sorted(self.kept)
        rng = np.random.default_rng(derive_seed(self.ctx.seed, "check"))
        return sorted(rng.choice(done, min(self.check_batches, len(done)), replace=False).tolist())

    def reference(self, batches: list[int], precision: str = "fp32"):
        """The reference (or the control) on the kept rows of ``batches``:
        (samples, uint8 NHWC), both on the host."""
        cfg = self.ctx.config
        weights = draw_weights(cfg, derive_seed(self.ctx.seed, "weights"), self.dev)
        ks = [i % len(self.noise) for i in batches]
        noise = torch.cat([torch.from_numpy(self.noise[k][self.rows]) for k in ks]).permute(0, 3, 1, 2)
        labels = None
        if self.labels[0] is not None:
            labels = torch.cat([torch.from_numpy(self.labels[k][self.rows]) for k in ks]).to(self.dev)
        x = heun(weights, cfg, noise.to(self.dev), labels, self.num_steps, PRECISIONS[precision])
        return x.cpu(), to_uint8(x, self.mean, self.std).permute(0, 2, 3, 1).cpu()

    def check(self):
        """Free the program's model, solve the checked rows again, compare."""
        self.release()
        batches = self.checked()
        x_ref, u8_ref = self.reference(batches)
        x_prog = torch.cat([self.kept[i][0] for i in batches])
        u8_prog = torch.cat([self.kept[i][1] for i in batches])
        return checks_from(sample_gaps(x_prog, x_ref, u8_prog, u8_ref), self.ctx.cell["limits"])


def setup(ctx) -> Job:
    return Job(ctx)
