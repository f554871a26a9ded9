"""Profiling hooks: named spans at the port's layer boundaries, and a trace
of a region that shows them beside the kernels.

The spans are ``record_function`` ranges, entered only while a torch
profiler records: untraced, ``span`` costs one check of the profiler's state
and returns a shared null context. Their names are dotted by nesting:

- ``tinyedm.train_step``: one optimizer step (``training/train_step.py``),
  holding per microbatch ``.forward`` (labels, diffuser draws, the denoiser
  forward, the loss) and ``.backward`` (the backward and the gradient sum),
  one ``.backward`` more for the microbatches' mean, then ``.optimizer``
  (norms and clip, ``.optimizer.adam``, ``.optimizer.weight_norm``,
  ``.optimizer.ema``);
- ``tinyedm.solve``: one batch's solve (``diffusion/solver.py``), holding
  ``tinyedm.solve.denoise`` for each denoiser evaluation.

The backward's kernels are launched from the autograd engine's device
thread while the calling thread waits inside ``.backward``: read them by
time, not by thread.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Iterator

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A named range in the profiler's trace while a torch profiler records; else nothing."""
    return torch.profiler.record_function(name) if torch.autograd._profiler_enabled() else _OFF


@contextlib.contextmanager
def trace(log_dir: str | Path) -> Iterator[torch.profiler.profile]:
    """Trace the host and (where there is one) the card around a region and
    write a Chrome trace (``trace.json``) into ``log_dir``, where the spans
    stand beside the operators and kernels they hold:

        with trace("runs/x/profile") as prof:
            for _ in range(10): state, m = step(...)
        print(prof.key_averages().table(sort_by="cuda_time_total"))
    """
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / "trace.json"))
