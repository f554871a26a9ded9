"""Profiling hooks: a device trace, a step timer and the memory counters.

Counterpart of ``tinyedm_tpu/utils/profiling.py``, on ``torch.profiler`` and
``torch.cuda``.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str | Path) -> Iterator[torch.profiler.profile]:
    """Trace the host and (where there is one) the card around a region and
    write a Chrome trace (``trace.json``) into ``log_dir``:

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


class StepTimer:
    """Rolling wall-clock step times with explicit device fences.

    ``mark()`` every step; ``sync_value(t)`` with a device scalar from the
    step at a measurement boundary: reading it on the host waits for the
    card to produce it, the only fence a timed loop needs."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list[float] = []
        self._last: Optional[float] = None

    def mark(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    def sync_value(self, device_scalar) -> float:
        v = float(device_scalar)
        self._last = time.perf_counter()
        return v

    @property
    def mean_step_time(self) -> float:
        return sum(self._times) / max(len(self._times), 1)

    def steps_per_sec(self) -> float:
        t = self.mean_step_time
        return 1.0 / t if t else 0.0


def device_memory_stats() -> dict:
    """Per-card allocator bytes in use, their peak and the card's total
    (empty without CUDA)."""
    out = {}
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out
