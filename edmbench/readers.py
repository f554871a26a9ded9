"""The per-layer metrics' arithmetic, over a traced run (``run.Run``).
Each metric's file under ``metrics/`` names one of these; a reader that
finds nothing to read returns None, and the metric is left out."""

from __future__ import annotations

from typing import Optional

from edmbench.trace import ATTENTION_KERNELS
from edmbench.work import PEAKS


def idle_pct(run) -> Optional[float]:
    """The device's idle share of the profiled units' window, in %."""
    t = run.trace
    if t.busy_us <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us / t.window_us)


def mfu_pct(run) -> float:
    """The model's operations a unit over the unprofiled window's time a
    unit, against the card's bf16 peak, in %."""
    return 100.0 * run.work["flops"] / (run.unit_s * PEAKS["bf16_flops"])


def launches_per_unit(run) -> Optional[float]:
    """CUDA launch calls on the host per unit (a train step, a batch)."""
    return run.trace.launches / run.units if run.trace.launches else None


def launches_per_forward(run) -> Optional[float]:
    """CUDA launch calls on the host per denoiser forward."""
    n = launches_per_unit(run)
    return None if n is None else n / run.work["forwards"]


def attention_roofline_pct(run) -> Optional[float]:
    """The attention kernels' least time (work.py) over their device time, in %."""
    us = run.trace.device_us(ATTENTION_KERNELS)
    if us <= 0:
        return None
    return 100.0 * run.units * run.work["attention_bound_s"] / (us / 1e6)


def conv_roofline_pct(run) -> Optional[float]:
    """The convolutions' least time (work.py) over the device time under the
    convolution ops (cuDNN's layout transforms included), in %."""
    if run.trace.conv_us <= 0:
        return None
    return 100.0 * run.units * run.work["conv_bound_s"] / (run.trace.conv_us / 1e6)
