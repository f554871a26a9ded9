"""The FLUX cell's own per-layer reader, over a traced run (``run.Run``);
a reader that finds nothing to read returns None, and the metric is left
out."""

from __future__ import annotations

from typing import Optional

from edmbench.trace import group_of

# trace.py's groups of PyTorch's pointwise kernels: where QK RMSNorm, RoPE,
# the LayerNorm modulation and the gated residual sums run
POINTWISE_GROUPS = ("elementwise", "reduction")


def pointwise_ms(run) -> Optional[float]:
    """Device ms a unit in the elementwise and reduction kernels of the
    device-only profile."""
    us = sum(e - s for n, s, e in run.trace.device if group_of(n) in POINTWISE_GROUPS)
    return us / 1e3 / run.units if us > 0 else None
