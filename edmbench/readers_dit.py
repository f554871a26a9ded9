"""The DiT cells' per-layer readers, over a traced run (``run.Run``) whose
``work`` gives ``gemm_bound_s`` and ``flash_bound_s`` a unit
(``traffic/dit_train.py``, counted by ``work_dit.py``); a reader that finds
nothing to read returns None, and the metric is left out."""

from __future__ import annotations

from typing import Optional

from edmbench.trace import group_of

FLASH_KERNELS = ("flash_",)  # csrc/flash_attention_{fwd,bwd}.cu's kernels
GEMM_GROUP = "gemm (cuBLAS)"  # trace.py's group of cuBLAS's kernels


def _share(run, key: str, us: float) -> Optional[float]:
    if us <= 0 or key not in run.work:
        return None
    return 100.0 * run.units * run.work[key] / (us / 1e6)


def flash_roofline_pct(run) -> Optional[float]:
    """The flash kernels' least time over their device time in the
    device-only profile, in %."""
    return _share(run, "flash_bound_s", run.trace.device_us(FLASH_KERNELS))


def gemm_roofline_pct(run) -> Optional[float]:
    """The linear layers' least time over the device time of the kernels
    ``trace.py`` files as cuBLAS GEMMs, in %."""
    return _share(run, "gemm_bound_s", sum(e - s for n, s, e in run.trace.device if group_of(n) == GEMM_GROUP))
