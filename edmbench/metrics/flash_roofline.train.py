"""The flash-attention kernels' (forward and backward) share of their roofline in a DiT train step, in %."""

from edmbench.readers_dit import flash_roofline_pct as read  # noqa: F401
