"""The cuBLAS GEMMs' (the DiT's linear layers, forward and backward) share of their roofline in a train step, in %."""

from edmbench.readers_dit import gemm_roofline_pct as read  # noqa: F401
