"""The cosine-attention kernels' (forward and backward) share of their roofline in a train step, in %."""

from edmbench.readers import attention_roofline_pct as read  # noqa: F401
