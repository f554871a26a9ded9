"""The cosine-attention forward kernel's share of its roofline in a Heun batch, in %."""

from edmbench.readers import attention_roofline_pct as read  # noqa: F401
