"""The convolutions' share of their roofline in a Heun batch, in %."""

from edmbench.readers import conv_roofline_pct as read  # noqa: F401
