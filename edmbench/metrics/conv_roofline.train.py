"""The convolutions' (forward, input and weight gradients) share of their roofline in a train step, in %."""

from edmbench.readers import conv_roofline_pct as read  # noqa: F401
