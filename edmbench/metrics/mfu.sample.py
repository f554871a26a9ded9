"""The Heun batch's model operations (2 n - 1 forwards) per second against the card's bf16 peak, in %."""

from edmbench.readers import mfu_pct as read  # noqa: F401
