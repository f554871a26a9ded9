"""The train step's model operations (3 forwards' worth) per second against the card's bf16 peak, in %."""

from edmbench.readers import mfu_pct as read  # noqa: F401
