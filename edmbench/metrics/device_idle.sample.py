"""Share of the profiled Heun batch's window in which no operation ran on the card, in %."""

from edmbench.readers import idle_pct as read  # noqa: F401
