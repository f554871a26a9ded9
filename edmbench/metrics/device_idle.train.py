"""Share of the profiled train steps' window in which no operation ran on the card, in %."""

from edmbench.readers import idle_pct as read  # noqa: F401
