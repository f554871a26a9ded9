"""CUDA launch calls on the host per train step."""

from edmbench.readers import launches_per_unit as read  # noqa: F401
