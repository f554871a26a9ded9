"""CUDA launch calls on the host per denoiser forward of a Heun batch."""

from edmbench.readers import launches_per_forward as read  # noqa: F401
