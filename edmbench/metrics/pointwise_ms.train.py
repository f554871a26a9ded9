"""Device ms a train step in PyTorch's elementwise and reduction kernels (QK RMSNorm, RoPE, norm_modulate, the gated sums), FLUX's cell."""

from edmbench.readers_flux import pointwise_ms as read  # noqa: F401
