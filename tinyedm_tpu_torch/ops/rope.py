"""FLUX's per-head QK RMSNorm and its multi-axis rotary position embedding,
as one ``torch.autograd.Function`` in plain ops.

``qk_norm_rope(q, k, q_scale, k_scale, cos, sin)`` takes q and k as
``(b, n, heads, hd)`` (any float dtype, views allowed) and returns both as
contiguous tensors of their input dtype. Per head, in fp32:

- RMSNorm: ``x rsqrt(mean(x^2) + 1e-6) * scale``, the scale ``(hd,)`` or,
  where the tokens of two streams meet, one per token ``(n, 1, hd)``;
- RoPE: each pair of adjacent channels ``(2i, 2i+1)`` rotated by the angle
  ``pos . omega_i`` of its token, ``(y0 cos - y1 sin, y0 sin + y1 cos)``,
  from a ``(n, 1, hd/2)`` table of cosines and sines (``rope_table``);

then rounded to the input dtype once, where the flash kernel takes q and k.
The forward saves q and k as they arrive and the scales; the backward
recomputes the fp32 normalized tensors from them (at 4,608 tokens and 24
heads of 128 a block would otherwise keep about 113 MB of fp32 a sample).

``rope_table(ids, axes_dim, theta)`` is FLUX's ``EmbedND``: the angles of
axis ``a`` at ``theta^(-2j / axes_dim[a])`` for ``j < axes_dim[a] / 2``,
the axes' pairs concatenated in order, in fp64 and then cast to fp32.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from tinyedm_tpu_torch.ops.mp import acc_dtype

EPS = 1e-6

# Calls by direction and token count: ("qk_norm_rope", n) and
# ("qk_norm_rope_bwd", n), one a call, as ``ops/attention.py::launch_counts``
# counts the flash kernels'.
call_counts: Counter = Counter()


def rope_table(ids: np.ndarray, axes_dim: tuple[int, ...], theta: float,
               device: torch.device | str = "cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each fp32 ``(n, 1, sum(axes_dim) / 2)``, of the ``(n,
    len(axes_dim))`` position ids."""
    angles = []
    for a, dim in enumerate(axes_dim):
        omega = 1.0 / theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim)
        angles.append(np.asarray(ids[:, a], np.float64)[:, None] * omega[None])
    angle = np.concatenate(angles, axis=1)[:, None]
    return (torch.from_numpy(np.cos(angle)).float().to(device),
            torch.from_numpy(np.sin(angle)).float().to(device))


def _normed(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(x rsqrt(mean(x^2) + eps), rsqrt(...)) in fp32 (fp64 for fp64), over
    the last axis."""
    x = x.to(acc_dtype(x.dtype))
    r = torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS)
    return x * r, r


def _rotate(y: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Each adjacent pair of ``y``'s last axis rotated by its angle;
    ``sin`` negated rotates back (the transpose)."""
    y0, y1 = y.unflatten(-1, (-1, 2)).unbind(-1)
    return torch.stack((y0 * cos - y1 * sin, y0 * sin + y1 * cos), dim=-1).flatten(-2)


def qk_norm_rope_plain(x: torch.Tensor, scale: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """One of q, k through the composition the Function computes, in fp32
    (fp64 for fp64), for autograd to differentiate in the tests."""
    return _rotate(_normed(x)[0] * scale, cos, sin)


class _QKNormRope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, q_scale, k_scale, cos, sin):
        ctx.save_for_backward(q, k, q_scale, k_scale, cos, sin)
        call_counts["qk_norm_rope", q.shape[1]] += 1
        return tuple(qk_norm_rope_plain(x, s, cos, sin).to(x.dtype) for x, s in ((q, q_scale), (k, k_scale)))

    @staticmethod
    def backward(ctx, gq, gk):
        q, k, q_scale, k_scale, cos, sin = ctx.saved_tensors
        call_counts["qk_norm_rope_bwd", q.shape[1]] += 1
        out = []
        for x, scale, g in ((q, q_scale, gq), (k, k_scale, gk)):
            xn, r = _normed(x)
            gy = _rotate(g.to(acc_dtype(g.dtype)), cos, -sin)
            gxn = gy * scale
            gx = r * (gxn - xn * (gxn * xn).mean(-1, keepdim=True))
            out.append((gx.to(x.dtype), (gy * xn).sum_to_size(scale.shape)))
        (dq, dqs), (dk, dks) = out
        return dq, dk, dqs, dks, None, None


def qk_norm_rope(q: torch.Tensor, k: torch.Tensor, q_scale: torch.Tensor, k_scale: torch.Tensor,
                 cos: torch.Tensor, sin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """RMSNorm then RoPE on q and k (the module docstring); differentiable
    in q, k and both scales."""
    return _QKNormRope.apply(q, k, q_scale, k_scale, cos, sin)
