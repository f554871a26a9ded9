"""The work counts of ``edmbench/work.py`` against PyTorch's own count of
the reference's products, and the roofline arithmetic against the card's
record of the attention kernels (PERF.md, the kernel table)."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from edmbench import work
from edmbench.harness import Layout
from edmbench.reference.model import denoise, param_shapes


@pytest.mark.parametrize("config, gflop", [("cifar10", 27.00), ("imagenet512", 192.89)])
def test_forward_flops_match_flop_counter(config, gflop):
    """On meta tensors: PyTorch counts the shapes without computing."""
    cfg = Layout().config(config)
    weights = {k: torch.empty(s, device="meta") for k, s in param_shapes(cfg).items()}
    side, ch = cfg["image_size"], cfg["denoiser"]["in_channels"]
    x = torch.empty((1, ch, side, side), device="meta")
    sigma = torch.empty((1,), device="meta")
    labels = torch.zeros((1,), dtype=torch.long, device="meta")
    with FlopCounterMode(display=False) as counter:
        denoise(weights, cfg, x, sigma, labels)
    counted = {getattr(k, "__name__", str(k)): v for k, v in counter.get_flop_counts()["Global"].items()}
    _, _, ops = work.layers(cfg)
    assert ops["conv"] == counted["convolution"]
    assert ops["mm"] + ops["bmm"] + work.uncertainty_flops(cfg) == counted["mm"] + counted["bmm"]
    assert work.forward_flops(cfg, train=True) == sum(counted.values())
    assert round(sum(counted.values()) / 1e9, 2) == gflop


@pytest.mark.parametrize("b, n, c, bwd, bound_ms", [
    (128, 256, 256, False, 0.0200),  # row 1, CIFAR-10 b 128, n 256, hd 64
    (32, 256, 576, False, 0.0113),  # row 1, ImageNet-512 b 32, n 256, hd 144
    (256, 256, 256, True, 0.0801),  # row 3, CIFAR-10 b 256, n 256
    (32, 64, 768, True, 0.0075),  # row 4, ImageNet-512 b 32, n 64, hd 192
])
def test_attention_bounds_match_kernel_table(b, n, c, bwd, bound_ms):
    a = work.Attention(n, c, 4)
    got = (work.attention_bwd_bound_s if bwd else work.attention_fwd_bound_s)(a, b)
    assert round(got * 1e3, 4) == bound_ms


def test_conv_bounds_are_at_least_the_operations():
    for config in ("cifar10", "imagenet512"):
        cfg = Layout().config(config)
        convs, _, ops = work.layers(cfg)
        peak = work.PEAKS["bf16_flops"]
        fwd = work.conv_bound_s(cfg, 32, train=False)
        assert fwd >= 32 * ops["conv"] / peak
        dgrad_free = sum(c.flops for c in convs if not c.dgrad)
        assert work.conv_bound_s(cfg, 32, train=True) >= 32 * (3 * ops["conv"] - dgrad_free) / peak
