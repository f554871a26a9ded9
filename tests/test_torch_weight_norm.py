"""``weight_norm_cast`` (ops/mp.py, csrc/weight_norm.cu) and the layers'
routing to it (models/layers.py::_WeightNormed.compute_weight).

CPU: the plain version is the composite the layers ran before, bit for bit;
with no gradient wanted ``WNConv``, ``WNLinear`` and ``CosineAttention``
give exactly the composite's output and call the wrapper once a layer; with
a gradient wanted they never call it and their gradients are the
composite's. ``cuda`` cases (skip without a card; this file imports no JAX,
so on the card ``python -m pytest --noconftest -m cuda
tests/test_torch_weight_norm.py`` runs them): the kernel against the plain
version at every weight shape of the CIFAR-10 and ImageNet-512 models, bf16
outputs at most one bf16 ulp apart and equal in at least 99.9% of elements
(the two differ only in the order of the fp32 sum of squares), fp32 outputs
within 2^-20 relative; odd layouts; one launch a layer in a no-gradient
forward and none in a forward that wants gradients.
"""

from __future__ import annotations

import math

import pytest
import torch

from tinyedm_tpu_torch.configs import build_model, model_from_config
from tinyedm_tpu_torch.models import layers
from tinyedm_tpu_torch.ops import mp

KS = [12, 45, 257, 1000, 2304, 13824]
DTYPES = [torch.bfloat16, torch.float32]
MODES = {"inference_mode": torch.inference_mode, "no_grad": torch.no_grad}


def _weight(shape, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * 1.7).to(device)


def _shape(ndim: int, k: int, rows: int = 16) -> tuple[int, ...]:
    if ndim == 2:
        return (rows, k)
    return (rows, k // 9, 3, 3) if k % 9 == 0 else (rows, k, 1, 1)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("ndim", [2, 4])
def test_plain_matches_composite(ndim, k, dtype):
    """A CPU tensor takes the plain version: the layers' former
    ``weight_normalize(w) * (1 / sqrt(fan_in))`` then ``.to(dtype)``."""
    w = _weight(_shape(ndim, k), seed=k + ndim)
    scale = 1.0 / math.sqrt(k)
    before = mp.weight_norm_cast.launches
    out = mp.weight_norm_cast(w, scale, dtype)
    assert mp.weight_norm_cast.launches == before
    ref = (mp.weight_normalize(w) * scale).to(dtype)
    assert out.dtype == dtype and out.shape == w.shape
    assert torch.equal(out, ref)


def test_cuda_wrapper_refuses_before_the_card():
    w = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="CUDA device"):
        mp.weight_norm_cast_cuda(w, 1.0, torch.bfloat16)
    with pytest.raises(ValueError, match="2D or 4D"):
        mp.weight_norm_cast_cuda(torch.zeros(4, 8, 3), 1.0, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA device"):
        mp.weight_norm_cast(torch.zeros(4, 8, device="meta"), 1.0, torch.bfloat16)


def _layer(kind: str, dtype: torch.dtype) -> tuple[torch.nn.Module, torch.Tensor, int]:
    """(layer with seeded weights, input, weight-normed layers it holds)."""
    g = torch.Generator().manual_seed(3)
    if kind == "conv3x3":
        m, x = layers.WNConv(12, 20, 3, dtype=dtype), torch.randn(2, 12, 8, 8, generator=g)
    elif kind == "conv1x1":
        m, x = layers.WNConv(257, 16, 1, dtype=dtype), torch.randn(2, 257, 4, 4, generator=g)
    elif kind == "linear":
        m, x = layers.WNLinear(45, 24, dtype=dtype), torch.randn(5, 45, generator=g)
    else:  # attention, fused = the route
        m = layers.CosineAttention(64, num_heads=2, dtype=dtype, fused=kind.split("_")[1])
        x = torch.randn(2, 64, 4, 4, generator=g)
    for sub in m.modules():
        if isinstance(sub, layers._WeightNormed):
            sub.reset_parameters(g)
    return m, x, sum(isinstance(sub, layers._WeightNormed) for sub in m.modules())


KINDS = ["conv3x3", "conv1x1", "linear", "attention_auto", "attention_off", "attention_block"]


def _composite(self):
    return mp.weight_norm_cast_plain(self.weight, self.scale, self.dtype)


class _Spy:
    def __init__(self):
        self.calls = 0

    def __call__(self, w, scale, dtype):
        self.calls += 1
        return mp.weight_norm_cast(w, scale, dtype)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
@pytest.mark.parametrize("kind", KINDS)
def test_no_grad_forward_is_the_composite(kind, dtype, mode, monkeypatch):
    """No gradient wanted: one ``weight_norm_cast`` a layer, and exactly the
    output of the composite route."""
    m, x, n_layers = _layer(kind, dtype)
    spy = _Spy()
    monkeypatch.setattr(layers, "weight_norm_cast", spy)
    with MODES[mode]():
        out = m(x)
    assert spy.calls == n_layers
    with monkeypatch.context() as patch:
        patch.setattr(layers._WeightNormed, "compute_weight", _composite)
        with MODES[mode]():
            ref = m(x)
    assert spy.calls == n_layers
    assert out.dtype == ref.dtype and torch.equal(out, ref)


def _never(*_):
    raise AssertionError("weight_norm_cast called where a gradient is wanted")


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
@pytest.mark.parametrize("kind", KINDS)
def test_grad_wanted_keeps_the_composite(kind, dtype, monkeypatch):
    """A gradient wanted: the wrapper is never called, and the output and
    the gradients of weights and input are the composite's."""
    m, x, _ = _layer(kind, dtype)
    x.requires_grad_(True)
    g = torch.randn(m(x).shape, generator=torch.Generator().manual_seed(5))

    def grads():
        out = m(x)
        return (out.detach(), *torch.autograd.grad(out.float(), [x, *m.parameters()], g))

    monkeypatch.setattr(layers, "weight_norm_cast", _never)
    got = grads()
    with monkeypatch.context() as patch:
        patch.setattr(layers._WeightNormed, "compute_weight", _composite)
        ref = grads()
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_frozen_weight_takes_the_wrapper(monkeypatch):
    """A weight that wants no gradient takes the wrapper even where grad
    mode is on (an input that wants one keeps its own gradient)."""
    m, x, _ = _layer("conv3x3", torch.bfloat16)
    m.weight.requires_grad_(False)
    spy = _Spy()
    monkeypatch.setattr(layers, "weight_norm_cast", spy)
    x.requires_grad_(True)
    out = m(x)
    assert spy.calls == 1 and out.requires_grad


def test_smoke_model_forward_calls_once_a_layer(monkeypatch):
    """A whole no-gradient forward of the smoke model: one call for each
    weight-normed layer the forward runs (the uncertainty head is not run),
    and the composite's output."""
    model = build_model("smoke", "cpu", seed=0)
    with torch.no_grad():
        model.denoiser.gain_out.fill_(1.0)
    g = torch.Generator().manual_seed(1)
    x, sigma = torch.randn(2, 3, 16, 16, generator=g), torch.rand(2, generator=g) + 0.2
    labels = torch.tensor([1, 7])
    run = sum(isinstance(m, layers._WeightNormed) for name, m in model.named_modules() if not name.startswith("u."))
    spy = _Spy()
    monkeypatch.setattr(layers, "weight_norm_cast", spy)
    with torch.inference_mode():
        out = model(x, sigma, labels)
    assert spy.calls == run > 0
    monkeypatch.setattr(layers._WeightNormed, "compute_weight", _composite)
    with torch.inference_mode():
        assert torch.equal(out, model(x, sigma, labels))


# --- on the card ---------------------------------------------------------


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


def layer_shapes(config: str) -> list[tuple[tuple[int, ...], torch.dtype]]:
    """Every (weight shape, compute dtype) of the config's weight-normed
    layers, from the model built on the meta device."""
    with torch.device("meta"):
        model = model_from_config(config)
    return sorted({(tuple(m.weight.shape), m.dtype) for m in model.modules()
                   if isinstance(m, layers._WeightNormed)}, key=str)


def bf16_ulps(out: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """|out - ref| in bf16 ulps of ref (two bf16 tensors)."""
    ref = ref.float()
    mag = ref.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return (out.float() - ref).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)


def check_against_plain(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, int]:
    """Raises unless the kernel's output is within the limits of its type;
    returns (worst gap, elements unequal): bf16 ulps or fp32 relative gap."""
    assert out.dtype == ref.dtype and out.shape == ref.shape
    unequal = int((out != ref).sum())
    if out.dtype == torch.bfloat16:
        worst = float(bf16_ulps(out, ref).max())
        assert worst <= 1.0, worst
    else:
        worst = float(((out - ref).abs() / ref.abs().clamp_min(1e-30)).max())
        assert worst <= 2.0**-20, worst
    return worst, unequal


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["cifar10", "imagenet512"])
def test_cuda_kernel_matches_plain_at_layer_shapes(config):
    _needs_card()
    unequal = total = 0
    for i, (shape, dtype) in enumerate(layer_shapes(config)):
        w = _weight(shape, seed=i, device="cuda")
        scale = 1.0 / math.sqrt(math.prod(shape[1:]))
        before = mp.weight_norm_cast.launches
        out = mp.weight_norm_cast(w, scale, dtype)
        torch.cuda.synchronize()
        assert mp.weight_norm_cast.launches == before + 1
        _, n = check_against_plain(out, mp.weight_norm_cast_plain(w, scale, dtype))
        if dtype == torch.bfloat16:
            unequal, total = unequal + n, total + out.numel()
    assert unequal <= 1e-3 * total, (unequal, total)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 1), (5, 3), (7, 45), (4, 20000), (2, 3000, 3, 3), (1, 257, 1, 1)])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
def test_cuda_kernel_odd_layouts(shape, offset):
    """Rows of 1 to 27,000 values (the longest model row holds 13,824), and the
    weight a view one element into its storage (no 16-byte loads)."""
    _needs_card()
    w = _weight(shape, seed=len(shape), device="cuda")
    flat = torch.empty(w.numel() + offset, device="cuda")
    view = flat[offset:].view(shape)
    view.copy_(w)
    for dtype in DTYPES:
        out = mp.weight_norm_cast(view, 0.37, dtype)
        torch.cuda.synchronize()
        check_against_plain(out, mp.weight_norm_cast_plain(w, 0.37, dtype))


@pytest.mark.cuda
def test_cuda_launches_once_a_layer_without_gradients():
    """The smoke model on the card: one launch for each weight-normed layer
    of a no-gradient forward, none in a forward that wants gradients."""
    _needs_card()
    model = build_model("smoke", "cuda", seed=0)
    run = sum(isinstance(m, layers._WeightNormed) for name, m in model.named_modules() if not name.startswith("u."))
    x, sigma = torch.randn(2, 3, 16, 16, device="cuda"), torch.ones(2, device="cuda")
    labels = torch.tensor([1, 7], device="cuda")
    before = mp.weight_norm_cast.launches
    with torch.inference_mode():
        model(x, sigma, labels)
    assert mp.weight_norm_cast.launches == before + run
    model(x, sigma, labels).float().sum().backward()
    assert mp.weight_norm_cast.launches == before + run
