"""``weight_norm_cast`` and its backward (ops/mp.py, csrc/weight_norm.cu)
and the layers' routing to them (models/layers.py::_WeightNormed.compute_weight).

CPU: the plain version is the composite the layers ran before, bit for bit;
the plain backward is autograd's gradient through the composite, bit for
bit, and ``_WeightNormCast`` on CPU tensors (its plain forward and backward)
gives the composite's output and gradients; with no gradient wanted
``WNConv``, ``WNLinear`` and ``CosineAttention`` give exactly the
composite's output and call the wrapper once a layer; with a gradient
wanted they take the Function once a layer, never the wrapper, launch no
kernel on the CPU, and their outputs and gradients are the composite's. ``cuda`` cases (skip without a card; this
file imports no JAX, so on the card ``python -m pytest --noconftest -m cuda
tests/test_torch_weight_norm.py`` runs them): the forward kernel against the
plain version at every weight shape of the CIFAR-10 and ImageNet-512
models, bf16 outputs at most one bf16 ulp apart and equal in at least 99.9%
of elements (the two differ only in the order of the fp32 sum of squares),
fp32 outputs within 2^-20 relative; the backward kernel against the plain
backward at the same shapes from bf16 and fp32 gradients, fp32 within 2^-20
of its row's largest value (the two sums in another order); odd layouts;
one launch a layer in a no-gradient forward, one each way in a forward and
backward that want gradients, and 4 x 197 (ImageNet-512) and 115
(CIFAR-10) each way in a train step.
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


def test_cuda_bwd_wrapper_refuses_before_the_card():
    w, g = torch.zeros(4, 8), torch.zeros(4, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA device"):
        mp.weight_norm_cast_bwd_cuda(w, g, 1.0)
    with pytest.raises(ValueError, match="2D or 4D"):
        mp.weight_norm_cast_bwd_cuda(torch.zeros(4, 8, 3), torch.zeros(4, 8, 3), 1.0)
    with pytest.raises(ValueError, match="of its shape"):
        mp.weight_norm_cast_bwd_cuda(w, torch.zeros(4, 9), 1.0)
    meta = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        mp.weight_norm_cast_bwd(meta, meta, 1.0)
    with pytest.raises(ValueError, match="CUDA device"):  # the Function off the CPU: the kernels or a raise
        mp._WeightNormCast.apply(meta.requires_grad_(True), 1.0, torch.bfloat16)


def _cotangent(shape, dtype, seed):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("ndim", [2, 4])
def test_bwd_plain_matches_autograd_through_composite(ndim, k, dtype):
    """The plain backward is the gradient autograd takes through
    ``weight_norm_cast_plain`` (the cast's, the scale's and
    ``_PixelNorm``'s nodes), bit for bit, from a gradient in ``dtype``."""
    w = _weight(_shape(ndim, k), seed=k + ndim).requires_grad_(True)
    scale = 1.0 / math.sqrt(k)
    g = _cotangent(w.shape, dtype, seed=k)
    (ref,) = torch.autograd.grad(mp.weight_norm_cast_plain(w, scale, dtype), w, g)
    before = mp.weight_norm_cast.bwd_launches
    out = mp.weight_norm_cast_bwd(w.detach(), g, scale)
    assert mp.weight_norm_cast.bwd_launches == before
    assert out.dtype == torch.float32 and torch.equal(out, ref)


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
@pytest.mark.parametrize("k", [45, 2304])
@pytest.mark.parametrize("ndim", [2, 4])
def test_function_plain_gives_composite_gradients(ndim, k, dtype):
    """``_WeightNormCast`` on a CPU tensor runs its plain forward and
    backward: the composite's output and gradient, bit for bit, with no
    kernel launch counted."""
    w = _weight(_shape(ndim, k), seed=7 * k + ndim).requires_grad_(True)
    scale = 1.0 / math.sqrt(k)
    g = _cotangent(w.shape, dtype, seed=k + 1)
    before = mp.weight_norm_cast.launches, mp.weight_norm_cast.bwd_launches
    out = mp._WeightNormCast.apply(w, scale, dtype)
    (grad,) = torch.autograd.grad(out, w, g)
    assert (mp.weight_norm_cast.launches, mp.weight_norm_cast.bwd_launches) == before
    ref = mp.weight_norm_cast_plain(w, scale, dtype)
    (ref_grad,) = torch.autograd.grad(ref, w, g)
    assert out.dtype == dtype and torch.equal(out, ref.detach())
    assert torch.equal(grad, ref_grad)


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


class _Counted:
    """Counts the calls of ``fn`` and passes them on."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


@pytest.mark.parametrize("kind", KINDS)
def test_grad_wanted_takes_the_function_and_no_kernel_on_the_cpu(kind, monkeypatch):
    """A layer that wants a gradient takes ``_WeightNormCast`` once a layer
    forward and its backward once a layer; on the CPU neither launches a
    kernel, and every weight gets its gradient."""
    m, x, n_layers = _layer(kind, torch.bfloat16)
    apply, bwd = _Counted(mp._WeightNormCast.apply), _Counted(mp.weight_norm_cast_bwd)
    monkeypatch.setattr(mp._WeightNormCast, "apply", apply)
    monkeypatch.setattr(mp, "weight_norm_cast_bwd", bwd)
    before = mp.weight_norm_cast.launches, mp.weight_norm_cast.bwd_launches
    out = m(x)
    assert apply.calls == n_layers and bwd.calls == 0
    out.float().sum().backward()
    assert apply.calls == bwd.calls == n_layers
    assert (mp.weight_norm_cast.launches, mp.weight_norm_cast.bwd_launches) == before
    assert all(p.grad is not None for p in m.parameters() if p.requires_grad)


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


def check_bwd_against_plain(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Raises unless the backward kernel's fp32 gradient lies within 2^-20
    of its row's largest plain value; returns the worst such gap."""
    assert out.dtype == ref.dtype == torch.float32 and out.shape == ref.shape
    rows = ref.shape[0]
    diff, ref2 = (out - ref).reshape(rows, -1).abs(), ref.reshape(rows, -1).abs()
    worst = float((diff.amax(dim=1) / ref2.amax(dim=1).clamp_min(1e-30)).max())
    assert worst <= 2.0**-20, worst
    return worst


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["cifar10", "imagenet512"])
def test_cuda_bwd_kernel_matches_plain_at_layer_shapes(config):
    """Every weight shape of the model, from a bf16 and an fp32 gradient."""
    _needs_card()
    for i, (shape, _) in enumerate(layer_shapes(config)):
        w = _weight(shape, seed=i, device="cuda")
        scale = 1.0 / math.sqrt(math.prod(shape[1:]))
        for dtype in DTYPES:
            g = _cotangent(shape, dtype, seed=100 + i).cuda()
            before = mp.weight_norm_cast.bwd_launches
            out = mp.weight_norm_cast_bwd(w, g, scale)
            torch.cuda.synchronize()
            assert mp.weight_norm_cast.bwd_launches == before + 1
            check_bwd_against_plain(out, mp.weight_norm_cast_bwd_plain(w, g, scale))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 1), (5, 3), (7, 45), (6, 257, 1, 1), (4, 769), (4, 20000), (2, 3000, 3, 3)])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
def test_cuda_bwd_kernel_odd_layouts(shape, offset):
    """Odd rows (45, 257, 769 values) and long ones, with the weight and
    the gradient views one element into their storage (no vector loads)."""
    _needs_card()
    w = _weight(shape, seed=len(shape), device="cuda")
    flat = torch.empty(w.numel() + offset, device="cuda")
    view = flat[offset:].view(shape)
    view.copy_(w)
    for dtype in DTYPES:
        g = _cotangent(shape, dtype, seed=3).cuda()
        gflat = torch.empty(g.numel() + offset, dtype=dtype, device="cuda")
        gview = gflat[offset:].view(shape)
        gview.copy_(g)
        out = mp.weight_norm_cast_bwd(view, gview, 0.37)
        torch.cuda.synchronize()
        check_bwd_against_plain(out, mp.weight_norm_cast_bwd_plain(w, g, 0.37))


@pytest.mark.cuda
def test_cuda_launches_once_a_layer_without_gradients():
    """The smoke model on the card: one launch for each weight-normed layer
    of a no-gradient forward, and no backward launch."""
    _needs_card()
    model = build_model("smoke", "cuda", seed=0)
    run = sum(isinstance(m, layers._WeightNormed) for name, m in model.named_modules() if not name.startswith("u."))
    x, sigma = torch.randn(2, 3, 16, 16, device="cuda"), torch.ones(2, device="cuda")
    labels = torch.tensor([1, 7], device="cuda")
    before = mp.weight_norm_cast.launches, mp.weight_norm_cast.bwd_launches
    with torch.inference_mode():
        model(x, sigma, labels)
    assert (mp.weight_norm_cast.launches, mp.weight_norm_cast.bwd_launches) == (before[0] + run, before[1])


@pytest.mark.cuda
def test_cuda_launches_once_each_way_a_layer_with_gradients(monkeypatch):
    """The smoke model on the card in a forward and backward that want
    gradients: one forward and one backward launch a weight-normed layer,
    and each weight's gradient within 2^-20 (of its row's largest value) of
    the plain backward from the gradient its effective weight received."""
    _needs_card()
    model = build_model("smoke", "cuda", seed=0)
    with torch.no_grad():
        model.denoiser.gain_out.fill_(1.0)
    run = sum(isinstance(m, layers._WeightNormed) for name, m in model.named_modules() if not name.startswith("u."))
    x, sigma = torch.randn(2, 3, 16, 16, device="cuda"), torch.ones(2, device="cuda")
    labels = torch.tensor([1, 7], device="cuda")
    effective, compute_weight = [], layers._WeightNormed.compute_weight

    def kept(self):
        y = compute_weight(self)
        y.retain_grad()
        effective.append((self, y))
        return y

    monkeypatch.setattr(layers._WeightNormed, "compute_weight", kept)
    before = mp.weight_norm_cast.launches, mp.weight_norm_cast.bwd_launches
    model(x, sigma, labels).float().square().sum().backward()
    torch.cuda.synchronize()
    assert (mp.weight_norm_cast.launches, mp.weight_norm_cast.bwd_launches) == (before[0] + run, before[1] + run)
    assert len(effective) == run
    for m, y in effective:
        check_bwd_against_plain(m.weight.grad, mp.weight_norm_cast_bwd_plain(m.weight.detach(), y.grad, m.scale))


@pytest.mark.cuda
@pytest.mark.parametrize("config, per_step", [("cifar10", 115), ("imagenet512", 4 * 197)])
def test_cuda_train_step_launches_each_way(config, per_step):
    """The recipe's train step (its microbatches at 2 samples each): one
    forward and one backward launch a weight-normed layer a microbatch."""
    _needs_card()
    from tinyedm_tpu_torch.configs import build_training
    from tinyedm_tpu_torch.training.train_step import init_train_state, make_train_step

    model, diffuser, opt_cfg, ema_cfg, _, _ = build_training(config, "cuda", seed=0)
    state = init_train_state(model, opt_cfg, ema_cfg)
    step = make_train_step(model, diffuser, opt_cfg, ema_cfg)
    channels = model.denoiser.conv_in.weight.shape[1] - 1
    side = 32 if config == "cifar10" else 64
    batch = 2 * opt_cfg.accum_steps
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randn((batch, channels, side, side), generator=gen, device="cuda")
    labels = torch.randint(0, 1000, (batch,), generator=gen, device="cuda") if config == "imagenet512" else None
    before = mp.weight_norm_cast.launches, mp.weight_norm_cast.bwd_launches
    state, metrics = step(state, (images, labels), gen, 0)
    torch.cuda.synchronize()
    assert (mp.weight_norm_cast.launches - before[0], mp.weight_norm_cast.bwd_launches - before[1]) == (
        per_step, per_step)
    assert math.isfinite(float(metrics["train_loss"]))
