"""FLUX.1 (``models/flux.py``, ``ops/rope.py``) in the port against its plain
reference (``edmbench/reference/flux.py``, the benchmark's own copy), on the
CPU, at a tiny size on seeded weights (``reference/flux.py::draw_weights``:
modulations and the last layer not zeroed, RMSNorm scales U(0.5, 1.5)):
hidden 64, 2 heads of 32 with RoPE axes (8, 12, 12), 1 double and 2 single
blocks, 8x8x16 latents (16 image tokens) and 8 text tokens.

- The denoiser's forward, fp32 within 1e-5 relative L2 (the two differ in
  the order of fp32 sums and in the rotation's form: the reference's 2 x 2
  matrix product, the port's pairs); bf16 within 3e-2 (each linear rounds
  its input and output to bf16, 2^-8 relative, q and k are rounded once
  after RoPE). Also at 64x64x16 latents, 1032 tokens, on the flash route
  (``flash_attention_plain``, the kernels' math).
- Two ``make_train_step`` steps (caption dropout, Adam, the power EMA)
  against the reference's ``train``, by the benchmark's ``train_gaps``: fp32
  loss within 1e-6, gradients within 1e-5, the change and the EMA within
  2e-4 (as the DiT's: Adam's first sign-like step amplifies the order of
  sums where a gradient entry is near its eps); bf16 loss within 5e-3 and
  gradients within 3e-2.
- A Heun-4 solve through ``DeterministicSolver``: fp32 within 5e-5, bf16
  within 3e-2.
- ``ops/rope.py``'s Function against autograd through its plain
  composition, in fp64, with one scale and with one a token; text tokens
  (ids (0, 0, 0)) unrotated; the call counter.
- The parameter counts from the YAML: 11,901,408,320 at the published 19 +
  38 blocks, and the configuration's at its cut; the YAML read as YAML and as
  the JAX registry reads it.
- The training CLI on ``flux_dev_1024.yaml``, its widths cut by overrides,
  over cached latents and text embeddings (``data/text_latents.py``): an
  epoch, validation, a checkpoint, and a resume from it.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
import yaml

from edmbench.harness import ROOT, Layout, train_gaps
from edmbench.reference import flux as ref
from edmbench.reference.train import Readings
from tinyedm_tpu.config import registry as jax_registry
from tinyedm_tpu_torch import configs, train
from tinyedm_tpu_torch.config import registry, yaml_subset
from tinyedm_tpu_torch.data.text_latents import TextLatentsDataModule
from tinyedm_tpu_torch.diffusion.diffuser import Diffuser
from tinyedm_tpu_torch.diffusion.guidance import drop_labels
from tinyedm_tpu_torch.diffusion.protocols import TextConditioning
from tinyedm_tpu_torch.diffusion.solver import DeterministicSolver
from tinyedm_tpu_torch.models.edm import EDM
from tinyedm_tpu_torch.models.flux import FluxDenoiser, FluxEmbedding, image_ids
from tinyedm_tpu_torch.ops import rope
from tinyedm_tpu_torch.ops.attention import FLASH_MIN_TOKENS
from tinyedm_tpu_torch.training.ema import EMAConfig
from tinyedm_tpu_torch.training.train_step import OptimizerConfig, init_train_state, make_train_step

CONF = ROOT / "experiments" / "conf"
TXT, CONTEXT, VEC = 8, 32, 16


def small(dtype: str, depth: int = 1, single: int = 2) -> dict:
    return {"embedding": {"hidden_size": 64, "vec_in_dim": VEC, "frequency_dim": 256, "guidance_embed": True},
            "denoiser": {"in_channels": 64, "out_channels": 64, "context_in_dim": CONTEXT, "hidden_size": 64,
                         "mlp_ratio": 4.0, "num_heads": 2, "depth": depth, "depth_single_blocks": single,
                         "axes_dim": [8, 12, 12], "theta": 10000.0, "sigma_data": 1.0, "dtype": dtype},
            "training": {"batch_size": 3, "accum_steps": 1, "diffuser": {"P_mean": -0.4, "P_std": 1.0},
                         "lr": 1e-4, "betas": [0.9, 0.999], "eps": 1e-8, "label_dropout": 0.4,
                         "ema_lengths": [0.05]}}


def port_model(cfg: dict, weights: dict) -> EDM:
    den = {**cfg["denoiser"], "dtype": getattr(torch, cfg["denoiser"]["dtype"])}
    model = EDM(FluxEmbedding(**cfg["embedding"]), FluxDenoiser(**den))
    model.load_state_dict(weights)
    return model


def conditioning(b: int, g: torch.Generator) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return (torch.randn(b, TXT, CONTEXT, generator=g), torch.randn(b, VEC, generator=g),
            torch.rand(b, generator=g) * 4)


def worst_rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    n = a.shape[0]
    d = (a.float() - b.float()).reshape(n, -1)
    return float((d.norm(dim=1) / b.float().reshape(n, -1).norm(dim=1)).max())


@pytest.mark.parametrize("dtype,limit", [("float32", 1e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("side", [8, 64])
def test_forward_matches_the_reference(side, dtype, limit):
    cfg = small(dtype, single=2 if side == 8 else 1)
    assert (TXT + (side // 2) ** 2 >= FLASH_MIN_TOKENS) == (side == 64)
    weights = ref.draw_weights(cfg, side, "cpu")
    model = port_model(cfg, weights)
    g = torch.Generator().manual_seed(side)
    sigma = torch.exp(torch.randn(2, generator=g) * 1.2 - 0.4)
    noisy = torch.randn(2, 16, side, side, generator=g) * torch.sqrt(sigma ** 2 + 1).reshape(-1, 1, 1, 1)
    cond = conditioning(2, g)
    with torch.no_grad():
        out = model(noisy, sigma, TextConditioning(*cond))
    assert out.dtype == torch.float32
    assert worst_rel_l2(out, ref.denoise(weights, cfg, noisy, sigma, cond)) <= limit


def _program_readings(model, cfg: dict, batches: list, seeds: list[int]) -> Readings:
    t = cfg["training"]
    opt = OptimizerConfig(lr=t["lr"], label_dropout=t["label_dropout"])
    ema = EMAConfig(sigma_rels=tuple(t["ema_lengths"]))
    state = init_train_state(model, opt, ema)
    step = make_train_step(model, Diffuser(**t["diffuser"]), opt, ema)
    p0 = {k: v.detach().clone() for k, v in state.params.items()}
    sse, grads = [], None
    for (images, cond), seed in zip(batches, seeds):
        _, metrics = step(state, (images, TextConditioning(*cond)), torch.Generator().manual_seed(seed), 0)
        sse.append(float(metrics["sse"]))
        if grads is None:
            grads = {k: float(v.norm()) / (1 - opt.betas[0]) for k, v in state.mu.items()}
    with torch.no_grad():
        change = {k: float((v - p0[k]).norm()) for k, v in state.params.items()}
        ema_change = [{k: float((v - p0[k]).norm()) for k, v in tree.items()} for tree in state.ema]
    return Readings(sse, grads, change, ema_change)


@pytest.mark.parametrize("dtype,limits", [
    ("float32", {"loss_gap": 1e-6, "grad_gap": 1e-5, "change_gap": 2e-4, "ema_gap": 2e-4}),
    ("bfloat16", {"loss_gap": 5e-3, "grad_gap": 3e-2}),
])
def test_train_steps_match_the_reference(dtype, limits):
    cfg = small(dtype)
    weights = ref.draw_weights(cfg, 3, "cpu")
    g = torch.Generator().manual_seed(5)
    batches = [(torch.randn(3, 16, 8, 8, generator=g), conditioning(3, g)) for _ in range(2)]
    prog = _program_readings(port_model(cfg, weights), cfg, batches, [1000, 1001])
    gaps = train_gaps(prog, ref.train(cfg, weights, batches, [1000, 1001], 2, chunk=2))
    assert all(gaps[k] <= v for k, v in limits.items()), gaps


def test_caption_dropout_zeroes_whole_samples_from_the_step_generator():
    g = torch.Generator().manual_seed(0)
    cond = TextConditioning(*conditioning(64, g))
    out = drop_labels(cond, 0.5, torch.Generator().manual_seed(3))
    drop = torch.rand(64, generator=torch.Generator().manual_seed(3)) < 0.5
    assert 0 < int(drop.sum()) < 64
    assert torch.equal(out.txt, torch.where(drop[:, None, None], 0.0, cond.txt))
    assert torch.equal(out.y, torch.where(drop[:, None], 0.0, cond.y)) and out.guidance is cond.guidance
    assert torch.equal(cond[2:5].txt, cond.txt[2:5]) and torch.equal(cond[2:5].guidance, cond.guidance[2:5])


@pytest.mark.parametrize("dtype,limit", [("float32", 5e-5), ("bfloat16", 3e-2)])
def test_heun4_matches_the_reference(dtype, limit):
    cfg = small(dtype)
    weights = ref.draw_weights(cfg, 4, "cpu")
    g = torch.Generator().manual_seed(6)
    noise = torch.randn(2, 16, 8, 8, generator=g)
    cond = conditioning(2, g)
    with torch.no_grad():
        out = DeterministicSolver(num_steps=4).solve(port_model(cfg, weights), noise, TextConditioning(*cond))
    assert worst_rel_l2(out, ref.heun(weights, cfg, noise, cond, 4)) <= limit


@pytest.mark.parametrize("per_token", [False, True])
def test_rope_function_gradient_matches_autograd_in_fp64(per_token):
    g = torch.Generator().manual_seed(7)
    n, heads, hd = 12, 2, 32
    cos, sin = (t.double() for t in rope.rope_table(image_ids(4, 2, 4), (8, 12, 12), 10000.0))
    q, k = (torch.randn(2, n, heads, hd, generator=g, dtype=torch.float64, requires_grad=True) for _ in range(2))
    shape = (n, 1, hd) if per_token else (hd,)
    qs, ks = (torch.rand(shape, generator=g, dtype=torch.float64).add_(0.5).requires_grad_() for _ in range(2))
    gq, gk = (torch.randn(2, n, heads, hd, generator=g, dtype=torch.float64) for _ in range(2))
    outs = rope.qk_norm_rope(q, k, qs, ks, cos, sin)
    ours = torch.autograd.grad(outs, (q, k, qs, ks), (gq, gk))
    plain = (rope.qk_norm_rope_plain(q, qs, cos, sin), rope.qk_norm_rope_plain(k, ks, cos, sin))
    theirs = torch.autograd.grad(plain, (q, k, qs, ks), (gq, gk))
    for a, b in zip(outs, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(ours, theirs):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    assert torch.autograd.gradcheck(lambda *a: rope.qk_norm_rope(*a, cos, sin), (q, k, qs, ks))


def test_text_tokens_are_unrotated_and_the_calls_are_counted():
    g = torch.Generator().manual_seed(8)
    txt, h, w, hd = 5, 3, 4, 32
    ids = image_ids(txt, h, w)
    assert (ids[:txt] == 0).all() and ids[txt + w + 1].tolist() == [0, 1, 1]
    cos, sin = rope.rope_table(ids, (8, 12, 12), 10000.0)
    q, k = (torch.randn(1, txt + h * w, 2, hd, generator=g) for _ in range(2))
    scale = torch.rand(hd, generator=g) + 0.5
    before = rope.call_counts["qk_norm_rope", txt + h * w]
    rq, _ = rope.qk_norm_rope(q, k, scale, scale, cos, sin)
    assert rope.call_counts["qk_norm_rope", txt + h * w] == before + 1
    normed = q * torch.rsqrt(q.square().mean(-1, keepdim=True) + rope.EPS) * scale
    torch.testing.assert_close(rq[:, :txt], normed[:, :txt], rtol=1e-6, atol=1e-6)
    assert not torch.allclose(rq[:, txt:], normed[:, txt:], atol=1e-3)  # the image tokens turn


def _count(depth: int, single: int) -> int:
    cfg = configs.CONFIGS["flux_dev_1024"]
    den = {**cfg["denoiser"], "depth": depth, "depth_single_blocks": single, "dtype": torch.bfloat16}
    with torch.device("meta"):
        model = EDM(FluxEmbedding(**cfg["embedding"]), FluxDenoiser(**den))
    return sum(p.numel() for p in model.parameters())


def test_parameter_counts_from_the_yaml():
    den = configs.CONFIGS["flux_dev_1024"]["denoiser"]
    assert _count(19, 38) == 11_901_408_320 == Layout().config("flux_dev_1024")["published"]["parameters"]
    assert _count(4, 8) == 2_556_184_640 and _count(3, 6) == 1_933_169_728
    with torch.device("meta"):
        model = configs.model_from_config("flux_dev_1024")
    n = sum(p.numel() for p in model.parameters())
    assert n == _count(den["depth"], den["depth_single_blocks"]) == Layout().config("flux_dev_1024")["parameters"]
    net = model.denoiser.net
    qkv = net.double_blocks[0].img_attn.qkv.weight
    assert qkv.shape == (3 * 3072, 3072) and net.double_blocks[0].num_heads == 24 and sum(net.axes_dim) == 128
    assert den["depth_single_blocks"] == 2 * den["depth"] and model.conditional


def test_flux_yaml_reads_and_builds_the_recipe():
    path = CONF / "flux_dev_1024.yaml"
    text = path.read_text()
    assert yaml_subset.loads(text) == yaml.safe_load(text)
    assert registry.load_config(path) == jax_registry.load_config(path)
    spec = registry.instantiate(registry.load_config(path)["model"], accum_steps=1)
    with torch.device("meta"):
        ours, theirs = spec.build_model(), configs.model_from_config("flux_dev_1024")
    assert [(k, p.shape) for k, p in ours.state_dict().items()] == [
        (k, p.shape) for k, p in theirs.state_dict().items()]
    assert list(ours.state_dict()) == list(ref.param_shapes(Layout().config("flux_dev_1024")))
    assert spec.conditional and spec.build_optimizer_config().label_dropout == 0.05


def test_the_rope_table_is_fluxs_embednd():
    ids = image_ids(3, 4, 5)
    cos, sin = rope.rope_table(ids, (16, 56, 56), 10000.0)
    pe = ref.position_table({"denoiser": {"axes_dim": [16, 56, 56], "theta": 10000.0}}, 3, 4, 5, "cpu")
    np.testing.assert_array_equal(cos[:, 0].numpy(), pe[..., 0, 0].numpy())
    np.testing.assert_array_equal(sin[:, 0].numpy(), pe[..., 1, 0].numpy())


TINY_CLI = ["model.embedding.hidden_size=64", f"model.embedding.vec_in_dim={VEC}",
            f"model.denoiser.context_in_dim={CONTEXT}", "model.denoiser.num_heads=2", "model.denoiser.depth=1",
            "model.denoiser.depth_single_blocks=1", "model.denoiser.axes_dim=[8, 12, 12]"]


def test_the_cli_trains_it_on_cached_text_embeddings(tmp_path):
    rng = np.random.default_rng(0)
    data = tmp_path / "cache"
    data.mkdir()
    np.save(data / "latents.npy", rng.standard_normal((6, 16, 8, 8)).astype(np.float16))
    np.save(data / "txt.npy", rng.standard_normal((6, TXT, CONTEXT)).astype(np.float32))
    np.save(data / "pooled.npy", rng.standard_normal((6, VEC)).astype(np.float32))
    dm = TextLatentsDataModule(2, str(data), val_fraction=0.34, guidance=3.5)
    dm.setup()
    (images, cond), = list(dm.val_batches())
    x, c = dm.to_device(images, cond, "cpu")
    assert x.shape == (2, 16, 8, 8) and c.txt.shape == (2, TXT, CONTEXT) and c.y.shape == (2, VEC)
    assert torch.equal(c.guidance, torch.full((2,), 3.5)) and dm.steps_per_epoch() == 2
    run_dir = tmp_path / "run"
    base = ["--config-name=flux_dev_1024", "--device", "cpu"]
    overrides = [f"datamodule.data_dir={data}", "datamodule.batch_size=2", "datamodule.val_fraction=0.34",
                 f"trainer.out_dir={run_dir}", "trainer.max_epochs=1", *TINY_CLI]
    trainer = train.main(base + overrides)
    assert isinstance(trainer.model.denoiser, FluxDenoiser) and trainer.global_step == 2
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert any("val_loss" in r for r in rows) and all(np.isfinite(r["val_loss"]) for r in rows if "val_loss" in r)
    resumed = train.main(base + ["--resume", "--max-epochs", "2"] + overrides)
    assert resumed.global_step == 4
