"""DiT (``models/dit.py``) in the port against its plain reference
(``edmbench/reference/dit.py``, the benchmark's own copy), on the CPU.

- The denoiser's forward on seeded weights (``reference/dit.py::
  draw_weights``, the modulations not zeroed) at a small size on both
  attention routes: 8x8x4 latents, 16 tokens, hidden 96, depth 2 (the plain
  path below ``FLASH_MIN_TOKENS``), and 64x64x4, 1024 tokens, hidden 48,
  depth 1 (``flash_attention_plain``, the flash kernels' math). fp32 within
  1e-5 relative L2 (the two differ only in the order of fp32 sums: 2e-7
  measured); bf16 within 2e-2 (each linear rounds its input and output to
  bf16, 2^-8 relative, over every block: 5e-3 measured).
- One ``make_train_step`` step and a second (label dropout, Adam, the power
  EMA) against the reference's ``train``, by the benchmark's ``train_gaps``:
  fp32 loss within 1e-6, gradient leaves within 1e-5, the change and the EMA
  within 2e-4 (Adam's first, sign-like update amplifies the order of sums
  where a gradient entry is near its eps: 2.3e-5 measured); in bf16 the loss
  within 2e-3 and the gradient within 2e-2 (2.8e-4 and 2.3e-3 measured; the
  change there is no gauge: bf16 moves near-zero entries' signs). A Heun-2
  solve through ``DeterministicSolver`` against the reference's: fp32 within
  5e-5 (3e-6 measured: the solve divides by sigma down to 0.002), bf16 2e-2.
- The forced weight norm selects by module: every U-Net recipe keeps exactly
  the leaves the former rule by name took, and no DiT parameter is touched.
- DiT-XL/2 by name: 674,816,272 parameters at hidden 1152, depth 28, 16 heads
  of 72, patch 2 (1024 tokens, the flash route); its YAML reads as YAML and
  as the JAX registry reads it, and builds the same model; the CLIs train it
  (``train.py`` on a latpack store, the widths cut by overrides) and sample
  it (``generate.py`` from the checkpoint, and by name).
- The benchmark's ``dit_train`` kind run end to end at a tiny size, and a
  state left unchanged comes out not correct.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from edmbench.control_dit import readings
from edmbench.harness import ROOT, Layout, checks_from, train_gaps
from edmbench.reference import dit as ref
from edmbench.reference.train import Readings
from edmbench.traffic.dit_train import port_model
from tinyedm_tpu.config import registry as jax_registry
from tinyedm_tpu_torch import configs, generate, train
from tinyedm_tpu_torch.config import registry, yaml_subset
from tinyedm_tpu_torch.data import latpack
from tinyedm_tpu_torch.diffusion.diffuser import Diffuser
from tinyedm_tpu_torch.diffusion.solver import DeterministicSolver
from tinyedm_tpu_torch.models.dit import DiTDenoiser, DiTEmbedding
from tinyedm_tpu_torch.ops.attention import FLASH_MIN_TOKENS
from tinyedm_tpu_torch.training.ema import EMAConfig
from tinyedm_tpu_torch.training.state import force_weight_norm, weight_normed_names
from tinyedm_tpu_torch.training.train_step import OptimizerConfig, init_train_state, make_train_step

CONF = ROOT / "experiments" / "conf"
CELL = "dit_xl2_512.train.b32"


def small(dtype: str, side: int = 8, hidden: int = 96, depth: int = 2) -> dict:
    return {"embedding": {"hidden_size": hidden, "num_classes": 10, "frequency_dim": 256},
            "denoiser": {"input_size": side, "in_channels": 4, "out_channels": 4, "patch_size": 2,
                         "hidden_size": hidden, "depth": depth, "num_heads": 4, "mlp_ratio": 4.0,
                         "sigma_data": 0.5, "dtype": dtype},
            "training": {"batch_size": 4, "accum_steps": 1, "diffuser": {"P_mean": -0.4, "P_std": 1.0},
                         "lr": 1e-4, "betas": [0.9, 0.999], "eps": 1e-8, "label_dropout": 0.1,
                         "ema_lengths": [0.05]}}


def worst_rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    n = a.shape[0]
    d = (a.float() - b.float()).reshape(n, -1)
    return float((d.norm(dim=1) / b.float().reshape(n, -1).norm(dim=1)).max())


@pytest.mark.parametrize("dtype,limit", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("side,hidden,depth", [(8, 96, 2), (64, 48, 1)])
def test_forward_matches_the_reference(side, hidden, depth, dtype, limit):
    cfg = small(dtype, side, hidden, depth)
    assert ((side // 2) ** 2 >= FLASH_MIN_TOKENS) == (side == 64)
    weights = ref.draw_weights(cfg, side + depth, "cpu")
    model = port_model(cfg, "cpu", weights)
    g = torch.Generator().manual_seed(side)
    sigma = torch.exp(torch.randn(3, generator=g) * 1.2 - 0.4)
    noisy = torch.randn(3, 4, side, side, generator=g) * torch.sqrt(sigma ** 2 + 0.25).reshape(-1, 1, 1, 1)
    labels = torch.tensor([1, -1, 7])
    with torch.no_grad():
        out = model(noisy, sigma, labels)
    assert out.dtype == torch.float32
    assert worst_rel_l2(out, ref.denoise(weights, cfg, noisy, sigma, labels)) <= limit


def _program_readings(model, cfg: dict, batches: list, seeds: list[int]) -> Readings:
    t = cfg["training"]
    opt = OptimizerConfig(lr=t["lr"], label_dropout=t["label_dropout"])
    ema = EMAConfig(sigma_rels=tuple(t["ema_lengths"]))
    state = init_train_state(model, opt, ema)
    step = make_train_step(model, Diffuser(**t["diffuser"]), opt, ema)
    p0 = {k: v.detach().clone() for k, v in state.params.items()}
    sse, grads = [], None
    for batch, seed in zip(batches, seeds):
        _, metrics = step(state, batch, torch.Generator().manual_seed(seed), 0)
        sse.append(float(metrics["sse"]))
        if grads is None:
            grads = {k: float(v.norm()) / (1 - opt.betas[0]) for k, v in state.mu.items()}
    with torch.no_grad():
        change = {k: float((v - p0[k]).norm()) for k, v in state.params.items()}
        ema_change = [{k: float((v - p0[k]).norm()) for k, v in tree.items()} for tree in state.ema]
    return Readings(sse, grads, change, ema_change)


@pytest.mark.parametrize("dtype,limits", [
    ("float32", {"loss_gap": 1e-6, "grad_gap": 1e-5, "change_gap": 2e-4, "ema_gap": 2e-4}),
    ("bfloat16", {"loss_gap": 2e-3, "grad_gap": 2e-2}),
])
def test_train_steps_match_the_reference(dtype, limits):
    cfg = small(dtype)
    weights = ref.draw_weights(cfg, 3, "cpu")
    g = torch.Generator().manual_seed(5)
    batches = [(torch.randn(4, 4, 8, 8, generator=g) * 0.5, torch.randint(0, 10, (4,), generator=g))
               for _ in range(2)]
    prog = _program_readings(port_model(cfg, "cpu", weights), cfg, batches, [1000, 1001])
    gaps = train_gaps(prog, ref.train(cfg, weights, batches, [1000, 1001], 2, chunk=3))
    assert all(gaps[k] <= v for k, v in limits.items()), gaps


@pytest.mark.parametrize("dtype,limit", [("float32", 5e-5), ("bfloat16", 2e-2)])
def test_heun2_matches_the_reference(dtype, limit):
    cfg = small(dtype)
    weights = ref.draw_weights(cfg, 4, "cpu")
    noise = torch.randn(3, 4, 8, 8, generator=torch.Generator().manual_seed(6))
    labels = torch.tensor([1, -1, 2])
    with torch.no_grad():
        out = DeterministicSolver(num_steps=2).solve(port_model(cfg, "cpu", weights), noise, labels)
    assert worst_rel_l2(out, ref.heun(weights, cfg, noise, labels, 2)) <= limit


@pytest.mark.parametrize("name", ["cifar10", "smoke", "imagenet512", "mnist", "imagenet"])
def test_weight_norm_selects_the_unets_former_leaves(name):
    with torch.device("meta"):
        model = configs.model_from_config(name)
    former = [k for k, p in model.named_parameters() if k.rsplit(".", 1)[-1] == "weight" and p.ndim in (2, 4)]
    assert list(weight_normed_names(model)) == former


def test_force_weight_norm_leaves_every_dit_parameter():
    cfg = small("float32")
    model = port_model(cfg, "cpu", ref.draw_weights(cfg, 0, "cpu"))
    by_name = [k for k, p in model.named_parameters() if k.rsplit(".", 1)[-1] == "weight" and p.ndim in (2, 4)]
    assert len(by_name) == 15 and weight_normed_names(model) == ()  # the former rule took every linear
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    state = init_train_state(model, OptimizerConfig())
    force_weight_norm(state.params, weight_normed_names(model))
    assert all(torch.equal(state.params[k], v) for k, v in before.items())


def test_dit_xl2_by_name_at_its_published_widths():
    with torch.device("meta"):
        model = configs.model_from_config("dit_xl2_512")
    assert isinstance(model.embedding, DiTEmbedding) and isinstance(model.denoiser, DiTDenoiser)
    net = model.denoiser.net
    attn = net.blocks[0].attn
    assert (len(net.blocks), attn.qkv.weight.shape[1], attn.num_heads, net.patch_size) == (28, 1152, 16, 2)
    assert attn.qkv.weight.shape[1] // attn.num_heads == 72 and net.grid ** 2 == 1024 >= FLASH_MIN_TOKENS
    n = sum(p.numel() for p in model.parameters())
    assert n == 674_816_272 == Layout().config("dit_xl2_512")["parameters"]
    assert net.blocks[0].mlp.fc1.weight.shape == (4608, 1152) and net.blocks[0].dtype is torch.bfloat16


def test_dit_yaml_reads_and_builds_the_recipe():
    path = CONF / "dit_xl2_512.yaml"
    text = path.read_text()
    assert yaml_subset.loads(text) == yaml.safe_load(text)
    assert registry.load_config(path) == jax_registry.load_config(path)
    spec = registry.instantiate(registry.load_config(path)["model"], accum_steps=8)
    with torch.device("meta"):
        ours, theirs = spec.build_model(fused="on"), configs.model_from_config("dit_xl2_512")
    assert [(k, p.shape) for k, p in ours.state_dict().items()] == [
        (k, p.shape) for k, p in theirs.state_dict().items()]
    assert spec.conditional and spec.build_optimizer_config().label_dropout == 0.1


MEAN, STD = (5.81, 3.25, 0.12, -2.15), (4.17, 4.62, 3.71, 3.28)  # the latent writer's mapping
TINY = ["model.embedding.hidden_size=48", "model.denoiser.depth=1", "model.denoiser.num_heads=4",
        "model.denoiser.input_size=8"]


def test_the_clis_train_and_sample_it(tmp_path, capsys, monkeypatch):
    rng = np.random.default_rng(0)
    for sub in ("latents", "labels"):
        (tmp_path / sub).mkdir()
    for i in range(24):
        np.save(tmp_path / "latents" / f"{i}.npy", rng.standard_normal((4, 8, 8)).astype(np.float32))
        np.save(tmp_path / "labels" / f"{i}.npy", np.int64(rng.integers(0, 1000)))
    store = tmp_path / "latents.latpack"
    latpack.main([str(tmp_path / "latents"), str(tmp_path / "labels"), str(store)])
    run_dir = tmp_path / "run"
    trainer = train.main([
        "--config-name=dit_xl2_512", "--device", "cpu", f"datamodule.data_file={store}", "datamodule.batch_size=8",
        "datamodule.num_workers=1", f"trainer.out_dir={run_dir}", "trainer.max_epochs=1",
        "trainer.check_val_every_n_epoch=1", "callbacks.checkpoint_callback.every_n_epochs=1",
        "callbacks.generate_callback.every_n_epochs=1", "callbacks.generate_callback.img_shape=[4, 8, 8]",
        "callbacks.generate_callback.num_classes=2", "callbacks.generate_callback.num_samples_per_class=1",
        "callbacks.generate_callback.solver.num_steps=2", *TINY])
    assert isinstance(trainer.model.denoiser, DiTDenoiser) and trainer.spec.accum_steps == 8
    assert trainer.global_step == 2 and len(trainer.state.ema) == 1
    rows = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert all(np.isfinite(r["val_loss"]) for r in rows if "val_loss" in r)
    samples = tmp_path / "samples"
    generate.main(["--ckpt_path", str(run_dir / "checkpoints"), "--load_ema", "--output_dir", str(samples),
                   "--num_samples", "3", "--batch_size", "2", "--image_size", "8", "--num_classes", "1000",
                   "--num_channels", "4", "--num_steps", "2", "--mean", *map(str, MEAN), "--std", *map(str, STD),
                   "--device", "cpu"])
    assert "EMA weights loaded." in capsys.readouterr().out
    assert len(list(samples.glob("*.png"))) == 3
    dit = configs.CONFIGS["dit_xl2_512"]
    tiny = {**dit, "embedding": {**dit["embedding"], "hidden_size": 48},
            "denoiser": {**dit["denoiser"], "hidden_size": 48, "depth": 1, "num_heads": 4,
                         "input_size": 8}}
    monkeypatch.setitem(configs.CONFIGS, "dit_tiny", tiny)
    generate.generate(str(tmp_path / "by_name"), 2, 8, 2, config="dit_tiny", num_classes=1000, num_steps=2,
                      mean=MEAN, std=STD, device="cpu", guidance_scale=2.0)
    assert len(list((tmp_path / "by_name").glob("*.png"))) == 2


@pytest.fixture(scope="module")
def tiny_layout(tmp_path_factory) -> Layout:
    """A copy of the benchmark with a tiny DiT configuration and a
    ``dit_train`` cell added as new files and entries."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "edmbench", root / "edmbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = {**Layout().config("dit_xl2_512"), "name": "dit_tiny"}
    cfg.update(embedding=small("bfloat16")["embedding"], denoiser=small("bfloat16")["denoiser"])
    (root / "edmbench" / "configs" / "dit_tiny.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "dit_tiny", "source": cfg["source"], "file": "edmbench/configs/dit_tiny.json",
                             "reduced": sorted(cfg["reduced"]), "why": "test size"})
    real = Layout().cell(CELL)
    cell = {**real, "config": "dit_tiny", "traffic": "train.b4",
            "params": {"batch": 4, "pool": 2, "check_steps": 2, "trace_units": 2},
            "limits": real["limits"]}
    (root / "edmbench" / "workloads" / "dit_tiny.train.b4.json").write_text(json.dumps(cell))
    bench["workloads"].append({"name": "dit_tiny.train.b4", "config": "dit_tiny", "traffic": "train.b4",
                               "chips": 1, "why": "test size"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("dit_tiny.train.b4")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return Layout(root)


RUN = """
import sys
sys.path.insert(0, {root!r})
from pathlib import Path
from edmbench import run
from edmbench.harness import Layout
{fault}
sys.exit(run.main(["--workload", "dit_tiny.train.b4", "--seed", "{seed}", "--seconds", "0.5", "--trace", "{trace}"],
                  Layout(Path({layout!r})), device="cpu"))
"""


def _run(layout: Layout, seed: int, trace: int = 0, fault: str = "") -> dict:
    """``run.main`` on the CPU in a process of its own: the benchmark refuses
    a run that loaded JAX, which this test process has."""
    code = RUN.format(root=str(ROOT), layout=str(layout.root), seed=seed, trace=trace, fault=fault)
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_the_dit_kind_runs_and_prints_the_result_line(tiny_layout, trace):
    result = _run(tiny_layout, 2**31 + 17, trace)
    assert result["correct"] is True and result["attempted"] > 0 and result["failed"] == 0
    assert set(result["checks"]) == {"loss_gap", "grad_gap", "change_gap", "ema_gap"}
    if trace:
        assert "mfu.train" in result["metrics"] and set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == {"train_samples_per_s", "peak_mem_gib", "setup_s"}


UNCHANGED = """
import torch
import tinyedm_tpu_torch.training.train_step as ts
real = ts.make_train_step
def make_train_step(*args, **kwargs):
    step = real(*args, **kwargs)
    def unchanged(state, batch, gen, count, interrupt=False):
        saved = [{k: v.clone() for k, v in d.items()} for d in (state.params, *state.ema)]
        out = step(state, batch, gen, count)
        with torch.no_grad():
            for d, s in zip((state.params, *state.ema), saved):
                for k in d:
                    d[k].copy_(s[k])
        return out
    return unchanged
ts.make_train_step = make_train_step
"""


def test_the_control_and_a_half_batch_come_out_not_correct(tiny_layout):
    """The reference in fp8 and the reference without half of each
    microbatch, each against the fp32 reference, fail a limit of the cell
    that the program, on the same seed, keeps."""
    limits = tiny_layout.cell("dit_tiny.train.b4")["limits"]
    r = readings(tiny_layout, "dit_tiny.train.b4", 77, True, torch.device("cpu"))
    assert all(c.ok for c in checks_from(r["program"], limits)), r["program"]
    for fault in ("control", "half_batch"):
        assert not all(c.ok for c in checks_from(r[fault], limits)), r[fault]


def test_a_state_left_unchanged_comes_out_not_correct(tiny_layout):
    result = _run(tiny_layout, 2**32 + 5, fault=UNCHANGED)
    assert result["correct"] is False and result["checks"]["change_gap"]["value"] == pytest.approx(1.0)
