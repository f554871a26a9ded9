"""The learning-level checks of the port (``tinyedm_tpu_torch.validate_learning``,
``soak`` and ``soak_reference_pngs``) against the JAX experiments.

The data laws are bit-equal to the JAX experiments' functions, loaded here by
path (the port keeps its own copies and imports nothing of ``experiments/``).
The validation model, port against JAX from one set of weights at batch 4:
fp32 within 1e-5 max abs, bf16 within 2e-2 relative L2 (``test_torch_unet.py``'s
bf16 tolerance: each side rounds at its own places). The criterion against a
numpy transcription of the JAX experiment's closure. The soak's CLI on the CPU
at a narrow width (the test's overrides on top of the recipe's five), a few
steps across both lr boundaries, stopped and resumed.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import nhwc_to_torch, rel_l2, torch_to_nhwc
from tinyedm_tpu.models.edm import EDM as JaxEDM
from tinyedm_tpu.models.layers import Embedding as JaxEmbedding
from tinyedm_tpu.models.unet import Denoiser as JaxDenoiser
from tinyedm_tpu_torch import soak, soak_reference_pngs
from tinyedm_tpu_torch import validate_learning as vl
from tinyedm_tpu_torch.training.callbacks import read_png
from tinyedm_tpu_torch.training.lr_schedule import make_lr_fn
from tinyedm_tpu_torch.utils.interop import from_jax_variables

torch.set_num_threads(1)

EXPERIMENTS = Path(__file__).resolve().parent.parent / "experiments"


def _experiment(name: str):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", EXPERIMENTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    sys.path.insert(0, str(EXPERIMENTS))  # soak_reference_pngs imports soak by name
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(str(EXPERIMENTS))
    return module


# ---------------------------------------------------------------------------
# The data laws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [{}, dict(num_classes=3, size=8, n_per_class=5, seed=2)], ids=["default", "small"])
def test_make_dataset_is_the_jax_experiments(kwargs):
    ours, theirs = vl.make_dataset(**kwargs), _experiment("validate_learning").make_dataset(**kwargs)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    if not kwargs:
        assert ours[0].shape == (2048, 16, 16, 1) and ours[2].shape == (4, 16, 16, 1)


@pytest.mark.parametrize("kwargs", [{}, dict(num_classes=4, size=12, channels=2, seed=3)], ids=["default", "small"])
def test_make_templates_is_the_jax_experiments(kwargs):
    ours, theirs = soak.make_templates(**kwargs), _experiment("soak").make_templates(**kwargs)
    assert ours.dtype == theirs.dtype == np.float32 and np.array_equal(ours, theirs)


@pytest.mark.parametrize("i", [0, 7, 4000])
def test_draw_batch_is_the_jax_experiments(i):
    """A transcription of the JAX soak's ``draw_batch`` closure (seed 3, batch 6)."""
    templates = soak.make_templates()
    rng_np = np.random.default_rng((3, i))
    cls = rng_np.integers(0, templates.shape[0], 6)
    noise = rng_np.normal(scale=0.1, size=(6, 32, 32, 3)).astype(np.float32)
    images, labels = soak.draw_batch(templates, 3, i, 6)
    assert np.array_equal(images, templates[cls] + noise) and np.array_equal(labels, cls.astype(np.int32))
    assert labels.dtype == np.int32 and images.dtype == np.float32


# ---------------------------------------------------------------------------
# The validation model
# ---------------------------------------------------------------------------


def _jax_model(dtype, mod_fp32: bool):
    """experiments/validate_learning.py's model (:104-121)."""
    return JaxEDM(
        embedding=JaxEmbedding(fourier_dim=32, embedding_dim=64, num_classes=4),
        denoiser=JaxDenoiser(
            in_channels=1, out_channels=1, embedding_dim=64, num_heads=2, sigma_data=0.5,
            encoder_block_types=("Enc", "Enc", "EncD", "EncA"),
            decoder_block_types=("DecA", "Dec", "DecU", "Dec", "Dec", "Dec"),
            encoder_out_channels=(64, 64, 96, 96),
            decoder_out_channels=(96, 96, 64, 64, 64, 64),
            skip_connections=(True, True, False, True, True, True),
            dropout_rate=0.05, dtype=dtype, mod_fp32=mod_fp32,
        ),
    )


@pytest.mark.parametrize("dtype,mod_fp32", [("float32", True), ("bfloat16", True), ("bfloat16", False)])
def test_validation_model_matches_jax(dtype, mod_fp32):
    images, labels, _ = vl.make_dataset()
    rng = np.random.default_rng(0)
    idx = rng.integers(0, len(images), 4)
    sigma = np.asarray([0.05, 0.4, 2.0, 30.0], np.float32)
    x = (images[idx] + rng.standard_normal((4, 16, 16, 1)).astype(np.float32) * sigma[:, None, None, None])
    labs = labels[idx]
    jmodel = _jax_model(getattr(jnp, dtype), mod_fp32)
    variables = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), jnp.asarray(sigma),
                                     jnp.asarray(labs))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables = {k: dict(v) for k, v in variables.items()}
    variables["params"]["denoiser"] = {**variables["params"]["denoiser"], "gain_out": np.float32(1.0)}
    ref = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x), jnp.asarray(sigma), jnp.asarray(labs)))

    port = vl.build_model(mod_fp32, "cpu", getattr(torch, dtype))
    assert sum(p.numel() for p in port.parameters()) == sum(
        v.size for v in jax.tree_util.tree_leaves(variables["params"]))
    port.load_state_dict(from_jax_variables(variables, port))
    with torch.no_grad():
        out = torch_to_nhwc(port(nhwc_to_torch(x), torch.from_numpy(sigma), torch.from_numpy(labs.astype(np.int64))))
    assert out.shape == ref.shape and np.isfinite(out).all()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    else:
        assert rel_l2(out, ref) <= 2e-2


@pytest.fixture(scope="module")
def dataset():
    return vl.make_dataset()


@pytest.mark.parametrize("guided", [False, True], ids=["plain", "label-dropout"])
def test_three_train_steps_give_finite_losses(dataset, guided):
    images, labels, _ = dataset
    model = vl.build_model(True, "cpu")
    out = vl.train(model, images, labels, steps=3, guided=guided, batch_size=8, log_every=1, log=lambda s: None)
    losses = list(out["losses"].values())
    assert sorted(out["losses"]) == [0, 1, 2] and all(math.isfinite(v) for v in losses)
    assert out["final_loss"] == losses[-1] and out["state"].step == 3
    assert out["guide"] is None and out["ms_per_step"] > 0


def test_the_ema_snapshot_stays_as_taken(dataset):
    """The step updates the state in place: the snapshot of step 0 must be a
    copy, equal to the EMA of a one-step run and unmoved by steps 1-2."""
    images, labels, _ = dataset
    one = vl.train(vl.build_model(True, "cpu"), images, labels, steps=1, batch_size=8, log=lambda s: None)
    three = vl.train(vl.build_model(True, "cpu"), images, labels, steps=3, batch_size=8, guide_step=0,
                     log=lambda s: None)
    guide, live = three["guide"], three["state"].ema[0]
    assert guide.keys() == live.keys() == one["state"].ema[0].keys()
    assert all(torch.equal(guide[k], one["state"].ema[0][k]) for k in guide)
    assert any(not torch.equal(guide[k], live[k]) for k in guide)
    assert all(guide[k].data_ptr() != live[k].data_ptr() for k in guide)


def test_sampling_with_guidance_runs_on_the_ema(dataset):
    """run() at a few steps: every stage, in order, the sims of each."""
    stages = []
    result = vl.run(device="cpu", steps=2, batch_size=4, n_per=2, guided=True, autoguided=True, guide_step=1,
                    solver="dpmpp2m", solver_steps=4, log=lambda s: None, stage=stages.append)
    assert stages == ["train", "sample", "cfg2", "cfg2-interval", "auto1.5", "auto2.0"]
    assert len(result["base"]) == 4 and set(result["guided"]) == set(stages[2:])
    assert all(len(rows) == 4 and all(len(r) == 5 for r in rows) for rows in result["guided"].values())
    assert result["ok"] is False  # two steps learn nothing
    assert all(np.isfinite(v) for rows in result["guided"].values() for r in rows for v in r[:4])


# ---------------------------------------------------------------------------
# The criterion
# ---------------------------------------------------------------------------


def _jax_criterion(samples, labs, templates, guided_samples=()):
    """experiments/validate_learning.py's class_sims closure and pass rules
    (:176-227), transcribed."""
    num_classes = templates.shape[0]

    def class_sims(samples):
        out = []
        for c in range(num_classes):
            mean_c = samples[np.asarray(labs) == c].mean(axis=0).reshape(-1)
            sims = []
            for c2 in range(num_classes):
                t = templates[c2].reshape(-1)
                sims.append(float(mean_c @ t / (np.linalg.norm(mean_c) * np.linalg.norm(t) + 1e-8)))
            out.append((sims[c], max(s for i, s in enumerate(sims) if i != c)))
        return out

    ok = True
    base = class_sims(samples)
    for own, best_other in base:
        ok &= own > 0.9 and own > best_other + 0.1
    for g in guided_samples:
        for c, (own, best_other) in enumerate(class_sims(g)):
            ok &= own > 0.9 and own - best_other > (base[c][0] - base[c][1]) - 0.02
    return base, ok


def _samples(templates, labs, noise, swap=False, seed=0):
    rng = np.random.default_rng(seed)
    src = templates[(labs + 1) % templates.shape[0]] if swap else templates[labs]
    return (src + rng.standard_normal(src.shape).astype(np.float32) * noise).astype(np.float32)


@pytest.mark.parametrize("case", ["pass", "noisy", "swapped", "guided-pass", "guided-blurred"])
def test_criterion_matches_the_jax_closure(case):
    _, _, templates = vl.make_dataset()
    labs = np.repeat(np.arange(4), 16)
    base_noise = {"noisy": 3.0}.get(case, 0.2)
    samples = _samples(templates, labs, base_noise, swap=case == "swapped")
    guided = []
    if case.startswith("guided"):
        guided = [_samples(templates, labs, 0.1, seed=1),
                  _samples(templates, labs, 0.1, seed=2) * (0.3 if case == "guided-blurred" else 1.0)
                  + (_samples(templates, labs, 0.0, swap=True) * 0.7 if case == "guided-blurred" else 0.0)]
    base, ok = _jax_criterion(samples, labs, templates, guided)
    ours = vl.class_sims(samples, labs, templates)
    assert ours == base
    our_ok = all(vl.identity_ok(*p) for p in ours) and all(
        vl.guided_ok(*p, ours[c]) for g in guided for c, p in enumerate(vl.class_sims(g, labs, templates)))
    assert our_ok == ok
    assert ok == (case in ("pass", "guided-pass"))


# ---------------------------------------------------------------------------
# The soak
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rampup,steady", [(100, 200), (500, 8000), (3, 2)])
def test_ref_lr_is_the_ports_schedule_at_both_boundaries(rampup, steady):
    lr_fn = make_lr_fn(0.02, rampup, steady)
    steps = [0, 1] + [b + d for b in (rampup, rampup + steady) for d in range(-2, 3)] + [rampup + 3 * steady]
    for step in steps:
        ours, ref = float(lr_fn(step)), soak.ref_lr(step, 0.02, rampup, steady)
        assert math.isclose(ours, ref, rel_tol=5e-5, abs_tol=1e-12), (step, ours, ref)
    assert soak.ref_lr(rampup + steady, 0.02, rampup, steady) == 0.02
    assert soak.ref_lr(rampup + 2 * steady, 0.02, rampup, steady) == pytest.approx(0.02 / math.sqrt(2.0))


# narrow widths on top of the recipe's overrides: the topology of smoke.yaml
# at 16/32 channels (cifar10.yaml's is 35.62 M parameters)
NARROW = [
    "model.embedding.embedding_dim=32", "model.embedding.fourier_dim=16",
    "model.denoiser.encoder_block_types=[Enc, EncD, EncA]",
    "model.denoiser.decoder_block_types=[DecA, Dec, DecU, Dec, Dec]",
    "model.denoiser.encoder_out_channels=[16, 32, 32]",
    "model.denoiser.decoder_out_channels=[32, 32, 16, 16, 16]",
    "model.denoiser.skip_connections=[True, True, False, True, True]",
    "model.denoiser.num_heads=2",
]
SOAK = ["--rampup", "2", "--steady", "2", "--decay", "2", "--batch", "4", "--device", "cpu", "--ckpt_every", "3"]


def _metrics(tag):
    return [json.loads(line) for line in (Path("runs") / f"soak_{tag}" / "metrics.jsonl").read_text().splitlines()]


def test_soak_cli_stops_resumes_and_stays_on_the_formula(tmp_path, monkeypatch, capsys):
    recipe = soak.spec_overrides
    monkeypatch.setattr(soak, "spec_overrides", lambda args, steady: recipe(args, steady) + NARROW)
    monkeypatch.chdir(tmp_path)
    rc_whole = soak.main(SOAK + ["--tag", "whole"])
    rc_first = soak.main(SOAK + ["--tag", "split", "--stop_at", "5"])
    assert sorted(p.name for p in (tmp_path / "runs" / "soak_split" / "checkpoints").iterdir()) == ["3", "5"]
    rc_resumed = soak.main(SOAK + ["--tag", "split", "--resume"])
    out = capsys.readouterr().out
    assert "soak: resumed at step 5 (decay phase)" in out and "unconditional" in out
    whole, split = _metrics("whole"), _metrics("split")
    # every step is logged at this length (each lies within 2 of a boundary)
    assert [r["step"] for r in whole] == [r["step"] for r in split] == list(range(6))
    for r in whole:
        assert math.isclose(r["lr"], soak.ref_lr(r["step"], 0.02, 2, 2), rel_tol=5e-5, abs_tol=1e-12)
        assert math.isfinite(r["train_loss"])
    # batch i from (seed, i), step i's noise from (seed + 1, i): the resumed
    # run trains as the unbroken one did, bit for bit on the CPU
    assert [r["train_loss"] for r in split] == [r["train_loss"] for r in whole]
    summary = json.loads((tmp_path / "runs" / "soak_split" / "summary.json").read_text())
    assert summary["resumed_at"] == 5 and summary["steps"] == 6 and summary["lr_points_on_formula"] == 1
    assert (tmp_path / "runs" / "soak_split" / "checkpoints" / "6" / "config.json").exists()
    # the verdict: finite, and a fresh run below its first loss
    assert rc_resumed == 0
    for rc, records in ((rc_whole, whole), (rc_first, split[:5])):
        assert rc == (0 if records[-1]["train_loss"] < records[0]["train_loss"] else 1)
    assert soak.main(SOAK + ["--tag", "split", "--resume"]) == 0  # nothing left to do
    assert "nothing to do" in capsys.readouterr().out


def test_soak_refuses_decay_without_steady():
    with pytest.raises(SystemExit):
        soak.main(["--decay", "5", "--device", "cpu"])


def test_soak_reference_pngs_are_the_jax_scripts(tmp_path, monkeypatch):
    args = ["--num", "40", "--batch", "16", "--seed", "5"]
    assert soak_reference_pngs.main(["--out", str(tmp_path / "ours")] + args) == 0
    theirs = _experiment("soak_reference_pngs")
    monkeypatch.setattr(sys, "argv", ["soak_reference_pngs.py", "--out", str(tmp_path / "theirs")] + args)
    theirs.main()
    names = sorted(p.name for p in (tmp_path / "ours").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "theirs").iterdir()) == sorted(f"{i}.png" for i in range(40))
    for name in names:
        a, b = read_png(tmp_path / "ours" / name), read_png(tmp_path / "theirs" / name)
        assert a.shape == (32, 32, 3) and np.array_equal(a, b)
