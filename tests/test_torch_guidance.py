"""The port's guidance against the JAX package's ``diffusion/guidance.py``
and the guidance and sampler rules of its generate CLI.

Mirrors ``tests/test_guidance.py``: the linear combination and the scale-1
identity of CFG and autoguidance on toy denoisers (1e-6 relative), CFG's
required labels, CFG on the smoke model against JAX's ``cfg_denoise_fn``
(fp32, 1e-5 relative L2), the interval gate's boundaries, and the gate
inside Heun and DPM-Solver++(2M) against the JAX solves (1e-5), with the
guided (stacked, batch 2B) forwards counted: outside the interval the
stacked forward does not run. ``drop_labels``: the dropped share and
passthrough at p = 0. The CLI's rule table is held against the JAX CLI's
``generate`` (its checkpoint loader replaced by the smoke model) where JAX
raises; a CPU run of the smoke config with churn and CFG writes PNGs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import IMAGE, nhwc_to_torch, rel_l2, small_models, torch_to_nhwc
from tinyedm_tpu import generate as jax_generate_module
from tinyedm_tpu.diffusion import guidance as jg
from tinyedm_tpu.diffusion.solver import DeterministicSolver as JaxHeun
from tinyedm_tpu.diffusion.solver import MultistepSolver as JaxMultistep
from tinyedm_tpu_torch.diffusion.guidance import (
    NULL_LABEL,
    IntervalGate,
    autoguidance_denoise_fn,
    cfg_denoise_fn,
    drop_labels,
)
from tinyedm_tpu_torch.diffusion.solver import DeterministicSolver, MultistepSolver, StochasticSolver
from tinyedm_tpu_torch.generate import generate, main
from tinyedm_tpu_torch.models.edm import EDM
from tinyedm_tpu_torch.utils.interop import save_weights


def _toy(x, sigma, labels):
    """A label-dependent affine map; null labels take the zero branch."""
    lab = labels.float().reshape(-1, 1, 1, 1)
    return x * 0.5 + torch.where(lab >= 0, lab, torch.zeros_like(lab))


def _x(seed=0, shape=(4, 1, 8, 8)):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def test_cfg_wrapper_linearity_and_scale_one_identity():
    x, sigma, labels = _x(), torch.ones(4), torch.arange(4)
    d_cond, d_uncond = _toy(x, sigma, labels), _toy(x, sigma, torch.full_like(labels, NULL_LABEL))
    for s in (0.0, 1.0, 2.5):
        got = cfg_denoise_fn(_toy, s)(x, sigma, labels)
        torch.testing.assert_close(got, d_uncond + s * (d_cond - d_uncond), rtol=1e-6, atol=0)
    torch.testing.assert_close(cfg_denoise_fn(_toy, 1.0)(x, sigma, labels), d_cond, rtol=1e-6, atol=0)


def test_autoguidance_linearity_and_scale_one_identity():
    main_fn = lambda x, s, l: x * 2.0  # noqa: E731
    guide_fn = lambda x, s, l: x * 0.5 + 1.0  # noqa: E731
    x, sigma = _x(), torch.ones(4)
    d_main, d_guide = main_fn(x, sigma, None), guide_fn(x, sigma, None)
    for s in (0.0, 1.0, 2.5):
        got = autoguidance_denoise_fn(main_fn, guide_fn, s)(x, sigma, None)
        torch.testing.assert_close(got, d_guide + s * (d_main - d_guide), rtol=1e-6, atol=0)
    torch.testing.assert_close(autoguidance_denoise_fn(main_fn, guide_fn, 1.0)(x, sigma, None), d_main,
                               rtol=1e-6, atol=1e-6)


def test_cfg_wrapper_requires_labels():
    with pytest.raises(ValueError, match="labels"):
        cfg_denoise_fn(lambda x, s, l: x, 2.0)(torch.zeros((2, 1, 4, 4)), torch.ones(2), None)


def _jax_fn(jmodel, variables):
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    return lambda x, s, l: jmodel.apply(jvars, x, s, l)


def test_cfg_smoke_model_matches_jax():
    """One stacked forward of the smoke model (fp32, gain_out 1) against
    JAX's cfg_denoise_fn, and against the two forwards it stands for."""
    jmodel, variables, port = small_models(10, torch.float32)
    x = np.random.default_rng(1).standard_normal(IMAGE).astype(np.float32)
    sigma, labels = np.asarray([1.3, 0.4], np.float32), np.asarray([3, 8], np.int32)
    ref = jax.jit(jg.cfg_denoise_fn(_jax_fn(jmodel, variables), 3.0))(
        jnp.asarray(x), jnp.asarray(sigma), jnp.asarray(labels))
    xt, st, lt = nhwc_to_torch(x), torch.from_numpy(sigma), torch.from_numpy(labels).long()
    with torch.no_grad():
        got = cfg_denoise_fn(port, 3.0)(xt, st, lt)
        d_cond, d_uncond = port(xt, st, lt), port(xt, st, torch.full_like(lt, NULL_LABEL))
    assert rel_l2(torch_to_nhwc(got), np.asarray(ref)) <= 1e-5
    assert rel_l2(torch_to_nhwc(d_cond), torch_to_nhwc(d_uncond)) > 1e-3  # the label path is live
    torch.testing.assert_close(got, d_uncond + 3.0 * (d_cond - d_uncond), rtol=2e-5, atol=2e-5)


def _shift(x, sigma, labels):
    """cond rows return x, null-label rows x + 1: guided = x + 1 - s."""
    return x + (labels == NULL_LABEL).float().reshape(-1, 1, 1, 1)


def test_interval_gate_boundaries():
    x, labels, scale = _x(1), torch.arange(4), 3.0
    fn = cfg_denoise_fn(_shift, scale, interval=(0.5, 2.0))
    assert isinstance(fn, IntervalGate)
    for sig, guided in [(1.0, True), (2.0, True), (0.5, False), (3.0, False), (0.2, False)]:
        want = x + 1.0 - scale if guided else x
        torch.testing.assert_close(fn(x, torch.full((4,), sig), labels), want, rtol=1e-6, atol=1e-6)
        assert fn.branch(sig) is (fn.guided_fn if guided else _shift)
    main_fn = lambda x, s, l: x * 2.0  # noqa: E731
    guide_fn = lambda x, s, l: x * 0.5 + 1.0  # noqa: E731
    afn = autoguidance_denoise_fn(main_fn, guide_fn, scale, interval=(0.5, 2.0))
    d_main, d_guide = x * 2.0, x * 0.5 + 1.0
    torch.testing.assert_close(afn(x, torch.ones(4), labels), d_guide + scale * (d_main - d_guide))
    torch.testing.assert_close(afn(x, torch.full((4,), 5.0), labels), d_main)
    # fp32 bounds, as the JAX gate compares its fp32 sigma with them
    assert IntervalGate(_shift, _shift, (0.1, 2.9)).lo == float(np.float32(0.1))


@pytest.mark.parametrize("solver", ["heun", "dpmpp2m"])
def test_interval_gate_inside_solvers_matches_jax(solver):
    """The smoke model guided on (0.5, 5.0] through a solve: the port's
    sample against the JAX solve with the lax.cond gate, and the port's
    forwards by batch: 2B where sigma lies in the interval, B elsewhere."""
    jmodel, variables, port = small_models(10, torch.float32)
    scale, interval, steps = 2.0, (0.5, 5.0), 6
    jsolver, psolver = ((JaxHeun, DeterministicSolver) if solver == "heun"
                        else (JaxMultistep, MultistepSolver))
    x0 = np.random.default_rng(2).standard_normal(IMAGE).astype(np.float32)
    labels = np.asarray([1, 6], np.int32)
    jfn = jg.cfg_denoise_fn(_jax_fn(jmodel, variables), scale, interval=interval)
    ref = jax.jit(lambda x, lab: jsolver(num_steps=steps, sigma_min=0.01, sigma_max=20.0).solve(jfn, x, lab))(
        jnp.asarray(x0), jnp.asarray(labels))

    calls = []

    def counted(x, sigma, lab):
        calls.append((x.shape[0], float(sigma[0])))
        return port(x, sigma, lab)

    with torch.no_grad():
        out = psolver(num_steps=steps, sigma_min=0.01, sigma_max=20.0).solve(
            cfg_denoise_fn(counted, scale, interval=interval), nhwc_to_torch(x0),
            torch.from_numpy(labels).long())
    assert rel_l2(torch_to_nhwc(out), np.asarray(ref)) <= 1e-5
    assert len(calls) == (2 * steps - 1 if solver == "heun" else steps)
    for b, sig in calls:
        assert b == (4 if interval[0] < sig <= interval[1] else 2), (b, sig)
    assert {b for b, _ in calls} == {2, 4}


def test_drop_labels_statistics_and_passthrough():
    labels = torch.zeros(4096, dtype=torch.int64)
    dropped = drop_labels(labels, 0.25, torch.Generator().manual_seed(0))
    frac = float((dropped == NULL_LABEL).float().mean())
    assert 0.2 < frac < 0.3, frac
    assert torch.all(dropped[dropped != NULL_LABEL] == 0)
    assert torch.equal(drop_labels(torch.arange(10), 0.0, torch.Generator()), torch.arange(10))
    assert torch.all(drop_labels(torch.arange(10), 1.0) == NULL_LABEL)
    a, b = (drop_labels(labels, 0.5, torch.Generator().manual_seed(s)) for s in (3, 3))
    assert torch.equal(a, b)


# ---- the generate CLI's rules, against the JAX CLI's generate ----

class _Spec:
    def __init__(self, model):
        self.model = model

    def build_model(self, inference_fast=False):
        return self.model


@pytest.fixture
def jax_cli(monkeypatch):
    """run(conditional, **kwargs): the JAX CLI's generate on the smoke model
    (its checkpoint loader replaced), one sample of one step."""
    def run(conditional: bool, tmp_path, **kwargs):
        jmodel, variables, _ = small_models(10 if conditional else None, torch.float32)
        loader = lambda *a, **k: (_Spec(jmodel), jmodel, variables, None)  # noqa: E731
        monkeypatch.setattr(jax_generate_module, "load_edm_from_checkpoint", loader)
        jax_generate_module.generate(
            "ckpt", False, str(tmp_path / "jax"), 1, 16, 10 if conditional else None, 1,
            num_workers=1, num_steps=1, **kwargs)

    return run


@pytest.fixture
def smoke_weights(tmp_path):
    """save_weights files of the conditional and unconditional smoke models
    (fp32 topology under the "smoke" config name is not needed: the rules
    raise before any sample)."""
    paths = {}
    for name, classes in (("cond", 10), ("uncond", None)):
        _, _, port = small_models(classes, torch.float32)
        paths[name] = tmp_path / f"{name}.pt"
        save_weights(port, paths[name], "smoke" if classes else "smoke_uncond")
    return paths


# (conditional, JAX generate kwargs, the port's CLI flags, both messages) of
# the rules that raise
RAISING = {
    "churn_with_dpmpp2m": (True, dict(s_churn=1.0, solver_name="dpmpp2m"),
                           ["--S_churn", "1.0", "--solver", "dpmpp2m"], "does not compose"),
    "cfg_unconditional": (False, dict(guidance_scale=2.0), ["--guidance_scale", "2.0"],
                          "needs a conditional model"),
    "guide_without_scale": (True, dict(guide_ckpt_path="guide"), ["--guide_weights", "GUIDE"],
                            "needs --guidance_scale"),
    "interval_without_scale": (True, dict(guidance_sigma_min=0.3), ["--guidance_sigma_min", "0.3"],
                               "need --guidance_scale"),
}


@pytest.mark.parametrize("rule", sorted(RAISING))
def test_cli_rules_raise_where_jax_raises(rule, jax_cli, smoke_weights, tmp_path, monkeypatch):
    from tinyedm_tpu_torch import configs

    monkeypatch.setitem(configs.CONFIGS, "smoke_uncond", {
        "embedding": {**configs.CONFIGS["smoke"]["embedding"], "num_classes": None},
        "denoiser": configs.CONFIGS["smoke"]["denoiser"]})
    conditional, jax_kwargs, flags, message = RAISING[rule]
    with pytest.raises(ValueError, match=message):
        jax_cli(conditional, tmp_path, **jax_kwargs)
    weights = smoke_weights["cond" if conditional else "uncond"]
    flags = [str(smoke_weights["cond"]) if f == "GUIDE" else f for f in flags]
    with pytest.raises(ValueError, match=message):
        main(["--weights", str(weights), "--output_dir", str(tmp_path / "port"), "--num_samples", "1",
              "--batch_size", "1", "--image_size", "16", "--num_steps", "1", "--device", "cpu", *flags])
    assert not (tmp_path / "port").exists()


@pytest.fixture
def edm_forwards():
    """(batch, labels) of every EDM forward while the fixture is active."""
    seen = []

    def hook(module, args):
        if isinstance(module, EDM):
            seen.append((args[0].shape[0], None if args[2] is None else args[2].tolist()))

    handle = torch.nn.modules.module.register_module_forward_pre_hook(hook)
    yield seen
    handle.remove()


def test_scale_one_samples_unguided_and_scale_zero_is_one_null_forward(
        smoke_weights, tmp_path, capsys, edm_forwards):
    kwargs = dict(weights=str(smoke_weights["cond"]), device="cpu", num_steps=2, keep_samples=True, seed=4)
    plain = generate(str(tmp_path / "plain"), 2, 16, 2, **kwargs)
    n_plain = len(edm_forwards)
    one = generate(str(tmp_path / "one"), 2, 16, 2, guidance_scale=1.0, **kwargs)
    assert "sampling unguided" in capsys.readouterr().out
    assert np.array_equal(one["samples"], plain["samples"])
    assert len(edm_forwards) == 2 * n_plain == 6 and all(b == 2 for b, _ in edm_forwards)
    edm_forwards.clear()
    generate(str(tmp_path / "zero"), 2, 16, 2, guidance_scale=0.0, **kwargs)
    assert len(edm_forwards) == 3
    assert all(b == 2 and lab == [NULL_LABEL] * 2 for b, lab in edm_forwards)


def test_cli_churn_and_cfg_write_pngs(smoke_weights, tmp_path, edm_forwards):
    """The CLI on the CPU with churn, CFG on an interval and a seeded init:
    PNGs for every sample; the stacked forwards only inside the interval;
    the churn generator seeded from the seed and the batch index."""
    flags = ["--config", "smoke", "--output_dir", str(tmp_path / "a"), "--num_samples", "3",
             "--batch_size", "2", "--image_size", "16", "--num_steps", "3", "--device", "cpu",
             "--S_churn", "40", "--S_min", "0.05", "--S_max", "50", "--S_noise", "1.003",
             "--guidance_scale", "2.0", "--guidance_sigma_min", "0.28", "--guidance_sigma_max", "2.9"]
    main(flags)
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == ["0.png", "1.png", "2.png"]
    t_hat, _ = StochasticSolver(num_steps=3, S_churn=40, S_min=0.05, S_max=50).tables()
    t = StochasticSolver(num_steps=3).t_steps
    sigmas = [t_hat[0], t[1], t_hat[1], t[2], t_hat[2]]
    inside = sum(0.28 < float(np.float32(s)) <= 2.9 for s in sigmas)
    assert [b for b, _ in edm_forwards] == [4 if 0.28 < float(np.float32(s)) <= 2.9 else 2
                                            for s in sigmas] * 2
    assert 0 < inside < len(sigmas)
    # the same seed twice: the same PNGs; churn draws differ per batch index
    main([*flags[:3], str(tmp_path / "b"), *flags[4:]])
    for i in range(3):
        assert (tmp_path / "a" / f"{i}.png").read_bytes() == (tmp_path / "b" / f"{i}.png").read_bytes()


def test_churn_draws_come_from_the_seed_and_batch_index(monkeypatch, tmp_path):
    from tinyedm_tpu_torch import generate as gen_module

    seeds = []
    real = gen_module.folded_generator

    def spy(seed, index, device):
        seeds.append((seed, index))
        return real(seed, index, device)

    monkeypatch.setattr(gen_module, "folded_generator", spy)
    generate(str(tmp_path), 3, 16, 2, config="smoke", device="cpu", num_steps=1, seed=9, s_churn=5.0)
    assert seeds == [(9 ^ 0xC4A2, 0), (9 ^ 0xC4A2, 1)]
