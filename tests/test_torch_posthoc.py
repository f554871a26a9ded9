"""Post-hoc EMA reconstruction: the port against the JAX package.

- ``solve_posthoc_weights`` in fp64 equals the JAX solve within 1e-12
  (relative to the largest weight) on seeded snapshot steps and gammas,
  also with snapshots close in step and gamma (a nearly singular Gram
  matrix).
- ``reconstruct_posthoc_ema`` on seeded synthetic trees equals the JAX
  combination within fp32 relative L2 1e-6; a target that is one of the
  snapshots' profiles at the latest step gets a unit weight and reproduces
  that tree.
- ``python -m tinyedm_tpu_torch.posthoc_ema`` on port checkpoints (two
  steps of two profiles, and the latest alone, also by an empty
  ``--steps``): the written tree against the JAX combination of the same
  trees, the single-profile output config, and the raises for a checkpoint
  without EMA and for one whose tree count differs from its config's.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyedm_tpu.training import ema as jax_ema
from tinyedm_tpu_torch import posthoc_ema
from tinyedm_tpu_torch.config.registry import deinstantiate, instantiate, load_config
from tinyedm_tpu_torch.training import ema
from tinyedm_tpu_torch.training.checkpoint import CheckpointManager, load_checkpoint
from tinyedm_tpu_torch.training.state import TrainState
from tinyedm_tpu_torch.train import CONFIG_PATH

SIGMA_RELS = (0.05, 0.13)


@pytest.mark.parametrize("case", ["spread", "close"])
def test_solve_equals_jax_in_fp64(case):
    rng = np.random.default_rng(0)
    if case == "spread":
        steps = np.sort(rng.integers(100, 20000, 6))
        gammas = rng.uniform(3.0, 40.0, 6)
    else:  # snapshots close in step and gamma: A nearly singular
        steps = np.asarray([9999, 10000, 10000, 10001])
        gammas = np.asarray([16.97, 6.94, 6.95, 16.98])
    target = (int(steps.max()) + 1, ema.sigma_rel_to_gamma(0.1))
    ours = ema.solve_posthoc_weights(steps + 1, gammas, *target)
    theirs = jax_ema.solve_posthoc_weights(steps + 1, gammas, *target)
    assert ours.dtype == np.float64 and ours.shape == (len(steps),)
    assert np.max(np.abs(ours - theirs)) <= 1e-12 * np.max(np.abs(theirs))


def _trees(n: int, seed: int = 0) -> list[dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    shapes = {"conv.weight": (8, 4, 3, 3), "linear.weight": (16, 8), "gain": ()}
    return [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()} for _ in range(n)]


def _rel_l2(ours: dict, theirs: dict) -> float:
    a = np.concatenate([np.asarray(ours[k], np.float64).ravel() for k in sorted(theirs)])
    b = np.concatenate([np.asarray(theirs[k], np.float64).ravel() for k in sorted(theirs)])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_reconstruct_equals_jax_in_fp32():
    trees = _trees(4)
    steps = [999, 999, 1999, 1999]
    gammas = [ema.sigma_rel_to_gamma(s) for s in SIGMA_RELS] * 2
    ours = ema.reconstruct_posthoc_ema([{k: torch.from_numpy(v) for k, v in t.items()} for t in trees],
                                       steps, gammas, 0.1)
    theirs = jax_ema.reconstruct_posthoc_ema([{k: jnp.asarray(v) for k, v in t.items()} for t in trees],
                                             steps, gammas, 0.1)
    assert all(v.dtype == torch.float32 and v.shape == trees[0][k].shape for k, v in ours.items())
    assert _rel_l2({k: v.numpy() for k, v in ours.items()}, theirs) <= 1e-6
    # a tracked profile at the latest step is exactly representable: unit weight
    w = ema.solve_posthoc_weights([s + 1 for s in steps], gammas, 2000, gammas[3])
    np.testing.assert_allclose(w, [0, 0, 0, 1], atol=1e-9)
    same = ema.reconstruct_posthoc_ema([{k: torch.from_numpy(v) for k, v in t.items()} for t in trees],
                                       steps, gammas, 0.13)
    assert _rel_l2({k: v.numpy() for k, v in same.items()}, trees[3]) <= 1e-6


def _smoke_spec(ema_lengths=SIGMA_RELS):
    cfg = load_config(CONFIG_PATH / "smoke.yaml")["model"]
    cfg["ema_lengths"] = list(ema_lengths) if ema_lengths else None
    return instantiate(cfg)


def _save(directory, step: int, n_trees: int, spec, seed: int = 0) -> TrainState:
    """A checkpoint of the smoke model at ``step`` whose params and
    ``n_trees`` EMA trees are seeded draws."""
    model = spec.build_model()
    torch.manual_seed(seed)
    params = {k: torch.randn_like(p) for k, p in model.named_parameters()}
    ema_trees = tuple({k: torch.randn_like(p) for k, p in params.items()} for _ in range(n_trees))
    state = TrainState(step=step, params=params, constants=dict(model.named_buffers()),
                       mu={k: torch.zeros_like(p) for k, p in params.items()},
                       nu={k: torch.zeros_like(p) for k, p in params.items()}, count=step, ema=ema_trees)
    CheckpointManager(directory, max_to_keep=None, monitor=None).save(step, state, config={"model": deinstantiate(spec)})
    return state


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("posthoc") / "checkpoints"
    spec = _smoke_spec()
    return d, [_save(d, step, 2, spec, seed=step) for step in (10, 20)]


def test_cli_combines_two_steps_as_jax(run, tmp_path, capsys):
    d, states = run
    out = tmp_path / "posthoc"
    written = posthoc_ema.main(["--ckpt_path", str(d), "--target_sigma_rel", "0.1", "--out_dir", str(out),
                                "--steps", "10", "20", "--device", "cpu"])
    assert "combining 4 EMA snapshots" in capsys.readouterr().out
    gammas = [ema.sigma_rel_to_gamma(s) for s in SIGMA_RELS] * 2
    trees = [{k: jnp.asarray(v.numpy()) for k, v in t.items()} for s in states for t in s.ema]
    theirs = jax_ema.reconstruct_posthoc_ema(trees, [10, 10, 20, 20], gammas, 0.1)
    state, config = load_checkpoint(out)
    assert state.step == 20 and len(state.ema) == 1
    assert _rel_l2({k: v.numpy() for k, v in state.ema[0].items()}, theirs) <= 1e-6
    assert all(torch.equal(state.params[k], v) for k, v in state.ema[0].items())
    assert all(torch.equal(state.ema[0][k], written.ema[0][k]) for k in state.ema[0])
    model = config["model"]
    assert (model["use_ema"], model["ema_length"], model["ema_lengths"], model["val_ema_index"]) == (True, 0.1, None, 0)
    assert instantiate(model).build_ema_config().sigma_rels == (0.1,)


@pytest.mark.parametrize("steps", [None, []])
def test_cli_defaults_to_the_latest_step(run, tmp_path, steps):
    d, states = run
    argv = ["--ckpt_path", str(d), "--target_sigma_rel", "0.13", "--out_dir", str(tmp_path / "out"),
            "--device", "cpu"] + ([] if steps is None else ["--steps"])
    posthoc_ema.main(argv)
    state, _ = load_checkpoint(tmp_path / "out")
    assert state.step == 20
    # 0.13 at the latest step is that step's own 0.13 tree
    assert _rel_l2({k: v.numpy() for k, v in state.ema[0].items()},
                   {k: v.numpy() for k, v in states[1].ema[1].items()}) <= 1e-6


def test_cli_refuses_missing_or_unpairable_trees(tmp_path):
    one_tree = tmp_path / "one"
    _save(one_tree, 5, 1, _smoke_spec())  # one tree, two declared profiles
    with pytest.raises(ValueError, match="stores 1 EMA tree.*declares 2 profile"):
        posthoc_ema.reconstruct(str(one_tree), 0.1, str(tmp_path / "x"), device="cpu")
    no_ema = tmp_path / "none"
    _save(no_ema, 5, 0, _smoke_spec(ema_lengths=None))
    with pytest.raises(ValueError, match="no EMA profiles"):
        posthoc_ema.reconstruct(str(no_ema), 0.1, str(tmp_path / "y"), device="cpu")
