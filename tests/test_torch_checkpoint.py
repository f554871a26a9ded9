"""The port's checkpoint manager against the JAX (orbax) one.

- Retention: the save sequences of ``tests/test_utils.py::
  TestCheckpointMonitor`` (a monitor key missing from a save, mode max, a
  demoted newest save, the bounded metric-less class, a monitor-less
  manager), each under mode min and max, plus seeded random sequences and a
  manager re-opened on a directory: the JAX and port managers are fed the
  same (step, metrics) saves, and the steps left on disk, ``latest_step``
  and ``best_step`` must be equal (exact).
- A ``train_state_from_jax`` state saved and restored is equal bit for bit
  (every tensor, dtype, step and Adam count).
- A save is renamed into place: a half-written save is never a checkpoint.
- ``load_edm_from_checkpoint`` rebuilds the spec's model with the train or
  EMA weights, and raises as the JAX loader does without a config or EMA.
"""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import smoke_jax_state
from tinyedm_tpu.training.checkpoint import CheckpointManager as JaxManager
from tinyedm_tpu.training.state import TrainState as JaxTrainState
from tinyedm_tpu_torch.config.registry import deinstantiate, instantiate, load_config
from tinyedm_tpu_torch.training.checkpoint import (
    CheckpointManager,
    load_checkpoint,
    load_edm_from_checkpoint,
    save_checkpoint,
)
from tinyedm_tpu_torch.training.state import TrainState
from tinyedm_tpu_torch.utils.interop import train_state_from_jax

CONF = Path(__file__).resolve().parent.parent / "experiments" / "conf"


def _jax_state(step):
    return JaxTrainState(
        step=jnp.asarray(step, jnp.int32), params={"w": np.ones(2, np.float32)},
        constants={"c": np.zeros(1, np.float32)}, opt_state={"m": np.zeros(2, np.float32)},
        ema=({"w": np.ones(2, np.float32)},),
    )


def _port_state(step):
    ones = {"w": torch.ones(2)}
    return TrainState(step=step, params=ones, constants={"c": torch.zeros(1)}, mu={"w": torch.zeros(2)},
                      nu={"w": torch.zeros(2)}, count=step, ema=({"w": torch.ones(2)},))


def _kept(directory: Path) -> set[int]:
    return {int(p.name) for p in directory.iterdir() if p.name.isdigit()}


def _run(tmp_path, kwargs, saves, reopen_after=None):
    """(steps on disk, latest, best) of both managers after ``saves``."""
    out = []
    for name, cls, state, extra in (("jax", JaxManager, _jax_state, {"async_save": False}),
                                    ("port", CheckpointManager, _port_state, {})):
        directory = tmp_path / name
        mngr = cls(directory, **kwargs, **extra)
        for i, (step, metrics) in enumerate(saves):
            if reopen_after is not None and i == reopen_after:
                mngr.close()
                mngr = cls(directory, **kwargs, **extra)
            mngr.save(step, state(step), metrics=metrics)
        mngr.wait()
        out.append((_kept(directory), mngr.latest_step, mngr.best_step))
        mngr.close()
    return out


CASES = {
    # tests/test_utils.py::TestCheckpointMonitor, by test name
    "missing_monitor_key_ranks_worst": (
        dict(max_to_keep=1, monitor="fid", save_last=False),
        [(1, {"fid": 5.0}), (2, {"val_loss": 0.01})]),
    "mode_max_monitor": (
        dict(max_to_keep=2, monitor="score", save_last=False),
        [(1, {"score": 1.0}), (2, {"score": 3.0}), (3, {})]),
    "missing_monitor_key_demoted_not_pruned_first": (
        dict(max_to_keep=2, monitor="fid", save_last=True),
        [(1, {"fid": 1.0}), (2, {"fid": 2.0}), (3, {"fid": 3.0}), (4, {"val_loss": 0.1})]),
    "metricless_class_is_bounded_not_immortal": (
        dict(max_to_keep=2, monitor="val_loss", save_last=True, keep_last=2),
        [(1, {"val_loss": 1.0}), (2, {"val_loss": 0.5})] + [(s, None) for s in (3, 4, 5, 6)]),
    "monitorless_manager_keeps_all": (
        dict(max_to_keep=None, monitor=None, save_last=True),
        [(s, None) for s in range(1, 6)]),
}


@pytest.mark.parametrize("mode", ["min", "max"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_retention_matches_jax(case, mode, tmp_path):
    kwargs, saves = CASES[case]
    jax_out, port_out = _run(tmp_path, {**kwargs, "mode": mode}, saves)
    assert port_out == jax_out


@pytest.mark.parametrize("seed", range(4))
def test_random_save_sequences_match_jax(seed, tmp_path):
    rng = np.random.default_rng(seed)
    kwargs = dict(max_to_keep=int(rng.integers(1, 4)), monitor="val_loss",
                  mode=["min", "max"][seed % 2], save_last=bool(seed < 2), keep_last=int(rng.integers(1, 3)))
    saves, step = [], 0
    for _ in range(9):
        step += int(rng.integers(1, 4))
        kind = rng.integers(0, 4)
        metrics = ({"val_loss": float(rng.integers(0, 5))} if kind < 2
                   else {"fid": 1.0} if kind == 2 else None)  # ties, foreign keys, metric-less
        saves.append((step, metrics))
    saves.append((step, {"val_loss": 0.0}))  # a save at the latest step is skipped
    jax_out, port_out = _run(tmp_path, kwargs, saves, reopen_after=5)
    assert port_out == jax_out


def test_train_state_round_trip_is_bitwise(tmp_path):
    jax_state = smoke_jax_state()
    state = train_state_from_jax(jax_state)
    save_checkpoint(tmp_path / "ckpt", state, config={"seed": 1})
    restored, config = load_checkpoint(tmp_path / "ckpt")
    assert config == {"seed": 1}
    assert (restored.step, restored.count) == (7, 3)
    for name in ("params", "constants", "mu", "nu"):
        a, b = getattr(state, name), getattr(restored, name)
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
    assert len(restored.ema) == 1 and all(torch.equal(state.ema[0][k], restored.ema[0][k]) for k in state.ema[0])


def test_half_written_save_is_not_a_checkpoint(tmp_path):
    mngr = CheckpointManager(tmp_path, max_to_keep=None, monitor=None)
    mngr.save(3, _port_state(3))
    (tmp_path / ".tmp-5").mkdir()  # a save cut off before its rename
    (tmp_path / ".tmp-5" / "state.pt").write_bytes(b"partial")
    (tmp_path / "9").mkdir()  # a directory without a state
    reopened = CheckpointManager(tmp_path, max_to_keep=None, monitor=None)
    assert reopened.latest_step == 3 and not (tmp_path / ".tmp-5").exists()
    reopened.save(9, _port_state(9))
    assert reopened.latest_step == 9 and reopened.restore()[0].step == 9


def _smoke_config() -> dict:
    model = load_config(CONF / "smoke.yaml")["model"]
    model["denoiser"]["dtype"] = "float32"
    return {"model": deinstantiate(instantiate(model)), "seed": 0}


def test_load_edm_from_checkpoint_selects_weights_and_raises_as_jax(tmp_path):
    jax_state = smoke_jax_state()
    state = train_state_from_jax(jax_state)
    save_checkpoint(tmp_path / "full", state, config=_smoke_config())
    for load_ema, tree in ((False, state.params), (True, state.ema[0])):
        spec, model, weights, restored = load_edm_from_checkpoint(tmp_path / "full", load_ema=load_ema,
                                                                  device="cpu")
        assert spec.conditional and restored.step == 7 and not model.training
        sd = model.state_dict()
        assert all(torch.equal(sd[k], tree[k]) for k in tree)
        assert all(torch.equal(sd[k], state.constants[k]) for k in state.constants)
    save_checkpoint(tmp_path / "bare", state)
    with pytest.raises(ValueError, match="no embedded config"):
        load_edm_from_checkpoint(tmp_path / "bare", device="cpu")
    save_checkpoint(tmp_path / "no_ema", TrainState(**{**state.__dict__, "ema": ()}), config=_smoke_config())
    with pytest.raises(ValueError, match="EMA weights not found"):
        load_edm_from_checkpoint(tmp_path / "no_ema", load_ema=True, device="cpu")
    with pytest.raises(FileNotFoundError):
        load_checkpoint(tmp_path / "empty")
