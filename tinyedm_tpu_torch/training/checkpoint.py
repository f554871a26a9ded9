"""Self-describing checkpoints on ``torch.save``.

Counterpart of ``tinyedm_tpu/training/checkpoint.py`` (which uses orbax):

- Layout: ``<dir>/<step>/state.pt`` holds the step, params, constants, Adam
  ``mu``/``nu``/``count`` and the EMA trees, as CPU tensors by name; beside
  it ``config.json`` (the deinstantiated spec, when given) and
  ``metrics.json`` (the metrics the save ranks by, or null). A save is
  written under a temporary name and renamed into place, so a crash never
  leaves a half checkpoint that ``latest_step`` would pick up. Loading uses
  ``torch.load(..., weights_only=True)``.
- Retention is the JAX manager's, as orbax applies it: top ``max_to_keep``
  by ``monitor``/``mode`` (a save without the monitored key is demoted to the
  metric-less class), metric-less saves kept with ``save_last`` but bounded
  to the newest ``keep_last`` of this manager's saves, and a manager without
  a monitor keeps the newest ``max_to_keep`` (all when None). A save at a
  step at or below the latest is skipped, as orbax skips it. Saves are
  synchronous: ``wait`` and ``close`` exist for the JAX manager's callers.
- Over several ranks every rank keeps a manager on the same directory, but
  only the ``primary`` one (rank 0) writes and deletes; the others keep the
  same books, so ``latest_step`` agrees on every rank. Every rank restores.
  A file always holds whole tensors: under ZeRO-1 and tensor parallelism the
  trainer gathers the ranges and shards before a save, one tensor at a time
  over the model group (``parallel/tensor.py::gather_tree``), and cuts the
  whole tensors to the rank's after a restore, so a run saved on one grid
  resumes on another and the ``.ckpt`` export and ``posthoc_ema`` read it as
  they read one process's.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Optional

import torch

from tinyedm_tpu_torch.training.state import TrainState
from tinyedm_tpu_torch.utils.cuda import resolve_device

_STATE = "state.pt"
_TMP_PREFIX = ".tmp-"


def _cpu_tree(tree: dict) -> dict:
    # a copy also on the CPU: a view of a larger buffer (the ZeRO-1 params)
    # is saved as a tensor of its own
    return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}


def _to_saveable(state: TrainState) -> dict:
    return {
        "step": int(state.step),
        "params": _cpu_tree(state.params),
        "constants": _cpu_tree(state.constants),
        "mu": _cpu_tree(state.mu),
        "nu": _cpu_tree(state.nu),
        "count": int(state.count),
        "ema": [_cpu_tree(e) for e in state.ema],
    }


def _from_saveable(blob: dict) -> TrainState:
    return TrainState(step=int(blob["step"]), params=blob["params"], constants=blob["constants"],
                      mu=blob["mu"], nu=blob["nu"], count=int(blob["count"]), ema=tuple(blob["ema"]))


class CheckpointManager:
    """Save/restore TrainState + config with top-k retention."""

    def __init__(
        self,
        directory: str | Path,
        max_to_keep: Optional[int] = 3,
        monitor: Optional[str] = "val_loss",
        mode: str = "min",
        save_last: bool = True,
        keep_last: int = 2,
        primary: bool = True,
    ):
        self.directory = Path(directory).absolute()  # made by the first save
        self.primary = primary
        self.monitor = monitor
        self.mode = mode
        self._max_to_keep = max_to_keep
        self._save_last = save_last
        self._keep_last = max(int(keep_last), 1)
        # a save without the monitored key ranks worst (defence in depth:
        # save() demotes such saves to the metric-less class)
        self._worst = float("inf") if mode == "min" else float("-inf")
        # the newest metric-less steps of THIS manager's saves (as the JAX
        # manager tracks them: steps from before a restart are not pruned)
        self._metricless: list[int] = []
        for tmp in self.directory.glob(_TMP_PREFIX + "*") if primary else ():
            shutil.rmtree(tmp)  # a save cut off before its rename
        # step -> the metrics it ranks by (None: metric-less), in step order
        self._steps: dict[int, Optional[dict]] = {}
        steps = (p for p in self.directory.glob("*") if p.name.isdigit() and (p / _STATE).is_file())
        for path in sorted(steps, key=lambda p: int(p.name)):
            metrics_file = path / "metrics.json"
            metrics = json.loads(metrics_file.read_text()) if metrics_file.exists() else None
            self._steps[int(path.name)] = metrics

    def _rank(self, metrics: dict) -> float:
        return metrics.get(self.monitor, self._worst)

    def _ranked(self) -> list[int]:
        """Steps with metrics, worst first (orbax's order, stable in steps)."""
        with_metrics = [s for s, m in self._steps.items() if m is not None]
        return sorted(with_metrics, key=lambda s: self._rank(self._steps[s]), reverse=self.mode == "min")

    def _write(self, step: int, state: TrainState, config: Optional[dict], metrics: Optional[dict]) -> None:
        tmp = self.directory / f"{_TMP_PREFIX}{step}"
        final = self.directory / str(step)
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        torch.save(_to_saveable(state), tmp / _STATE)
        if config is not None:
            (tmp / "config.json").write_text(json.dumps(config))
        (tmp / "metrics.json").write_text(json.dumps(metrics))
        if final.exists():  # a directory without a state.pt: not a checkpoint
            shutil.rmtree(final)
        tmp.rename(final)

    def _retained(self) -> set[int]:
        steps = list(self._steps)
        n = self._max_to_keep
        if n is None or len(steps) <= n:
            return set(steps)
        if not self.monitor:
            return set(steps[len(steps) - n:] if n else [])
        kept = set(self._ranked()[-n:] if n else [])
        if self._save_last:
            kept |= {s for s, m in self._steps.items() if m is None}
        return kept

    def save(self, step: int, state: TrainState, config: Optional[dict] = None,
             metrics: Optional[dict] = None) -> None:
        m = {k: float(v) for k, v in (metrics or {}).items()} or None
        if m is not None and self.monitor and self.monitor not in m:
            m = None  # demoted to the metric-less class
        if self.latest_step is None or step > self.latest_step:
            if self.primary:
                self._write(step, state, config, m if self.monitor else None)
            self._steps[step] = m if self.monitor else None
            for old in set(self._steps) - self._retained():
                self.delete(old)
        if m is None and self._save_last and self.monitor and self._max_to_keep is not None:
            self._metricless = [s for s in self._metricless if s != step] + [step]
            while len(self._metricless) > self._keep_last:
                self.delete(self._metricless.pop(0))

    def delete(self, step: int) -> None:
        """Remove a step's checkpoint (nothing if it is gone)."""
        if step in self._steps:
            del self._steps[step]
            if self.primary:
                shutil.rmtree(self.directory / str(step))

    def wait(self) -> None: ...

    def close(self) -> None: ...

    @property
    def all_steps(self) -> list[int]:
        return list(self._steps)

    @property
    def latest_step(self) -> Optional[int]:
        return max(self._steps) if self._steps else None

    @property
    def best_step(self) -> Optional[int]:
        if not self.monitor:
            return self.latest_step
        ranked = self._ranked()
        return ranked[-1] if ranked else None

    def restore(self, step: Optional[int] = None,
                device: str | torch.device = "cpu") -> tuple[TrainState, Optional[dict]]:
        """(state with tensors on ``device``, config or None) of ``step``,
        the latest by default."""
        if step is None:
            step = self.latest_step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        path = self.directory / str(step)
        blob = torch.load(path / _STATE, map_location=torch.device(device), weights_only=True)
        config_file = path / "config.json"
        config = json.loads(config_file.read_text()) if config_file.exists() else None
        return _from_saveable(blob), config


def save_checkpoint(directory: str | Path, state: TrainState, config: Optional[dict] = None) -> None:
    """One-shot save (no retention)."""
    CheckpointManager(directory, max_to_keep=None, monitor=None).save(int(state.step), state, config)


def load_checkpoint(directory: str | Path, step: Optional[int] = None,
                    device: str | torch.device = "cpu") -> tuple[TrainState, Optional[dict]]:
    return CheckpointManager(directory, max_to_keep=None, monitor=None).restore(step, device)


def load_edm_from_checkpoint(
    directory: str | Path,
    step: Optional[int] = None,
    load_ema: bool = False,
    ema_index: int = 0,
    device: Optional[str | torch.device] = None,
    fused: Optional[str] = None,
):
    """Rebuild the spec and model from the checkpoint's embedded config and
    load the requested weights: the train params, or with ``load_ema`` the
    EMA tree ``ema_index``. Returns ``(spec, model, weights, state)``: the
    model in eval mode on ``device`` (the card unless ``"cpu"``) holding
    ``weights`` (its state_dict), and the whole restored ``state``, which
    stays on the CPU (only the model's weights go to the device); the
    model's attention runs in the form ``fused`` (``"off"``: unfused; None:
    the config's own)."""
    from tinyedm_tpu_torch.config.registry import instantiate

    dev = resolve_device(device)
    state, config = load_checkpoint(directory, step)
    if config is None:
        raise ValueError(f"checkpoint at {directory} has no embedded config; pass the spec manually")
    spec = instantiate(config["model"] if "model" in config else config)
    if load_ema:
        if not state.ema:
            raise ValueError("EMA weights not found in the checkpoint.")
        params = state.ema[ema_index]
    else:
        params = state.params
    weights = {**params, **state.constants}
    with torch.device(dev):
        model = spec.build_model(fused=fused)
    model.load_state_dict(weights)
    return spec, model.eval(), weights, state
