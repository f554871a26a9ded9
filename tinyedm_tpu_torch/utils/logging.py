"""Metric and image logging: JSONL and PNG files on disk, wandb when asked.

Counterpart of ``tinyedm_tpu/utils/logging.py``: ``metrics.jsonl`` rows carry
``step``, ``time`` (seconds since the logger started) and the metrics, the
same keys as the JAX package writes; images go to
``images/<key>_<step:07d>.png``, encoded by ``training.callbacks.encode_png``
(the machine with the card has no Pillow). wandb is used only when it is
importable and enabled; otherwise the logger says so once and keeps to
local files. Over several ranks only rank 0's logger writes or prints
(``enabled``); the others are silent. Each row is appended with the file
opened for it (rows come at the logging cadence), so the logger holds no
file open.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Mapping, Optional

import numpy as np

from tinyedm_tpu_torch.parallel.mesh import world
from tinyedm_tpu_torch.training.callbacks import encode_png


class MetricLogger:
    def __init__(self, out_dir: str | Path, use_wandb: bool = False, wandb_kwargs: Optional[dict] = None):
        self.out_dir = Path(out_dir)
        self._t0 = time.time()
        self._wandb = None
        wandb_kwargs = dict(wandb_kwargs or {})
        # upload saved checkpoints as artifacts (not a wandb.init argument);
        # armed only once wandb.init succeeds
        log_model = bool(wandb_kwargs.pop("log_model", False))
        self._log_model = False
        # rank 0 only, as Lightning's rank_zero_only
        self.enabled = world()[0] == 0
        if not self.enabled:
            return
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self._metrics_path = self.out_dir / "metrics.jsonl"
        if use_wandb:
            try:
                import wandb

                wandb.init(dir=str(self.out_dir), **wandb_kwargs)
                self._wandb = wandb
                self._log_model = log_model
            except Exception as e:  # no wandb or no network: local files only
                print(f"[logger] wandb unavailable ({e}); logging to {self.out_dir}")
                self._wandb = None

    def log_metrics(self, metrics: Mapping[str, Any], step: int) -> None:
        if not self.enabled:
            return
        row = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        row.update({k: float(v) for k, v in metrics.items()})
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(row) + "\n")
        if self._wandb is not None:
            self._wandb.log(dict(metrics), step=int(step))

    def log_image(self, key: str, image, step: int) -> None:
        if not self.enabled:
            return
        arr = np.asarray(image)
        img_dir = self.out_dir / "images"
        img_dir.mkdir(exist_ok=True)
        (img_dir / f"{key}_{step:07d}.png").write_bytes(encode_png(arr.squeeze()))
        if self._wandb is not None:
            self._wandb.log({key: self._wandb.Image(arr)}, step=int(step))

    def log_checkpoint(self, path: str | Path, step: int) -> None:
        """Upload a saved checkpoint directory as a wandb artifact; a no-op
        without wandb or without ``log_model``."""
        if self._wandb is None or not self._log_model:
            return
        try:
            art = self._wandb.Artifact(f"model-{self._wandb.run.id}", type="model")
            art.add_dir(str(path))
            self._wandb.log_artifact(art, aliases=[f"step-{int(step)}"])
        except Exception as e:  # the upload is best-effort
            print(f"[logger] checkpoint artifact upload failed ({e})")

    def log_text(self, key: str, text: str) -> None:
        if not self.enabled:
            return
        print(f"[{key}] {text}", flush=True)

    def close(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
