"""The training driver: epochs, validation, checkpoints, previews, resume.

Counterpart of ``tinyedm_tpu/training/trainer.py`` on one device (the card
unless ``device="cpu"``):

- The loop never waits for the card except at the logging cadence: the
  step's metrics stay device tensors until ``log_every_n_steps`` flushes
  them, and the epoch's ``samples_per_sec`` is taken after reading the last
  loss, which waits for the epoch's steps.
- Step ``t`` draws from ``folded_generator(seed, t)``, so a resumed run draws
  what an uninterrupted one draws; a mid-epoch checkpoint resumes by
  skipping the consumed batches of its epoch (the datamodule still advances
  its rng stream past them), and the run ends bit for bit where an
  uninterrupted one ends.
- Validation sums (sse, count) over every sample, exactly; batch ``i``'s
  draws come from the seed ``fold_seed(seed + 777, i)``, and each tracked
  EMA profile gets its own ``val_loss/ema_<sigma_rel>`` series when there
  are several. EMA weights are evaluated through ``functional_call``.
- SIGTERM/SIGINT set a flag: the current step finishes, the loop checkpoints
  and returns, and ``fit(resume=True)`` continues.
- ``device_preprocess`` ships uint8 images and flip flags to the device and
  normalizes and flips there (uint8 datamodules only).

Multi-GPU (``zero1``, ``model_parallel``) is not ported (ROADMAP.md section
1, item 8) and raises.
"""

from __future__ import annotations

import signal
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from tinyedm_tpu_torch.data.datamodules import to_device
from tinyedm_tpu_torch.diffusion.guidance import cfg_denoise_fn
from tinyedm_tpu_torch.models.edm import init_weights
from tinyedm_tpu_torch.training.callbacks import Callback
from tinyedm_tpu_torch.training.checkpoint import CheckpointManager
from tinyedm_tpu_torch.training.experiment import EDMSpec
from tinyedm_tpu_torch.training.state import TrainState
from tinyedm_tpu_torch.training.train_step import init_train_state, make_eval_step, make_train_step
from tinyedm_tpu_torch.utils.cuda import fold_seed, folded_generator, resolve_device
from tinyedm_tpu_torch.utils.logging import MetricLogger

VAL_SEED_OFFSET = 777  # validation draws from seed + 777, as in the JAX trainer


class Trainer:
    def __init__(
        self,
        spec: EDMSpec,
        datamodule,
        max_epochs: int = 1,
        check_val_every_n_epoch: int = 10,
        callbacks: Sequence[Callback] = (),
        logger: Optional[MetricLogger] = None,
        out_dir: str | Path = "runs/default",
        ckpt_every_n_epochs: int = 100,
        ckpt_top_k: int = 3,
        ckpt_save_last: bool = True,
        ckpt_monitor: str = "val_loss",
        ckpt_mode: str = "min",
        log_every_n_steps: int = 50,
        seed: int = 42,
        config: Optional[dict] = None,
        zero1: bool = False,
        model_parallel: int = 1,
        device_preprocess: bool = False,
        device: Optional[str | torch.device] = None,
    ):
        if zero1 or model_parallel > 1:
            raise NotImplementedError(
                "zero1 and model_parallel > 1 need several GPUs, which the port does not drive yet "
                "(ROADMAP.md section 1, item 8)"
            )
        self.device = resolve_device(device)
        self.spec = spec
        # seeded weights, drawn on the CPU so that every device starts from
        # the same ones; a resume replaces them
        model = spec.build_model()
        init_weights(model, torch.Generator().manual_seed(seed))
        self.model = model.to(self.device)
        self.diffuser = spec.diffuser
        self.opt_cfg = spec.build_optimizer_config()
        self.ema_cfg = spec.build_ema_config()
        self.use_ema = self.ema_cfg is not None
        self.datamodule = datamodule
        self.max_epochs = max_epochs
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.callbacks = list(callbacks)
        self.out_dir = Path(out_dir)
        self.logger = logger or MetricLogger(self.out_dir)
        self.log_every_n_steps = log_every_n_steps
        self.seed = seed
        self.config = config  # the self-describing checkpoint payload
        self.device_preprocess = bool(device_preprocess) and bool(getattr(datamodule, "raw_uint8", False))
        if device_preprocess and not self.device_preprocess:
            print(
                "[trainer] device_preprocess requested but the datamodule "
                f"({type(datamodule).__name__}) exposes no raw_uint8 path; "
                "falling back to host preprocessing",
                flush=True,
            )
        self.ckpt = CheckpointManager(
            self.out_dir / "checkpoints",
            max_to_keep=ckpt_top_k,
            monitor=ckpt_monitor,
            mode=ckpt_mode,
            save_last=ckpt_save_last,
        )
        # per-epoch checkpoint-selection metrics that callbacks deposit;
        # merged into the next save, cleared at each epoch's start
        self.extra_ckpt_metrics: dict = {}
        self.ckpt_every_n_epochs = ckpt_every_n_epochs
        self._train_step = make_train_step(self.model, self.diffuser, self.opt_cfg, self.ema_cfg)
        self._ema_sigma_rels = tuple(self.ema_cfg.sigma_rels) if self.use_ema else ()
        self._eval_step = make_eval_step(
            self.model,
            self.diffuser,
            use_ema=self.use_ema and not spec.validate_original_weights,
            ema_index=spec.val_ema_index,
            n_profiles=len(self._ema_sigma_rels) if len(self._ema_sigma_rels) > 1 else 0,
        )
        self.state: Optional[TrainState] = None
        self.epoch = 0
        self.global_step = 0
        self._skip_batches = 0  # batches of the resumed epoch consumed before its checkpoint
        self._interrupted = False
        self._last_val: Optional[tuple[int, float]] = None

    def _install_signal_handlers(self) -> dict:
        """Flag-only SIGTERM/SIGINT handlers; returns the ones replaced."""

        def handler(signum, frame):
            self._interrupted = True

        replaced = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                replaced[sig] = signal.signal(sig, handler)
            except ValueError:  # not the main thread
                break
        return replaced

    # ------------------------------------------------------------------ setup
    def _init_state(self) -> TrainState:
        return init_train_state(self.model, self.opt_cfg, self.ema_cfg)

    def restore(self, step: Optional[int] = None) -> None:
        """The checkpoint of ``step`` (the latest by default) into the model
        and a state over its parameters."""
        saved, _ = self.ckpt.restore(step, device=self.device)
        self.model.load_state_dict({**saved.params, **saved.constants})
        self.state = TrainState(
            step=saved.step,
            params=dict(self.model.named_parameters()),
            constants=dict(self.model.named_buffers()),
            mu=saved.mu,
            nu=saved.nu,
            count=saved.count,
            ema=saved.ema,
        )
        self.global_step = saved.step

    def _to_device(self, batch_np) -> tuple[torch.Tensor, torch.Tensor]:
        """A host batch as (NCHW fp32 images, labels) on the device; the raw
        form (uint8, flip flags, labels) is normalized and flipped there."""
        if not self.device_preprocess:
            return to_device(batch_np[0], batch_np[1], self.device)
        u8, flags, labels = batch_np
        x = torch.from_numpy(u8).to(self.device).float()
        x = (x / 255.0 - 0.5) / 0.5
        if flags is not None:
            flip = torch.from_numpy(np.asarray(flags)).to(self.device).reshape(-1, 1, 1, 1)
            x = torch.where(flip, x.flip(2), x)  # NHWC: axis 2 is the width
        y = torch.from_numpy(np.asarray(labels, np.int64)).to(self.device)
        return x.permute(0, 3, 1, 2).contiguous(), y

    # -------------------------------------------------------------------- fit
    def fit(self, resume: bool = False) -> None:
        self.datamodule.prepare_data()
        self.datamodule.setup("fit")
        steps_per_epoch = self.datamodule.steps_per_epoch()
        if resume and self.ckpt.latest_step is not None:
            self.restore()
            spe = max(steps_per_epoch, 1)
            self.epoch = self.global_step // spe
            self._skip_batches = self.global_step % spe
            self.logger.log_text(
                "trainer",
                f"resumed at step {self.global_step} (epoch {self.epoch}"
                + (f", skipping {self._skip_batches} consumed batches)" if self._skip_batches else ")"),
            )
        if self.state is None:
            self.state = self._init_state()
        replaced = self._install_signal_handlers()
        try:
            self._fit_loop()
        finally:
            for sig, old in replaced.items():
                signal.signal(sig, old)

    def _fit_loop(self) -> None:
        for cb in self.callbacks:
            cb.on_train_start(self)
        while self.epoch < self.max_epochs and not self._interrupted:
            self.extra_ckpt_metrics = {}
            t_epoch = time.time()
            n_samples = 0
            last_metrics = None
            skip, self._skip_batches = self._skip_batches, 0
            batches_fn = self.datamodule.train_batches_raw if self.device_preprocess else self.datamodule.train_batches
            try:
                batches = batches_fn(self.epoch, skip=skip)
                skip = 0
            except TypeError:  # a datamodule without skip
                batches = batches_fn(self.epoch)
            for i, batch_np in enumerate(batches):
                if i < skip:
                    continue
                batch = self._to_device(batch_np)
                sched_count = self.epoch if self.opt_cfg.scheduler_interval == "epoch" else self.global_step
                generator = folded_generator(self.seed, self.state.step, self.device)
                self.state, metrics = self._train_step(self.state, batch, generator, sched_count)
                self.global_step += 1
                n_samples += len(batch_np[0])
                last_metrics = metrics
                if self.global_step % self.log_every_n_steps == 0:
                    self._flush_metrics(metrics)
                if self._interrupted:
                    break
            if last_metrics is not None:
                # reading the loss waits for the epoch's steps: the rate is
                # the card's, not the enqueue's
                train_loss = float(last_metrics["train_loss"])
                dt = time.time() - t_epoch
                self.logger.log_metrics(
                    {"epoch": self.epoch, "samples_per_sec": n_samples / dt, "train_loss": train_loss},
                    step=self.global_step,
                )
            if self._interrupted:
                break  # straight to the preemption save: no validation or callbacks
            val_loss = None
            if (self.epoch + 1) % self.check_val_every_n_epoch == 0:
                val_loss = self.validate()
                if val_loss is not None:
                    self._last_val = (self.global_step, val_loss)
            for cb in self.callbacks:
                cb.on_train_epoch_end(self)
            if (self.epoch + 1) % self.ckpt_every_n_epochs == 0:
                self.save_checkpoint(val_loss)
            self.epoch += 1

        if self._interrupted:
            self.logger.log_text("trainer", "preemption signal received - checkpointing and exiting")
        if self.ckpt.latest_step != self.global_step:
            # a validation at this very step ranks the final save
            last = self._last_val
            self.save_checkpoint(last[1] if last and last[0] == self.global_step else None)
        for cb in self.callbacks:
            cb.on_fit_end(self)

    def _flush_metrics(self, metrics) -> None:
        host = {k: float(v) for k, v in metrics.items() if k not in ("sse", "count")}
        host["train_loss_running"] = float(metrics["sse"]) / max(float(metrics["count"]), 1.0)
        self.logger.log_metrics(host, step=self.global_step)

    # ------------------------------------------------------------- validation
    def validate(self) -> Optional[float]:
        """val_loss = sum(sse) / sum(count) over the whole val set (None for
        an empty one), logged with the per-profile series."""
        if self.state is None:
            raise RuntimeError("validate() needs a state: call fit() or restore() first")
        sse = count = None
        profile_sse: dict[int, torch.Tensor] = {}
        for i, (images, labels) in enumerate(self.datamodule.val_batches()):
            batch = to_device(images, labels, self.device)
            seed = fold_seed(self.seed + VAL_SEED_OFFSET, i) % 2**32
            out = self._eval_step(self.state, batch, seed)
            sse = out["sse"].double() if sse is None else sse + out["sse"].double()
            count = out["count"].double() if count is None else count + out["count"].double()
            for j in range(len(self._ema_sigma_rels)):
                key = f"sse_ema{j}"
                if key in out:
                    prev = profile_sse.get(j)
                    profile_sse[j] = out[key].double() if prev is None else prev + out[key].double()
        if count is None or float(count) == 0:
            self.logger.log_text("trainer", "validation skipped: empty val set")
            return None
        n = float(count)
        val_loss = float(sse) / n
        metrics = {"val_loss": val_loss}
        for j, s in profile_sse.items():
            metrics[f"val_loss/ema_{self._ema_sigma_rels[j]}"] = float(s) / n
        self.logger.log_metrics(metrics, step=self.global_step)
        for cb in self.callbacks:
            cb.on_validation_end(self)
        return val_loss

    # ------------------------------------------------------------- generation
    def solve(
        self,
        solver,
        x0: torch.Tensor,
        class_labels: Optional[torch.Tensor] = None,
        use_ema: bool = False,
        ema_index: int = 0,
        guidance_scale: Optional[float] = None,
        guidance_interval: Optional[tuple] = None,
    ) -> torch.Tensor:
        """Run ``solver`` from ``x0`` (NCHW) with the train weights or EMA
        tree ``ema_index``; ``guidance_scale`` applies classifier-free
        guidance (on ``guidance_interval`` where given)."""
        if self.state is None:
            raise RuntimeError("solve() needs a state: call fit() or restore() first")
        guided = guidance_scale is not None and guidance_scale != 1.0
        if guided and class_labels is None:
            raise ValueError("guidance_scale needs class labels")
        if use_ema and not self.state.ema:
            raise ValueError(
                "solve(use_ema=True) but the train state tracks no EMA profiles "
                "(EMAConfig absent or sigma_rels empty)"
            )
        tree = self.state.ema[ema_index] if use_ema else self.state.params
        weights = {**tree, **self.state.constants}
        model = self.model

        def denoise_fn(x, sigma, labels):
            return torch.func.functional_call(model, weights, (x, sigma, labels))

        fn = cfg_denoise_fn(denoise_fn, guidance_scale, interval=guidance_interval) if guided else denoise_fn
        with torch.inference_mode():
            return solver.solve(fn, x0, class_labels)

    # ------------------------------------------------------------ checkpoints
    def save_checkpoint(self, val_loss: Optional[float]) -> None:
        metrics = dict(self.extra_ckpt_metrics)
        if val_loss is not None:
            metrics["val_loss"] = val_loss
        self.ckpt.save(self.global_step, self.state, config=self.config, metrics=metrics or None)
        self.logger.log_checkpoint(self.ckpt.directory / str(self.global_step), self.global_step)
