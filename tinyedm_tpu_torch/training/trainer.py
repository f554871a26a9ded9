"""The training driver: epochs, validation, checkpoints, previews, resume.

Counterpart of ``tinyedm_tpu/training/trainer.py``, one process per device
(the card unless ``device="cpu"``):

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

Under a process group (``parallel.mesh.init_distributed``) the ranks form a
``data x model`` grid, ``model_parallel`` ranks to a model group
(``parallel.mesh.make_grid``; a world it does not divide raises
``ValueError``). Each data rank trains on its share of every global batch
(``shard_batch``; a data module that ``yields_process_local``, as latpack
does, yields only those rows) with its own random stream
(``step_generator``), which the ranks of its model group share; the step's
gradient sync over the data group makes the update the global batch's
(``parallel.mesh.ParallelPlan``). With ``model_parallel > 1`` every
weight-normed kernel whose output count divides it is held as the rank's
shard of output channels, in the params, the Adam moments and every EMA tree
(``parallel/tensor.py``), and the model gathers activations over the model
group. ``zero1`` keeps only the rank's range (within its data group) of the
Adam moments and EMA trees. ``samples_per_sec`` counts global samples.
Validation pads each batch to a multiple of the data size with zero-weight
rows, each data rank evaluates its share with the draws of its global rows,
and one all-reduce of the scalar sums over the data group ends it, so
``val_loss`` does not depend on the grid. The ranks agree when to stop: a
rank's SIGTERM rides the next step's sync, and every rank leaves the loop
after the step that reads it. Only rank 0 logs and writes checkpoints; a
save gathers ZeRO-1's ranges over the data group and the shards over the
model group, one tensor at a time, so its files hold whole tensors and a
run saved on one grid resumes on another. The previews and FID samples are
drawn by rank 0's model group (every forward is collective); rank 0 writes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import signal
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from tinyedm_tpu_torch.data.datamodules import to_device
from tinyedm_tpu_torch.diffusion.guidance import cfg_denoise_fn
from tinyedm_tpu_torch.models.edm import init_weights
from tinyedm_tpu_torch.parallel.mesh import ParallelPlan, all_reduce, barrier, distributed, make_grid, shard_batch
from tinyedm_tpu_torch.parallel.tensor import gather_tree, shard_model, shard_tree
from tinyedm_tpu_torch.training.callbacks import Callback
from tinyedm_tpu_torch.training.checkpoint import CheckpointManager
from tinyedm_tpu_torch.training.experiment import EDMSpec
from tinyedm_tpu_torch.training.state import TrainState
from tinyedm_tpu_torch.training.train_step import init_train_state, make_eval_step, make_train_step
from tinyedm_tpu_torch.utils.cuda import fold_seed, resolve_device, step_generator
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
        self.grid = make_grid(model_parallel)
        self.device = resolve_device(device)
        self.rank = self.grid.rank
        self.zero1 = bool(zero1)
        self.spec = spec
        # seeded weights, drawn whole on the CPU so that every device starts
        # from the same ones, then cut to the rank's shards; a resume
        # replaces them
        model = spec.build_model()
        init_weights(model, torch.Generator().manual_seed(seed))
        self.shards = shard_model(model, self.grid)
        self.model = model.to(self.device)
        # the step's collectives: under a process group, or for ZeRO-1's
        # range update (in one process a range of everything)
        self.plan = None
        if distributed() or self.zero1:
            self.plan = ParallelPlan(dict(self.model.named_parameters()), zero1=self.zero1, sharded=self.shards)
        self.diffuser = spec.diffuser
        self.opt_cfg = spec.build_optimizer_config()
        self.ema_cfg = spec.build_ema_config()
        self.use_ema = self.ema_cfg is not None
        self.datamodule = datamodule
        # a host batch's conversion: the data module's own where it has one
        # (a text-conditioned module's conditioning), else images and labels
        self._batch_to_device = getattr(datamodule, "to_device", to_device)
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
            primary=self.rank == 0,
        )
        # per-epoch checkpoint-selection metrics that callbacks deposit;
        # merged into the next save, cleared at each epoch's start
        self.extra_ckpt_metrics: dict = {}
        self.ckpt_every_n_epochs = ckpt_every_n_epochs
        self._train_step = make_train_step(self.model, self.diffuser, self.opt_cfg, self.ema_cfg, plan=self.plan)
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
        self._whole_ema = None  # ZeRO-1: the EMA trees gathered for validation and callbacks
        self._interrupted = False  # this process's SIGTERM/SIGINT
        self._stopped = False  # over several ranks: the agreed stop
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
        return self._place(init_train_state(self.model, self.opt_cfg, self.ema_cfg))

    def _place(self, state: TrainState) -> TrainState:
        """ZeRO-1: only this rank's range of the moments and EMA trees kept."""
        if self.zero1:
            self.plan.place(state)
        return state

    def restore(self, step: Optional[int] = None) -> None:
        """The checkpoint of ``step`` (the latest by default) into the model
        and a state over its parameters; every rank reads the file."""
        # ZeRO-1 and tensor parallelism read the whole file into host memory
        # and keep the rank's range and shards
        sharded = self.zero1 or self.grid.model_size > 1
        saved, _ = self.ckpt.restore(step, device="cpu" if sharded else self.device)
        m = self.grid.model_rank

        def mine(tree):
            tree = shard_tree(tree, self.shards, m)
            return {k: v.to(self.device) for k, v in tree.items()} if sharded and not self.zero1 else tree

        self.model.load_state_dict({**shard_tree(saved.params, self.shards, m), **saved.constants})
        self.state = self._place(TrainState(
            step=saved.step,
            params=dict(self.model.named_parameters()),
            constants=dict(self.model.named_buffers()),
            mu=mine(saved.mu),
            nu=mine(saved.nu),
            count=saved.count,
            ema=tuple(mine(tree) for tree in saved.ema),
        ))
        self.global_step = saved.step

    def sampling_tree(self, use_ema: bool = False, ema_index: int = 0) -> dict[str, torch.Tensor]:
        """The weights ``solve`` samples with: the params, or EMA tree
        ``ema_index``; under ZeRO-1 the tree gathered while the callbacks
        run, else gathered now (then every rank must call it)."""
        if not use_ema:
            return self.state.params
        if not self.state.ema:
            raise ValueError(
                "solve(use_ema=True) but the train state tracks no EMA profiles "
                "(EMAConfig absent or sigma_rels empty)"
            )
        if self._whole_ema is not None:
            return self._whole_ema[ema_index]
        tree = self.state.ema[ema_index]
        return self.plan.gather(tree) if self.zero1 else tree

    @contextlib.contextmanager
    def _ema_whole(self):
        """Under ZeRO-1, every EMA tree gathered whole for the duration (on
        every rank): validation and the callbacks, which sample on rank 0
        alone, read them."""
        if not self.zero1 or not self.state.ema or self._whole_ema is not None:
            yield
            return
        self._whole_ema = tuple(self.plan.gather(tree) for tree in self.state.ema)
        try:
            yield
        finally:
            self._whole_ema = None

    def _to_device(self, batch_np) -> tuple:
        """A host batch as (NCHW fp32 images, labels or conditioning) on the
        device; the raw form (uint8, flip flags, labels) is normalized and
        flipped there."""
        if not self.device_preprocess:
            return self._batch_to_device(batch_np[0], batch_np[1], self.device)
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

    def _stop_agreed(self, flag: Optional[torch.Tensor] = None) -> bool:
        """Whether to leave the loop: in one process, this process's signal;
        over several ranks, a step's all-reduced interrupt count (the same on
        every rank), remembered once positive."""
        if not distributed():
            return self._interrupted
        if flag is not None and float(flag) > 0:
            self._stopped = True
        return self._stopped

    def _fit_loop(self) -> None:
        for cb in self.callbacks:
            cb.on_train_start(self)
        process_local = bool(getattr(self.datamodule, "yields_process_local", False))
        while self.epoch < self.max_epochs and not self._stop_agreed():
            self.extra_ckpt_metrics = {}
            t_epoch = time.time()
            n_samples = 0
            last_metrics = None
            # over several ranks: the previous step's interrupt count, read
            # after the next step is queued so the card never waits for it
            pending = None
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
                # samples_per_sec counts global samples
                n_samples += len(batch_np[0]) * (self.grid.data_size if process_local else 1)
                batch = self._to_device(shard_batch(batch_np, process_local))
                sched_count = self.epoch if self.opt_cfg.scheduler_interval == "epoch" else self.global_step
                generator = step_generator(self.seed, self.state.step, self.device, self.grid.data_rank,
                                           self.grid.data_size)
                # the interrupt flag rides the step's all-reduce
                flags = (self._interrupted,) if self.plan is not None else ()
                self.state, metrics = self._train_step(self.state, batch, generator, sched_count, *flags)
                flag = metrics.pop("interrupt", None)
                self.global_step += 1
                last_metrics = metrics
                if self.global_step % self.log_every_n_steps == 0:
                    self._flush_metrics(metrics)
                if self._stop_agreed(pending):
                    break
                pending = flag
            else:
                self._stop_agreed(pending)
            if last_metrics is not None:
                # reading the loss waits for the epoch's steps: the rate is
                # the card's, not the enqueue's
                train_loss = float(last_metrics["train_loss"])
                dt = time.time() - t_epoch
                self.logger.log_metrics(
                    {"epoch": self.epoch, "samples_per_sec": n_samples / dt, "train_loss": train_loss},
                    step=self.global_step,
                )
            if self._stop_agreed():
                break  # straight to the preemption save: no validation or callbacks
            val_loss = None
            if (self.epoch + 1) % self.check_val_every_n_epoch == 0:
                val_loss = self.validate()
                if val_loss is not None:
                    self._last_val = (self.global_step, val_loss)
            with self._ema_whole() if self.callbacks else contextlib.nullcontext():
                for cb in self.callbacks:
                    cb.on_train_epoch_end(self)
            if (self.epoch + 1) % self.ckpt_every_n_epochs == 0:
                self.save_checkpoint(val_loss)
            self.epoch += 1

        if self._stop_agreed():
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
        an empty one), logged with the per-profile series. Over several
        data ranks each batch is padded to a multiple of the data size with
        zero-weight rows and each data rank evaluates its share; one
        all-reduce of the sums over the data group ends it."""
        if self.state is None:
            raise RuntimeError("validate() needs a state: call fit() or restore() first")
        with self._ema_whole():
            return self._validate()

    def _validate(self) -> Optional[float]:
        state = self.state
        if self._whole_ema is not None:
            state = dataclasses.replace(state, ema=self._whole_ema)
        rank, size = self.grid.data_rank, self.grid.data_size
        sums = None  # fp64 (sse, count, sse_ema0, ...)
        n_profiles = len(self._ema_sigma_rels) if len(self._ema_sigma_rels) > 1 else 0
        for i, (images, labels) in enumerate(self.datamodule.val_batches()):
            seed = fold_seed(self.seed + VAL_SEED_OFFSET, i) % 2**32
            if size == 1:
                out = self._eval_step(state, self._batch_to_device(images, labels, self.device), seed)
            else:
                n = len(images)
                pad = (-n) % size
                mask = np.ones((n + pad,), np.float32)
                mask[n:] = 0.0
                images = np.concatenate([images, np.zeros((pad, *images.shape[1:]), images.dtype)])
                if labels is not None:
                    labels = np.concatenate([labels, np.zeros((pad, *np.shape(labels)[1:]), np.asarray(labels).dtype)])
                images, labels, mask = shard_batch((images, labels, mask))
                x, y = self._batch_to_device(images, labels, self.device)
                out = self._eval_step(state, (x, y, torch.from_numpy(mask).to(self.device)), seed,
                                      row_offset=rank * len(mask))
            row = torch.stack([out["sse"], out["count"], *(out[f"sse_ema{j}"] for j in range(n_profiles))]).double()
            sums = row if sums is None else sums + row
        if sums is not None:
            all_reduce(sums, "data")
        if sums is None or float(sums[1]) == 0:
            self.logger.log_text("trainer", "validation skipped: empty val set")
            return None
        sums = sums.tolist()
        n = sums[1]
        val_loss = sums[0] / n
        metrics = {"val_loss": val_loss}
        for j in range(n_profiles):
            metrics[f"val_loss/ema_{self._ema_sigma_rels[j]}"] = sums[2 + j] / n
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
        tree ``ema_index`` (``sampling_tree``); ``guidance_scale`` applies
        classifier-free guidance (on ``guidance_interval`` where given)."""
        if self.state is None:
            raise RuntimeError("solve() needs a state: call fit() or restore() first")
        guided = guidance_scale is not None and guidance_scale != 1.0
        if guided and class_labels is None:
            raise ValueError("guidance_scale needs class labels")
        tree = self.sampling_tree(use_ema, ema_index)
        weights = {**tree, **self.state.constants}
        model = self.model

        def denoise_fn(x, sigma, labels):
            return torch.func.functional_call(model, weights, (x, sigma, labels))

        fn = cfg_denoise_fn(denoise_fn, guidance_scale, interval=guidance_interval) if guided else denoise_fn
        with torch.inference_mode():
            return solver.solve(fn, x0, class_labels)

    # ------------------------------------------------------------ checkpoints
    def save_checkpoint(self, val_loss: Optional[float]) -> None:
        """Rank 0 writes, then every rank waits for it; a ZeRO-1 or
        tensor-parallel state is gathered first, tree by tree into host
        memory (ZeRO-1's ranges over the data group, then the shards over
        the model group one tensor at a time), so its file holds whole
        tensors, the data-parallel one's."""
        metrics = dict(self.extra_ckpt_metrics)
        if val_loss is not None:
            metrics["val_loss"] = val_loss
        state = self.state
        if self.zero1 or self.grid.model_size > 1:
            def whole(tree, ranged: bool = True):
                full = self.plan.gather(tree) if self.zero1 and ranged else tree
                full = gather_tree(full, self.shards, self.grid, device="cpu")
                return full if self.rank == 0 else {}

            state = dataclasses.replace(state, params=whole(state.params, ranged=False), mu=whole(state.mu),
                                        nu=whole(state.nu), ema=tuple(whole(tree) for tree in state.ema))
        self.ckpt.save(self.global_step, state, config=self.config, metrics=metrics or None)
        barrier()
        self.logger.log_checkpoint(self.ckpt.directory / str(self.global_step), self.global_step)
