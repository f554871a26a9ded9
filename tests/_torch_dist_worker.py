"""Ranks of the port's multi-process tests: ``run(task, size, tmp, **args)``
spawns ``size`` processes that join one gloo group (a file store under
``tmp``, so parallel test workers race for no port), run the task function
of this module named ``task`` and send back what it returns, one result per
rank. A rank that raises fails the call with its traceback; a run past its
timeout is killed and fails it. A spawned child imports this module, which
imports only torch, numpy and the port, never JAX.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import traceback
from datetime import timedelta
from pathlib import Path

import torch

from tinyedm_tpu_torch.configs import CONFIGS
from tinyedm_tpu_torch.data.datamodules import SyntheticDataModule, to_device
from tinyedm_tpu_torch.diffusion.diffuser import Diffuser
from tinyedm_tpu_torch.models import blocks
from tinyedm_tpu_torch.models.edm import EDM
from tinyedm_tpu_torch.models.layers import Embedding
from tinyedm_tpu_torch.models.unet import Denoiser
from tinyedm_tpu_torch.parallel.audit import collective_inventory
from tinyedm_tpu_torch.parallel.mesh import ParallelPlan, init_distributed, process_local_slice
from tinyedm_tpu_torch.training.ema import EMAConfig
from tinyedm_tpu_torch.training.state import TrainState
from tinyedm_tpu_torch.training.train_step import OptimizerConfig, make_train_step
from tinyedm_tpu_torch.utils.cuda import step_generator

# tests/_torch_parity.py's smoke model, without importing JAX
SMOKE_DENOISER = {k: v for k, v in CONFIGS["smoke"]["denoiser"].items() if k not in ("dtype", "dropout_rate")}
SMOKE_EMBEDDING = {k: v for k, v in CONFIGS["smoke"]["embedding"].items() if k != "num_classes"}
# tests/test_torch_trainer.py's tiny spec and data
TINY = {
    "_target_": "tinyedm_tpu.training.experiment.EDMSpec",
    "diffuser": {"_target_": "tinyedm_tpu.diffusion.diffuser.Diffuser", "P_mean": -1.2, "P_std": 1.2},
    "embedding": {"_target_": "tinyedm_tpu.models.layers.Embedding", "fourier_dim": 8, "embedding_dim": 16,
                  "num_classes": 10},
    "denoiser": {
        "_target_": "tinyedm_tpu.models.unet.Denoiser", "in_channels": 1, "out_channels": 1, "embedding_dim": 16,
        "num_heads": 2, "sigma_data": 0.5, "encoder_block_types": ["Enc", "EncD"],
        "decoder_block_types": ["Dec", "DecU", "Dec", "Dec"], "encoder_out_channels": [8, 16],
        "decoder_out_channels": [16, 8, 8, 8], "skip_connections": [True, False, True, True],
        "dtype": "float32",
    },
    "use_ema": True, "ema_length": 0.13, "lr": 1e-3, "rampup_steps": 2, "steady_steps": 4,
    "scheduler_interval": "epoch",
}
DATA = dict(batch_size=16, image_size=8, num_channels=1, num_samples=64)
TIMEOUT = 120.0  # seconds for a whole run; the group's own timeout is shorter
GROUP_TIMEOUT = timedelta(seconds=60)


# ---------------------------------------------------------------- the runner
def _entry(rank: int, size: int, store: str, task: str, args: dict, out: str) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size), LOCAL_RANK=str(rank))
    try:
        init_distributed(backend="gloo", init_method=f"file://{store}", timeout=GROUP_TIMEOUT)
        result = globals()[task](rank, size, **args)
        torch.distributed.destroy_process_group()
        torch.save(result, out)
    except BaseException:
        Path(out + ".err").write_text(traceback.format_exc())
        raise


def run(task: str, size: int, tmp: Path, timeout: float = TIMEOUT, **args) -> list:
    """Run ``task`` on ``size`` spawned ranks; their results in rank order."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    store = tmp / f"store-{task}"
    if store.exists():
        store.unlink()
    outs = [str(tmp / f"{task}-{r}.pt") for r in range(size)]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(r, size, str(store), task, args, outs[r])) for r in range(size)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
            timeout = max(1.0, timeout / 4)  # the others end with the first, or soon after
    finally:
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errors = [Path(o + ".err").read_text() for o in outs if Path(o + ".err").exists()]
    if errors or alive or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"{task} on {size} ranks: still running {alive}, exit codes "
                           f"{[p.exitcode for p in procs]}\n" + "\n".join(errors))
    return [torch.load(o, weights_only=False) for o in outs]


# ------------------------------------------------------------------ helpers
class ContentDiffuser(Diffuser):
    """Draws that are a function of each image alone (two of its pixels and
    its mirror image), so that a row draws the same wherever it lies: in any
    microbatch, on any rank, in either package."""

    def __call__(self, clean_image, generator):
        x = clean_image.float()
        eps = 1.5 * (x[:, 0, 0, 0] + x[:, -1, -1, -1])  # (NHWC: x[:, 0, 0, 0] + x[:, -1, -1, -1])
        return self.apply(clean_image, eps, 1.5 * x.flip(1, 2, 3))


def smoke_model(dropout_rate: float = 0.0) -> EDM:
    return EDM(Embedding(**SMOKE_EMBEDDING, num_classes=10),
               Denoiser(**SMOKE_DENOISER, dropout_rate=dropout_rate, dtype=torch.float32))


def load_state(model: EDM, start: dict) -> TrainState:
    """A state over ``model``'s params from a whole state's tensors."""
    model.load_state_dict({**start["params"], **start["constants"]})
    return TrainState(step=start["step"], params=dict(model.named_parameters()),
                      constants=dict(model.named_buffers()),
                      mu={k: v.clone() for k, v in start["mu"].items()},
                      nu={k: v.clone() for k, v in start["nu"].items()}, count=start["count"],
                      ema=tuple({k: v.clone() for k, v in tree.items()} for tree in start["ema"]))


def whole(state: TrainState, plan: ParallelPlan | None) -> dict:
    """The state's tensors, whole (a ZeRO-1 state gathered), as CPU copies."""
    def cpu(tree):
        return {k: v.detach().clone() for k, v in tree.items()}

    z = plan is not None and plan.zero1
    return {"step": state.step, "count": state.count, "params": cpu(state.params),
            "mu": cpu(plan.gather(state.mu) if z else state.mu), "nu": cpu(plan.gather(state.nu) if z else state.nu),
            "ema": [cpu(plan.gather(t) if z else t) for t in state.ema]}


# -------------------------------------------------------------------- tasks
def train_steps(rank: int, size: int, start: dict, batches: list, opt: dict, sigma_rels: tuple,
                sched_count: int, zero1: bool = False, dropout_rate: float = 0.0, seed: int = 0,
                grouped: bool = True) -> dict:
    """The smoke model's train step on this rank's share of each global
    batch, with ``ContentDiffuser`` draws at dropout 0, else the rank's own
    stream; ``grouped=False`` runs without a plan (the step of one process).
    Returns the whole state, each step's metrics and collectives, the
    per-rank state bytes and the first dropout bits this rank drew."""
    model = smoke_model(dropout_rate)
    state = load_state(model, start)
    plan = ParallelPlan(dict(model.named_parameters()), zero1=zero1) if grouped else None
    if zero1:
        plan.place(state)
    bits = []
    drawn = blocks.dropout_bits

    def recording(*a, **k):
        out = drawn(*a, **k)
        bits.append(out.clone())
        return out

    blocks.dropout_bits = recording
    diffuser = ContentDiffuser() if dropout_rate == 0 else Diffuser()
    step = make_train_step(model, diffuser, OptimizerConfig(**opt), EMAConfig(tuple(sigma_rels)), plan=plan)
    metrics, inventories = [], []
    for images, labels in batches:
        share = process_local_slice(images, rank, size), process_local_slice(labels, rank, size)
        gen = step_generator(seed, state.step, "cpu", rank, size)
        with collective_inventory() as inv:
            state, m = step(state, to_device(*share, "cpu"), gen, sched_count)
        metrics.append({k: float(v) for k, v in m.items()})
        inventories.append([dataclasses.astuple(c) for c in inv])
    moment_bytes = sum(v.numel() * 4 for v in (*state.mu.values(), *state.nu.values()))
    ema_bytes = sum(v.numel() * 4 for tree in state.ema for v in tree.values())
    return {"state": whole(state, plan), "metrics": metrics, "inventories": inventories,
            "moment_bytes": moment_bytes, "ema_bytes": ema_bytes, "bits": bits[0] if bits else None}


def _trainer(out_dir: str, zero1: bool = False, spec_changes: dict | None = None, val_rows: int | None = None,
             **kw):
    from tinyedm_tpu_torch.config import registry
    from tinyedm_tpu_torch.training.trainer import Trainer

    dm = SyntheticDataModule(**DATA)
    if val_rows is not None:
        dm.val_images, dm.val_labels = dm.train_images[:val_rows], dm.train_labels[:val_rows]
    spec = {**TINY, **(spec_changes or {})}
    return Trainer(spec=registry.instantiate(spec), datamodule=dm, out_dir=out_dir, seed=0, device="cpu",
                   config={"model": spec, "seed": 0}, zero1=zero1, **kw)


class FedDiffuser(Diffuser):
    """Validation draws fed by the seed of the per-sample generator that the
    port's eval step makes (``folded_generator(seed, row)``)."""

    def __init__(self, draws: dict):
        super().__init__()
        object.__setattr__(self, "draws", draws)

    def __call__(self, clean_image, generator):
        eps, noise = self.draws[generator.initial_seed()]
        return self.apply(clean_image, torch.tensor(eps), torch.tensor(noise).permute(0, 3, 1, 2))


def validate(rank: int, size: int, out_dir: str, val_rows: int, start: dict | None = None,
             draws: dict | None = None, zero1: bool = False) -> dict:
    """One ``Trainer.validate`` of the tiny spec on ``val_rows`` validation
    samples at batch 16, from ``start`` (a whole state's tensors; the seeded
    init without) with ``draws`` fed to the eval step (its own without).
    Returns val_loss and the collectives it made."""
    from tinyedm_tpu_torch.training.train_step import make_eval_step

    trainer = _trainer(out_dir, zero1=zero1, val_rows=val_rows)
    trainer.datamodule.setup("fit")
    if start is None:
        trainer.state = trainer._init_state()
    else:
        trainer.state = trainer._place(load_state(trainer.model, start))
    if draws is not None:
        trainer._eval_step = make_eval_step(trainer.model, FedDiffuser(draws), use_ema=True)
    with collective_inventory() as inv:
        val_loss = trainer.validate()
    return {"val_loss": val_loss, "inventory": [dataclasses.astuple(c) for c in inv]}


def fit(rank: int, size: int, out_dir: str, zero1: bool = False, max_epochs: int = 2,
        interrupt: tuple | None = None, process_local: bool = False) -> dict:
    """A ``Trainer.fit`` of the tiny spec on ``DATA``, checkpoints every
    epoch. ``interrupt`` = (rank, epoch, batch): that rank alone takes a
    preemption signal as that batch is drawn. ``process_local``: the data
    module yields only this rank's rows of each global batch, as latpack
    does, and the trainer slices them no further. Returns
    the params, whether this rank's logger and checkpoint manager wrote, the
    saves it wrote and the per-rank moment bytes."""
    trainer = _trainer(out_dir, zero1=zero1, max_epochs=max_epochs, check_val_every_n_epoch=1,
                       ckpt_every_n_epochs=1, log_every_n_steps=2)
    if process_local:
        dm, whole = trainer.datamodule, trainer.datamodule.train_batches
        dm.yields_process_local = True
        dm.train_batches = lambda epoch, **kw: (tuple(process_local_slice(x, rank, size) for x in b)
                                               for b in whole(epoch, **kw))
    if interrupt is not None and interrupt[0] == rank:
        batches = trainer.datamodule.train_batches

        def interrupting(epoch, **kw):
            for i, b in enumerate(batches(epoch, **kw)):
                if (epoch, i) == interrupt[1:]:
                    trainer._interrupted = True  # what the SIGTERM handler sets
                yield b

        trainer.datamodule.train_batches = interrupting
    writes = []
    real_write = trainer.ckpt._write
    trainer.ckpt._write = lambda step, *a: writes.append(step) or real_write(step, *a)
    trainer.fit()
    return {"params": {k: v.detach().clone() for k, v in trainer.state.params.items()},
            "logger_enabled": trainer.logger.enabled, "writes": writes, "global_step": trainer.global_step,
            "latest_step": trainer.ckpt.latest_step,
            "moment_bytes": sum(v.numel() * 4 for v in trainer.state.mu.values())}


def generate(rank: int, size: int, **kwargs) -> dict:
    """``generate.generate(**kwargs)`` on the CPU with its collectives."""
    from tinyedm_tpu_torch.generate import generate as sample

    with collective_inventory() as inv:
        out = sample(device="cpu", **kwargs)
    return {"images": out["images"], "inventory": [dataclasses.astuple(c) for c in inv]}


def many(rank: int, size: int, calls: list) -> list:
    """Several tasks, (name, args) each, in one group: one spawn for all."""
    return [globals()[task](rank, size, **args) for task, args in calls]
