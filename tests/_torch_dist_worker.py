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
import threading
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
from tinyedm_tpu_torch.parallel.mesh import (
    ParallelPlan,
    all_reduce,
    data_world,
    init_distributed,
    make_grid,
    process_local_slice,
)
from tinyedm_tpu_torch.parallel.tensor import gather_tree, shard_model, shard_tree
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


def load_state(model: EDM, start: dict, grid=None) -> tuple[TrainState, dict]:
    """A state over ``model``'s params from a whole state's tensors, cut to
    this rank's shards on ``grid`` (tensor parallelism); and the shards."""
    model.load_state_dict({**start["params"], **start["constants"]})
    shards, m = (shard_model(model, grid), grid.model_rank) if grid is not None else ({}, 0)

    def mine(tree):
        return {k: v.clone() for k, v in shard_tree(tree, shards, m).items()}

    return TrainState(step=start["step"], params=dict(model.named_parameters()),
                      constants=dict(model.named_buffers()), mu=mine(start["mu"]), nu=mine(start["nu"]),
                      count=start["count"], ema=tuple(mine(tree) for tree in start["ema"])), shards


def whole(state: TrainState, plan: ParallelPlan | None, shards: dict | None = None, grid=None) -> dict:
    """The state's tensors, whole (a ZeRO-1 state gathered over the data
    group, shards over the model group), as CPU copies."""
    z = plan is not None and plan.zero1

    def cpu(tree, ranged=True):
        tree = plan.gather(tree) if z and ranged else tree
        if shards:
            tree = gather_tree(tree, shards, grid)
        return {k: v.detach().clone() for k, v in tree.items()}

    return {"step": state.step, "count": state.count, "params": cpu(state.params, ranged=False),
            "mu": cpu(state.mu), "nu": cpu(state.nu), "ema": [cpu(t) for t in state.ema]}


# -------------------------------------------------------------------- tasks
def train_steps(rank: int, size: int, start: dict, batches: list, opt: dict, sigma_rels: tuple,
                sched_count: int, zero1: bool = False, dropout_rate: float = 0.0, seed: int = 0,
                grouped: bool = True, model_parallel: int = 1) -> dict:
    """The smoke model's train step on this rank's share of each global
    batch (its data rank's), with ``ContentDiffuser`` draws at dropout 0,
    else the data rank's own stream; ``grouped=False`` runs without a plan
    (the step of one process); ``model_parallel`` ranks to a model group.
    Returns the whole state, each step's metrics and collectives, the
    per-rank state bytes, the first dropout bits this rank drew and the
    largest deviation from unit RMS of a weight-normed output unit."""
    grid = make_grid(model_parallel) if grouped else None
    model = smoke_model(dropout_rate)
    state, shards = load_state(model, start, grid if model_parallel > 1 else None)
    plan = ParallelPlan(dict(model.named_parameters()), zero1=zero1, sharded=shards) if grouped else None
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
    d, n_data = data_world() if grouped else (0, 1)
    for images, labels in batches:
        share = process_local_slice(images, d, n_data), process_local_slice(labels, d, n_data)
        gen = step_generator(seed, state.step, "cpu", d, n_data)
        with collective_inventory() as inv:
            state, m = step(state, to_device(*share, "cpu"), gen, sched_count)
        metrics.append({k: float(v) for k, v in m.items()})
        inventories.append([dataclasses.astuple(c) for c in inv])
    blocks.dropout_bits = drawn
    moment_bytes = sum(v.numel() * 4 for v in (*state.mu.values(), *state.nu.values()))
    ema_bytes = sum(v.numel() * 4 for tree in state.ema for v in tree.values())
    param_bytes = sum(v.numel() * 4 for v in state.params.values())
    rms = max((float((w.detach().square().flatten(1).mean(1).sqrt() - 1).abs().max())
               for k, w in state.params.items() if w.ndim in (2, 4)), default=0.0)
    return {"state": whole(state, plan, shards, grid), "metrics": metrics, "inventories": inventories,
            "moment_bytes": moment_bytes, "ema_bytes": ema_bytes, "param_bytes": param_bytes,
            "bits": bits[0] if bits else None, "rms_dev": rms}


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
        trainer.state = trainer._place(load_state(trainer.model, start)[0])
    if draws is not None:
        trainer._eval_step = make_eval_step(trainer.model, FedDiffuser(draws), use_ema=True)
    with collective_inventory() as inv:
        val_loss = trainer.validate()
    return {"val_loss": val_loss, "inventory": [dataclasses.astuple(c) for c in inv]}


def fit(rank: int, size: int, out_dir: str, zero1: bool = False, max_epochs: int = 2,
        interrupt: tuple | None = None, process_local: bool = False, model_parallel: int = 1,
        previews: bool = False) -> dict:
    """A ``Trainer.fit`` of the tiny spec on ``DATA``, checkpoints every
    epoch, ``model_parallel`` ranks to a model group, with a Heun-3 preview
    of 4 samples every epoch where ``previews``. ``interrupt`` = (rank,
    epoch, batch): that rank alone takes a preemption signal as that batch is
    drawn. ``process_local``: the data module yields only this rank's rows of
    each global batch, as latpack does, and the trainer slices them no
    further. Returns the params (whole), whether this rank's logger and
    checkpoint manager wrote, the saves it wrote, the per-rank moment bytes
    and the preview grids this rank logged."""
    from tinyedm_tpu_torch.diffusion.solver import DeterministicSolver
    from tinyedm_tpu_torch.training.callbacks import GenerateCallback

    callbacks = [GenerateCallback(DeterministicSolver(num_steps=3), (1, 8, 8), num_samples=4, every_n_epochs=1)]
    trainer = _trainer(out_dir, zero1=zero1, max_epochs=max_epochs, check_val_every_n_epoch=1,
                       ckpt_every_n_epochs=1, log_every_n_steps=2, model_parallel=model_parallel,
                       callbacks=callbacks if previews else ())
    if process_local:
        dm, batches_of = trainer.datamodule, trainer.datamodule.train_batches
        dm.yields_process_local = True
        dm.train_batches = lambda epoch, **kw: (tuple(process_local_slice(x, rank, size) for x in b)
                                               for b in batches_of(epoch, **kw))
    if interrupt is not None and interrupt[0] == rank:
        batches = trainer.datamodule.train_batches

        def interrupting(epoch, **kw):
            for i, b in enumerate(batches(epoch, **kw)):
                if (epoch, i) == interrupt[1:]:
                    trainer._interrupted = True  # what the SIGTERM handler sets
                yield b

        trainer.datamodule.train_batches = interrupting
    writes, images = [], []
    real_write = trainer.ckpt._write
    trainer.ckpt._write = lambda step, *a: writes.append(step) or real_write(step, *a)
    real_image = trainer.logger.log_image
    trainer.logger.log_image = lambda key, img, step: images.append((key, step)) or real_image(key, img, step)
    trainer.fit()
    params = gather_tree(trainer.state.params, trainer.shards, trainer.grid)
    return {"params": {k: v.detach().clone() for k, v in params.items()},
            "logger_enabled": trainer.logger.enabled, "writes": writes, "global_step": trainer.global_step,
            "latest_step": trainer.ckpt.latest_step, "images": images,
            "moment_bytes": sum(v.numel() * 4 for v in trainer.state.mu.values())}


def restore(rank: int, size: int, out_dir: str, model_parallel: int = 1) -> dict:
    """The latest checkpoint of ``out_dir`` restored by a ``Trainer`` of
    the tiny spec on ``model_parallel`` ranks to a model group: the
    restored state gathered whole, and its per-rank moment bytes."""
    trainer = _trainer(out_dir, model_parallel=model_parallel)
    trainer.restore()
    state = whole(trainer.state, trainer.plan, trainer.shards, trainer.grid)
    return {"state": state, "moment_bytes": sum(v.numel() * 4 for v in trainer.state.mu.values())}


def attention_layer(rank: int, size: int, heads: int, fused: str = "auto", model_parallel: int = 2,
                    channels: int = 16, side: int = 4) -> dict:
    """``CosineAttention(channels, heads)`` with seeded weights, whole and
    sharded over a model group, on one input and one cotangent: the whole
    layer's output and input gradient, the sharded layer's (its input
    gradient summed over the model group), its weights' gradients gathered
    whole, and the collectives of its forward."""
    from tinyedm_tpu_torch.models.layers import CosineAttention

    grid = make_grid(model_parallel)
    gen = torch.Generator().manual_seed(heads)

    def build():
        layer = CosineAttention(channels, heads, fused=fused)
        with torch.no_grad():
            for p in layer.parameters():
                p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
        return layer

    x = torch.randn(2, channels, side, side, generator=gen)
    g = torch.randn(2, channels, side, side, generator=gen)
    out = {}
    for name, layer in (("whole", build()), ("tp", build())):
        shards = shard_model(layer, grid) if name == "tp" else {}
        xi = x.clone().requires_grad_(True)
        params = list(layer.parameters())
        with collective_inventory() as inv:
            y = layer(xi)
        # the train step's seed: each rank's gradient of a whole activation
        # is a partial sum over the model group. The backward runs on a
        # thread of its own, as autograd runs a CUDA backward: its psums
        # still reach the forward's inventory
        grads = []
        worker = threading.Thread(target=lambda: grads.append(torch.autograd.grad(
            y, [xi, *params], g / grid.model_size if shards else g)))
        worker.start()
        worker.join(60)
        dx, *dw = grads[0]
        if shards:  # the input's gradient summed, the weights' shards whole again
            all_reduce(dx, "model")
            dw = gather_tree(dict(zip([n for n, _ in layer.named_parameters()], dw)), shards, grid)
        else:
            dw = dict(zip([n for n, _ in layer.named_parameters()], dw))
        out[name] = {"y": y.detach(), "dx": dx, "dw": dw, "inventory": [dataclasses.astuple(c) for c in inv]}
    return out


def sample(rank: int, size: int, state_dict: dict, x0, labels, num_steps: int = 3,
           model_parallel: int = 2) -> dict:
    """Heun (``DeterministicSolver(num_steps)``) of the fp32 smoke model
    with ``state_dict``'s weights, sharded over a model group, from ``x0``
    (NCHW) on ``labels``; the samples and the solve's collectives."""
    from tinyedm_tpu_torch.diffusion.solver import DeterministicSolver

    grid = make_grid(model_parallel)
    model = smoke_model()
    model.load_state_dict(state_dict)
    shard_model(model, grid)
    with torch.inference_mode(), collective_inventory() as inv:
        out = DeterministicSolver(num_steps=num_steps).solve(model.eval(), x0, labels)
    return {"samples": out.clone(), "inventory": [dataclasses.astuple(c) for c in inv]}


def generate_cli(rank: int, size: int, argv: list) -> dict:
    """``python -m tinyedm_tpu_torch.generate`` (``main(argv)``) on this
    rank, with the rows each rank's PNG writer wrote."""
    from tinyedm_tpu_torch import generate as gen_module

    written = []
    real = gen_module.PreditionWriter.write_batch

    def counting(self, images, indices):
        written.extend(int(i) for i in indices)
        return real(self, images, indices)

    gen_module.PreditionWriter.write_batch = counting
    try:
        with collective_inventory() as inv:
            gen_module.main(argv)
    finally:
        gen_module.PreditionWriter.write_batch = real
    return {"written": written, "inventory": [dataclasses.astuple(c) for c in inv]}


def generate(rank: int, size: int, **kwargs) -> dict:
    """``generate.generate(**kwargs)`` on the CPU with its collectives."""
    from tinyedm_tpu_torch.generate import generate as solve

    with collective_inventory() as inv:
        out = solve(device="cpu", **kwargs)
    return {"images": out["images"], "inventory": [dataclasses.astuple(c) for c in inv]}


def train_cli(rank: int, size: int, argv: list) -> dict:
    """``python -m tinyedm_tpu_torch.train`` (``main(argv)``) in this rank's
    process group: the steps, the grid and the checkpoints it wrote."""
    from tinyedm_tpu_torch import train as train_module

    trainer = train_module.main(argv)
    return {"global_step": trainer.global_step, "model_size": trainer.grid.model_size,
            "sharded": sorted(trainer.shards), "steps": trainer.ckpt.all_steps}


def plan_sync(rank: int, size: int, model_parallel: int = 1) -> list:
    """One ``ParallelPlan.sync`` of two small gradients on the grid of
    ``model_parallel``: its collectives."""
    make_grid(model_parallel)
    params = {"w": torch.ones(4, 3), "gain": torch.ones(())}
    plan = ParallelPlan(params, sharded=("w",) if model_parallel > 1 else ())
    with collective_inventory() as inv:
        plan.sync([torch.ones(4, 3), torch.ones(())], [torch.tensor(1.0)], [torch.tensor(2.0)],
                  [torch.tensor(0.0)])
    return [dataclasses.astuple(c) for c in inv]


def collective_audit(rank: int, size: int, **kwargs) -> dict:
    """``tinyedm_tpu_torch.collective_audit.audit`` (the CLI's in-process
    function) on the CPU, with its report's text."""
    from tinyedm_tpu_torch.collective_audit import audit, report

    result = audit(device="cpu", **kwargs)
    return {**result, "report": report(result)}


def many(rank: int, size: int, calls: list) -> list:
    """Several tasks, (name, args) each, in one group: one spawn for all."""
    return [globals()[task](rank, size, **args) for task, args in calls]
