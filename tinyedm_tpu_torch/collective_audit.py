"""The collectives of a config's train step (and sampler) over ranks, as a
table of bytes moved.

Counterpart of ``experiments/collective_audit.py``. The JAX tool compiles
the step on a virtual CPU mesh and reads the collectives out of the HLO; the
port runs the step: it spawns ``--devices`` ranks that join one process
group on a ``data x model`` grid (``parallel/mesh.py``: ``init_distributed``,
``make_grid``, ``ParallelPlan``, ``shard_model`` under tensor parallelism),
builds the YAML's model at full width through ``config/registry.py``, and
runs one train step from seeded weights on a batch of zeros, and with
``--sampler`` one Heun-4 solve (7 forwards) from the EMA tree closed by a
barrier as ``generate`` closes, each inside ``collective_inventory()``.
Rank 0 prints, per program, the summary, the payload total, the ring
estimate of the bytes a rank puts on the wire (``parallel/audit.py::
wire_bytes``) beside the params' bytes, and one row per collective
(``format_inventory``). A collective inside the solver's Python loop is
recorded on every trip, so the sampler's numbers are per solve, where the
JAX tool prints its loop bodies once, "PER TRIP".

    python -m tinyedm_tpu_torch.collective_audit --config cifar10 --batch 32 --devices 8 \\
        --device cpu --backend gloo
    python -m tinyedm_tpu_torch.collective_audit --config cifar10 --devices 2 --model_parallel 2 --sampler

On the card (the default) the ranks take one card each over NCCL; asking for
more ranks than cards raises unless ``--backend gloo``, under which ranks
share the cards (host-staged: the bytes are a step's, the speed is not
NCCL's). The train step runs the cosine-attention kernels at each rank's
shapes (its heads under ``--model_parallel``); on the CPU their plain
versions.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import tempfile
import traceback
from datetime import timedelta
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from tinyedm_tpu_torch.parallel.audit import collective_inventory, format_inventory, inventory_summary, wire_bytes

CONFIG_PATH = Path(__file__).resolve().parents[1] / "experiments" / "conf"
HEUN_STEPS = 4  # the JAX tool's DeterministicSolver(num_steps=4)
SEED = 0  # the weights' and the step's draws
TIMEOUT = timedelta(minutes=30)  # the process group's, and the parent's wait for its ranks


def train_shapes(cfg: dict) -> tuple[int, int, Optional[int]]:
    """(image_size, in_channels, num_classes) of a loaded config
    (``experiments/_common.py::train_shapes``): latent data modules carry no
    image_size, and EDM2's latents are 64x64."""
    dm = cfg.get("datamodule", {})
    target = str(dm.get("_target_", "")).lower()
    size = int(dm.get("image_size", 64 if ("latents" in target or "latpack" in target) else 32))
    denoiser = cfg["model"].get("denoiser", cfg["model"])
    return size, int(denoiser.get("in_channels", 3)), cfg["model"].get("embedding", {}).get("num_classes")


def audit(config: str = "cifar10", batch: int = 32, model_parallel: int = 1, zero1: bool = False,
          sampler: bool = False, device: Optional[str] = None) -> dict:
    """One train step of ``experiments/conf/<config>.yaml``'s model (and with
    ``sampler`` one Heun-4 solve from its EMA tree) on this rank of the
    process group, ``model_parallel`` ranks to a model group, ``batch`` the
    global batch of zeros. Every rank must call it. Returns the collectives
    and rows 1-4 launches of each program on this rank, with what the
    report's header says."""
    from tinyedm_tpu_torch.config.registry import instantiate, load_config
    from tinyedm_tpu_torch.data.datamodules import to_device
    from tinyedm_tpu_torch.diffusion.solver import DeterministicSolver
    from tinyedm_tpu_torch.models.edm import init_weights
    from tinyedm_tpu_torch.ops import fused_attention
    from tinyedm_tpu_torch.parallel.mesh import ParallelPlan, barrier, distributed, make_grid, shard_batch
    from tinyedm_tpu_torch.parallel.tensor import shard_model
    from tinyedm_tpu_torch.training.train_step import init_train_state, make_train_step
    from tinyedm_tpu_torch.utils.cuda import resolve_device, step_generator

    dev = resolve_device(device)
    grid = make_grid(model_parallel)
    cfg = load_config(CONFIG_PATH / f"{config}.yaml")
    spec = instantiate(cfg["model"])
    model = spec.build_model()
    init_weights(model, torch.Generator().manual_seed(SEED))
    param_bytes = sum(p.numel() * 4 for p in model.parameters())
    shards = shard_model(model, grid)
    model.to(dev)
    opt_cfg, ema_cfg = spec.build_optimizer_config(), spec.build_ema_config()
    # the trainer's plan: under a process group, or for ZeRO-1's range update
    plan = ParallelPlan(dict(model.named_parameters()), zero1=zero1, sharded=shards) \
        if distributed() or zero1 else None
    state = init_train_state(model, opt_cfg, ema_cfg)
    if zero1:
        plan.place(state)
    step = make_train_step(model, spec.diffuser, opt_cfg, ema_cfg, plan=plan)

    size, channels, n_classes = train_shapes(cfg)
    images = np.zeros((batch, size, size, channels), np.float32)
    labels = np.zeros((batch,), np.int32) if n_classes else None
    x, y = to_device(*shard_batch((images, labels)), dev)  # this rank's rows, NCHW
    programs = []

    fused_attention.launch_counts.clear()
    with collective_inventory() as inv:
        state, _ = step(state, (x, y), step_generator(SEED, 0, dev, grid.data_rank, grid.data_size), 0)
    programs.append({"name": "train step", "inventory": inv, "launches": dict(fused_attention.launch_counts)})

    if sampler:
        fused_attention.launch_counts.clear()
        with torch.inference_mode(), collective_inventory() as inv:
            # from the EMA weights, as the generate CLI samples; ZeRO-1 keeps
            # a range of them and gathers them whole first
            tree = state.ema[0] if state.ema else state.params
            if zero1 and state.ema:
                tree = plan.gather(tree)
            weights = {**tree, **state.constants}
            DeterministicSolver(num_steps=HEUN_STEPS).solve(
                lambda xt, sigma, labs: torch.func.functional_call(model, weights, (xt, sigma, labs)),
                torch.zeros_like(x), y)
            barrier()
        programs.append({"name": f"sampler (Heun-{HEUN_STEPS}, {2 * HEUN_STEPS - 1} forwards)", "inventory": inv,
                         "launches": dict(fused_attention.launch_counts)})
    return {"config": config, "batch": batch, "data_size": grid.data_size, "model_size": grid.model_size,
            "zero1": bool(zero1), "device": str(dev),
            "backend": torch.distributed.get_backend() if distributed() else "none",
            "param_bytes": param_bytes, "rank_param_bytes": 4 * sum(p.numel() for p in state.params.values()),
            "programs": programs}


def report(result: dict) -> str:
    """Rank 0's text for ``audit``'s result: the header, then per program
    the summary, the payload total, the ring wire bytes a rank puts on the
    wire beside the params' bytes, the rows 1-4 launches and the table."""
    r = result
    lines = [f"config={r['config']} batch={r['batch']} grid={r['data_size']} x {r['model_size']} (data x model) "
             f"zero1={r['zero1']} params={r['param_bytes'] / 1e6:.2f} MB fp32 ({r['rank_param_bytes'] / 1e6:.2f} MB "
             f"a rank); {r['data_size'] * r['model_size']} ranks on {r['device']} over {r['backend']}"]
    for p in r["programs"]:
        inv = p["inventory"]
        per = "solve" if p["name"].startswith("sampler") else "step"
        launches = ", ".join(f"{d} n={n}: {c}" for (d, n), c in sorted(p["launches"].items()) if c)
        lines += [
            "",
            f"===== {p['name']} =====",
            f"summary: {inventory_summary(inv)}",
            f"payload total: {sum(c.bytes for c in inv) / 1e6:.2f} MB; ring-estimate wire bytes/rank/{per}: "
            f"{sum(wire_bytes(c) for c in inv) / 1e6:.2f} MB (params: {r['param_bytes'] / 1e6:.2f} MB fp32)",
            f"rows 1-4 kernel launches on rank 0: {'{' + launches + '}' if launches else 'none'}",
            format_inventory(inv),
        ]
    return "\n".join(lines)


def _rank(rank: int, size: int, store: str, out: str, backend: str, kwargs: dict) -> None:
    """A spawned rank: join the group, run ``audit``, save its result."""
    from tinyedm_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))
    local = rank % torch.cuda.device_count() if kwargs.get("device") != "cpu" else 0
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size), LOCAL_RANK=str(local))
    try:
        init_distributed(backend=backend, init_method=f"file://{store}", timeout=TIMEOUT)
        result = audit(**kwargs)
        torch.distributed.destroy_process_group()
        torch.save(result, out)
    except BaseException:
        Path(out + ".err").write_text(traceback.format_exc())
        raise


def run(ranks: int, backend: str, **kwargs) -> list[dict]:
    """``audit(**kwargs)`` on ``ranks`` spawned processes joined over
    ``backend`` (a file store in a temporary directory); their results in
    rank order. A rank that fails, or all not done within ``TIMEOUT``,
    raises with the ranks' tracebacks."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        outs = [str(Path(tmp) / f"rank{r}.pt") for r in range(ranks)]
        procs = [ctx.Process(target=_rank, args=(r, ranks, str(Path(tmp) / "store"), outs[r], backend, kwargs))
                 for r in range(ranks)]
        for p in procs:
            p.start()
        try:
            wait = TIMEOUT.total_seconds()
            for p in procs:
                p.join(wait)
                wait = 60.0  # the others end with the first, or soon after
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        errors = [Path(o + ".err").read_text() for o in outs if Path(o + ".err").exists()]
        if errors or any(p.exitcode != 0 for p in procs):
            raise RuntimeError(f"collective audit on {ranks} ranks: exit codes {[p.exitcode for p in procs]}\n"
                               + "\n".join(errors))
        return [torch.load(o, weights_only=False) for o in outs]


def parse_args(argv: Optional[list[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="cifar10", help="experiments/conf/<config>.yaml")
    ap.add_argument("--batch", type=int, default=32, help="the global batch")
    ap.add_argument("--devices", type=int, default=8, help="ranks")
    ap.add_argument("--model_parallel", type=int, default=1)
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--sampler", action="store_true", help="audit the Heun solve too")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="nccl on the card (one card a rank), gloo on the CPU")
    args = ap.parse_args(argv)
    if args.backend is None:
        args.backend = "nccl" if args.device == "cuda" else "gloo"
    if args.devices < 1 or args.devices % args.model_parallel:
        raise ValueError(f"--devices {args.devices} not divisible by --model_parallel {args.model_parallel}")
    if args.batch % (args.devices // args.model_parallel):
        raise ValueError(f"--batch {args.batch} not divisible by {args.devices // args.model_parallel} data ranks")
    if args.backend == "nccl":
        if args.device == "cpu":
            raise ValueError("--backend nccl needs --device cuda; the CPU's ranks join over gloo")
        cards = torch.cuda.device_count()
        if args.devices > cards:
            raise ValueError(f"--devices {args.devices} ranks over NCCL need {args.devices} cards, this machine has "
                             f"{cards}: pass --backend gloo to let ranks share the cards")
    elif args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to audit on the CPU")
    return args


def main(argv: Optional[list[str]] = None) -> str:
    args = parse_args(argv)
    results = run(args.devices, args.backend, config=args.config, batch=args.batch,
                  model_parallel=args.model_parallel, zero1=args.zero1, sampler=args.sampler, device=args.device)
    text = report(results[0])
    print(text, flush=True)
    return text


if __name__ == "__main__":
    main()
