"""Training CLI of the port: ``python -m tinyedm_tpu_torch.train --config-name=cifar10``.

Counterpart of ``experiments/train.py``, with its surface: ``--config-name``
picks ``<config-path>/<name>.yaml`` (``experiments/conf`` by default, read by
the port's own YAML reader), trailing ``key=value`` arguments are dotted
overrides (interpolations resolve after them, so overriding a source reaches
its references), ``--resume`` continues from the latest checkpoint in the
run's ``out_dir`` and ``--max-epochs`` replaces ``trainer.max_epochs``.
``--device`` picks the device: the card by default, ``cpu`` when asked for.
``--multihost`` joins the process group that ``torchrun`` (``python -m
torch.distributed.run``) describes in the environment, where the JAX CLI
calls ``jax.distributed.initialize()``: NCCL on the cards (each rank on
``cuda:LOCAL_RANK``), gloo with ``--device cpu``; every data rank trains on
its share of each global batch, ``trainer.zero1: true`` shards the Adam
moments and EMA trees over the data ranks, and ``trainer.model_parallel: N``
shards every weight-normed kernel's output channels over model groups of N
ranks (tensor parallelism; a world N does not divide raises ``ValueError``).

``trainer.accumulate_grad_batches`` splits the step batch (the datamodule's
``batch_size``) into that many equal microbatches, as the JAX driver does. A
batch it does not split raises before the trainer is built, with the
override that gives Lightning's reading (that many microbatches of the
batch): ``imagenet.yaml`` needs ``datamodule.batch_size=528``. Examples:

    python -m tinyedm_tpu_torch.train --config-name=smoke --device cpu
    python -m tinyedm_tpu_torch.train --config-name=cifar10 \\
        datamodule.data_dir=/data/cifar10   # holds cifar-10-batches-py/
    python -m tinyedm_tpu_torch.train --config-name=cifar10 --resume --max-epochs 300 \\
        datamodule.data_dir=/data/cifar10
    python -m torch.distributed.run --nproc_per_node 8 -m tinyedm_tpu_torch.train \\
        --config-name=cifar10 --multihost datamodule.data_dir=/data/cifar10
    python -m torch.distributed.run --nproc_per_node 2 -m tinyedm_tpu_torch.train \\
        --config-name=imagenet512 --multihost trainer.model_parallel=2 \\
        datamodule.data_file=store.latpack
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

import torch

from tinyedm_tpu_torch.config.registry import apply_overrides, deinstantiate, instantiate, load_config

CONFIG_PATH = Path(__file__).resolve().parents[1] / "experiments" / "conf"


def check_accumulation(batch_size: int, accum_steps: int) -> None:
    """Raise where ``accum_steps`` does not split the step batch into equal
    microbatches, naming the batch of Lightning's reading (``accum_steps``
    microbatches of ``batch_size``)."""
    if batch_size % accum_steps:
        raise ValueError(
            f"a batch of {batch_size} does not split into {accum_steps} equal microbatches "
            f"(trainer.accumulate_grad_batches={accum_steps}, datamodule.batch_size={batch_size}); "
            f"for Lightning's reading, {accum_steps} microbatches of {batch_size}, pass "
            f"datamodule.batch_size={accum_steps * batch_size}"
        )


def main(argv: Optional[list[str]] = None):
    """Train as the command line says; returns the ``Trainer`` after ``fit``."""
    parser = argparse.ArgumentParser(description="Train an EDM diffusion model with the PyTorch port")
    parser.add_argument("--config-name", required=True, help="<config-path>/<name>.yaml")
    parser.add_argument("--config-path", default=str(CONFIG_PATH))
    parser.add_argument("--resume", action="store_true", help="resume from the latest checkpoint")
    parser.add_argument("--max-epochs", type=int, default=None)
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    parser.add_argument("--multihost", action="store_true",
                        help="join the process group of torchrun's environment (one process per GPU)")
    parser.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = parser.parse_args(argv)

    cfg = load_config(Path(args.config_path) / f"{args.config_name}.yaml", resolve=not args.overrides)
    if args.overrides:
        cfg = apply_overrides(cfg, args.overrides)
    if args.max_epochs is not None:
        cfg["trainer"]["max_epochs"] = args.max_epochs

    if args.multihost:
        from tinyedm_tpu_torch.parallel.mesh import init_distributed

        on_cpu = args.device is not None and torch.device(args.device).type == "cpu"
        init_distributed(backend="gloo" if on_cpu else None)
    try:
        return _train(args, cfg)
    finally:
        if args.multihost:
            torch.distributed.destroy_process_group()


def _train(args: argparse.Namespace, cfg: dict):
    from tinyedm_tpu_torch.training.trainer import Trainer
    from tinyedm_tpu_torch.utils.cuda import resolve_device
    from tinyedm_tpu_torch.utils.logging import MetricLogger

    device = resolve_device(args.device)
    seed = cfg.get("seed", 42)
    tcfg = cfg.get("trainer", {})
    # wandb.watch(model, log="all") of the reference: grad/param norms from the step
    watch_cfg = cfg.get("wandb_watch") or {}
    spec = instantiate(
        cfg["model"],
        accum_steps=tcfg.get("accumulate_grad_batches", 1),
        log_norms=bool(watch_cfg.get("enabled", bool(watch_cfg))),
        log_norms_per_layer=bool(watch_cfg.get("per_layer", False)),
    )
    datamodule = instantiate(cfg["datamodule"])
    if hasattr(datamodule, "seed"):
        datamodule.seed = seed
    check_accumulation(datamodule.batch_size, spec.accum_steps)

    callbacks = []
    ckpt_cfg = {}
    for name, cb_cfg in (cfg.get("callbacks") or {}).items():
        if name == "checkpoint_callback":
            ckpt_cfg = cb_cfg or {}
        elif cb_cfg and "_target_" in cb_cfg:
            callbacks.append(instantiate(cb_cfg))

    wandb_cfg = cfg.get("wandb_logger") or {}
    out_dir = tcfg.get("out_dir", f"runs/{args.config_name}")
    logger = MetricLogger(
        out_dir,
        use_wandb=bool(wandb_cfg.get("enabled", False)),
        wandb_kwargs={k: v for k, v in wandb_cfg.items() if k != "enabled"},
    )
    trainer = Trainer(
        spec=spec,
        datamodule=datamodule,
        max_epochs=tcfg.get("max_epochs", 1),
        check_val_every_n_epoch=tcfg.get("check_val_every_n_epoch", 10),
        callbacks=callbacks,
        logger=logger,
        out_dir=out_dir,
        ckpt_every_n_epochs=ckpt_cfg.get("every_n_epochs", 100),
        ckpt_top_k=ckpt_cfg.get("save_top_k", 3),
        ckpt_save_last=ckpt_cfg.get("save_last", True),
        ckpt_monitor=ckpt_cfg.get("monitor", "val_loss"),
        ckpt_mode=ckpt_cfg.get("mode", "min"),
        log_every_n_steps=tcfg.get("log_every_n_steps", 50),
        seed=seed,
        config={"model": deinstantiate(spec), "seed": seed},
        zero1=bool(tcfg.get("zero1", False)),
        model_parallel=int(tcfg.get("model_parallel", 1)),
        device_preprocess=bool(tcfg.get("device_preprocess", False)),
        device=device,
    )
    name = f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""
    print(f"device: {device}{name}", flush=True)
    try:
        trainer.fit(resume=args.resume)
    finally:
        logger.close()
    return trainer


if __name__ == "__main__":
    main()
