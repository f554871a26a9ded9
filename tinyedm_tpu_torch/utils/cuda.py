"""CUDA runtime settings for the port's entry points (the counterpart of
``tinyedm_tpu/utils/tpu.py``), and seeded generators on a device.

Entry points run on the card unless the caller asks for the CPU. There is no
silent fallback: asking for the default device on a machine without CUDA
raises.
"""

from __future__ import annotations

import os

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device (raises without one),
    under a process group ``cuda:LOCAL_RANK``, the rank's card; ``"cpu"``
    only when asked for explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev == torch.device("cuda") and torch.distributed.is_available() and torch.distributed.is_initialized():
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        set_precision()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def set_precision() -> None:
    """Real fp32 for fp32 work: cuBLAS defaults to full fp32 but cuDNN runs
    fp32 convolutions in TF32 unless told otherwise."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fold_seed(seed: int, index: int) -> int:
    """A 64-bit seed for the pair (seed, index), 0 <= both < 2**32: splitmix64
    of ``seed << 32 | index``, so that the low 32 bits, all that the CPU
    generator keeps, differ between pairs too."""
    if not (0 <= seed < 2**32 and 0 <= index < 2**32):
        raise ValueError(f"seed {seed} and index {index} must lie in [0, 2**32)")
    z = (((seed << 32) | index) + 0x9E3779B97F4A7C15) % 2**64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) % 2**64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) % 2**64
    return z ^ (z >> 31)


def folded_generator(seed: int, index: int, device: torch.device | str) -> torch.Generator:
    """A generator on ``device`` seeded with ``fold_seed(seed, index)``: the
    port's ``jax.random.fold_in(PRNGKey(seed), index)``, one stream per pair."""
    return torch.Generator(device=device).manual_seed(fold_seed(seed, index))


def step_generator(seed: int, step: int, device: torch.device | str, rank: int = 0,
                   world_size: int = 1) -> torch.Generator:
    """The generator of train step ``step``: ``folded_generator(seed, step)``
    with one data rank; over several, a stream of each data rank's own,
    folded from the step's seed and ``rank`` (the data rank of
    ``world_size`` data ranks), so that no two data ranks draw the same
    sigmas, noise or dropout bits and the ranks of a model group draw the
    same ones (a model group of one data rank draws one process's)."""
    if world_size == 1:
        return folded_generator(seed, step, device)
    return folded_generator(fold_seed(seed, step) % 2**32, rank, device)
