"""CUDA runtime settings for the port's entry points (the counterpart of
``tinyedm_tpu/utils/tpu.py``).

Entry points run on the card unless the caller asks for the CPU. There is no
silent fallback: asking for the default device on a machine without CUDA
raises.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device (raises without one);
    ``"cpu"`` only when asked for explicitly."""
    dev = torch.device("cuda" if device is None else device)
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
