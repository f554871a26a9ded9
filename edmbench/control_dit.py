"""The readings the limits of ``correct`` are set from, for a cell of the
``dit_train`` kind, on the card (``control.py`` reads the ``train`` and
``heun`` kinds):

    python3 edmbench/control_dit.py --workload <cell> --seeds 1 2 ... --control-seeds 1 2 3

For each seed, in one process: the cell's set-up and its checked steps, the
program's state freed, the fp32 reference, and the gaps the check compares
(the lower readings); for each control seed also the control, the
reference one precision lower than the configuration states (fp8), and the
fault of half of each microbatch left out, each against the fp32 reference
(the upper readings). Prints one JSON line per seed; the benchmark's own
runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from edmbench.harness import Layout, train_gaps  # noqa: E402
from edmbench.run import Context  # noqa: E402


def readings(layout: Layout, workload: str, seed: int, control: bool, device) -> dict:
    """The gaps of the program (and with ``control``, of the control and the
    half-batch fault) against the reference on ``seed``."""
    import torch

    ctx = Context(layout, workload, seed, device)
    job = layout.kind(ctx.cell["kind"]).setup(ctx)
    job.release()
    ref = job.reference()
    out = {"seed": seed, "program": train_gaps(job.readings, ref)}
    if control:
        out["control"] = train_gaps(job.reference("fp8"), ref)
        out["half_batch"] = train_gaps(job.reference(half_batch=True), ref)
    del job
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("control_dit: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    layout = Layout()
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t = time.perf_counter()
        r = readings(layout, args.workload, seed, seed in args.control_seeds, device)
        r["seconds"] = time.perf_counter() - t
        print(json.dumps({"workload": args.workload, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
