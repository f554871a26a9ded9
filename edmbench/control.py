"""The readings the limits of ``correct`` are set from, on the card.

    python3 edmbench/control.py --workload <cell> --seeds 1 2 ... --control-seeds 1 2 3

For each seed, in one process: the cell's set-up and its checked units (the
train kind's first steps; the heun kind's checked batches through the
timed path), the program's state freed, the fp32 reference, and the gaps
the check compares (the lower readings). For each control seed also the
control, the reference one precision lower than the configuration states
(fp8), against the fp32 reference (the upper readings), and for the train
kind the fault of half of each microbatch left out, the mean taken over the
rest. Prints one JSON line per seed; the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from edmbench.harness import Layout, sample_gaps, train_gaps  # noqa: E402
from edmbench.run import Context  # noqa: E402


def readings(layout: Layout, workload: str, seed: int, control: bool, device, raw: dict = None) -> dict:
    """The gaps of the program (and with ``control``, of the control and the
    faults) against the reference on ``seed``; ``raw`` collects what they
    were computed from."""
    import torch

    ctx = Context(layout, workload, seed, device)
    job = layout.kind(ctx.cell["kind"]).setup(ctx)
    out, raw = {"seed": seed}, raw if raw is not None else {}
    if ctx.cell["kind"] == "train":
        job.release()
        sides = {"program": job.readings, "reference": job.reference()}
        if control:
            sides["control"] = job.reference("fp8")
            sides["half_batch"] = job.reference(half_batch=True)
        for name, r in sides.items():
            raw[name] = dataclasses.asdict(r)
            if name != "reference":
                out[name] = train_gaps(r, sides["reference"])
    else:
        for i in range(job.check_batches):
            job.unit(i)
        job.release()
        batches = sorted(job.kept)
        x_ref, u8_ref = job.reference(batches)
        sides = {"program": (torch.cat([job.kept[i][0] for i in batches]),
                             torch.cat([job.kept[i][1] for i in batches]))}
        if control:
            sides["control"] = job.reference(batches, "fp8")
        for name, (x, u8) in sides.items():
            out[name] = sample_gaps(x, x_ref, u8, u8_ref)
            raw[name] = [sample_gaps(x[i:i + 1], x_ref[i:i + 1], u8[i:i + 1], u8_ref[i:i + 1])
                         for i in range(x.shape[0])]
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
    parser.add_argument("--raw", type=Path, default=None, help="a JSON-lines file for the raw readings")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    layout = Layout()
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        t = time.perf_counter()
        raw = {}
        r = readings(layout, args.workload, seed, seed in args.control_seeds, device, raw)
        r["seconds"] = time.perf_counter() - t
        print(json.dumps({"workload": args.workload, **r}), flush=True)
        if args.raw is not None:
            with args.raw.open("a") as f:
                f.write(json.dumps({"workload": args.workload, "seed": seed, **raw}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
