"""Run one cell of the port's benchmark once and print its result line.

    python3 edmbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's file (``edmbench/workloads/<cell>.json``) names its
configuration, its traffic kind and their parameters, and the limits of
``correct``; ``BENCHMARK.json`` names the metrics it reports. Set-up (the
imports, the weights drawn on the card, the inputs drawn on the host from
the seed, the cell's own shapes warmed up) is ``setup_s``. The window then
runs the kind's units (train steps, sampling batches) until ``--seconds``
have passed and fences the last: the rate is all the window's items over all
its time, the peak is the card's allocator peak over it. With ``--trace 1``
the window is followed by ``trace_units`` units under ``torch.profiler``,
which the per-layer metrics read (``edmbench/metrics/<name>.py``). Then the
program's state is freed and the plain reference checks what the timed path
produced. The last line of standard output is the result; the compared
numbers, each with its limit, are the last lines of standard error.

Needs as many CUDA cards as the cell asks for; without them it exits with
an error and prints no result. Nothing it runs imports JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

if __package__ in (None, ""):  # run as a file: the checkout's root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from edmbench.harness import Layout  # noqa: E402

# top-level module names that may not be loaded (compared whole: the port's
# name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "tinyedm_tpu")
GIB = 2 ** 30


def process_start() -> float:
    """The wall-clock time this process started, from /proc (Linux)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list[str]:
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


def environment(root: Path) -> None:
    """Before torch is imported: every compile cache at a fixed path inside
    the checkout (the port's own CUDA libraries are built into its package's
    ``build/``), and one host thread for CPU-side math: the cells are bound
    by the host's dispatch, and pool threads on a shared host only add noise."""
    cache = root / ".edmbench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")


def reports(metric: dict, workload: str, end_to_end: set) -> bool:
    """Whether a cell reports a metric: the cells its ``workloads`` list, or
    without one, every cell (an end-to-end metric) or every cell that
    reports the end-to-end metric it ``moves`` (a per-layer one)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in end_to_end


class Context:
    def __init__(self, layout: Layout, workload: str, seed: int, device):
        self.layout = layout
        self.workload = workload
        self.cell = layout.cell(workload)
        self.config = layout.config(self.cell["config"])
        self.seed = seed
        self.device = device


class Run:
    """What a per-layer metric's ``read(run)`` is given."""

    def __init__(self, job, unit_s: float, trace):
        self.work = job.work  # flops, attention_bound_s, conv_bound_s, forwards: per unit
        self.unit_s = unit_s  # the window's seconds per unit, profiler off
        self.trace = trace  # edmbench.trace.Trace of the profiled units
        self.units = job.trace_units


def window(job, seconds: float, first: int) -> tuple[int, float, list[float]]:
    """Run units from ``first`` until ``seconds`` have passed, fence the
    last; (units run, seconds to the fence, the host's clock after each
    unit was handed over)."""
    n, last, marks = 0, None, []
    t0 = time.perf_counter()
    while True:
        last = job.unit(first + n)
        n += 1
        marks.append(time.perf_counter() - t0)
        if marks[-1] >= seconds:
            break
    job.fence(last)
    return n, time.perf_counter() - t0, marks


def profiled(job, first: int, ops: bool):
    """``job.trace_units`` units from ``first`` under the profiler, closed
    by a fence: the device's activity alone, or with ``ops`` the host's
    operators too, inside one span; the stretch's trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from edmbench import trace

    on_card = job.dev.type == "cuda"
    activities = ([ProfilerActivity.CPU] if ops or not on_card else []) + (
        [ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            last = None
            for i in range(job.trace_units):
                last = job.unit(first + i)
            job.fence(last)
            if on_card:
                torch.cuda.synchronize()
    return trace.extract(trace.events_of(prof.profiler.kineto_results), ops or not on_card)


def main(argv=None, layout: Layout = Layout(), device=None) -> int:
    """The CLI. ``device`` is for tests alone: a device to run on without
    the look for cards (the CLI never passes one)."""
    t_start = process_start()
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = layout.cell(args.workload)
    environment(layout.root)

    import torch

    torch.set_num_threads(1)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"edmbench: {args.workload} needs {cell['chips']} CUDA card(s), found {found}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    on_card = device.type == "cuda"

    bench = layout.benchmark()
    ctx = Context(layout, args.workload, args.seed, device)
    kind = layout.kind(cell["kind"])
    t_job = time.time()
    job = kind.setup(ctx)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    first = job.first_unit
    setup_s = time.time() - t_start
    units, seconds, marks = window(job, args.seconds, first)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    result_trace = ops_trace = None
    t_trace = time.perf_counter()
    if args.trace:
        result_trace = profiled(job, first + units, ops=False)
        ops_trace = profiled(job, first + units + job.trace_units, ops=True)
        result_trace.conv_us = ops_trace.conv_us
    t_check = time.perf_counter()
    checks = job.check()
    print("units: " + " ".join(f"{b - a:.4f}" for a, b in zip([0.0] + marks, marks)), file=sys.stderr)
    parts = ", ".join(f"{k} {v:.3f}" for k, v in job.setup_parts.items())
    print(f"timing: setup {setup_s:.3f} s (before the cell's set-up {t_job - t_start:.3f}; {parts}), window {seconds:.3f} s for {units} units ({kind.UNIT}), "
          f"trace {t_check - t_trace:.3f} s, check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"edmbench: the run loaded {found}, which the port's benchmark may not", file=sys.stderr)
        return 3

    metrics = {}
    if args.trace:
        run = Run(job, seconds / units, result_trace)
        reported = {m["name"] for m in bench["end_to_end"] if reports(m, args.workload, set())}
        for m in bench["per_layer"]:
            if not reports(m, args.workload, reported):
                continue
            value = layout.metric(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {cell["rate_metric"]: units * job.items_per_unit / seconds,
                  "peak_mem_gib": peak / GIB, "setup_s": setup_s}
        for m in bench["end_to_end"]:
            if reports(m, args.workload, set()):
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    result = {
        "correct": all(c.ok for c in checks),
        "attempted": units * job.items_per_unit,
        "failed": 0,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else device.type,
            "kind": torch.cuda.get_device_name(device) if on_card else device.type,
            "count": cell["chips"],
            "memory_peak_bytes": int(peak),
        },
    }
    if args.trace:
        from edmbench.trace import top

        result["device"]["busy_s"] = result_trace.busy_us / 1e6
        result["device"]["window_s"] = result_trace.window_us / 1e6
        result["breakdown"] = {"device_ops": top(result_trace.groups()),
                               "idle_gaps": top(ops_trace.gaps)}
        print("trace: " + json.dumps({
            "units": job.trace_units, "unit_s": seconds / units,
            "profiled_unit_s": result_trace.window_us / 1e6 / job.trace_units,
            "ops_profiled_unit_s": ops_trace.window_us / 1e6 / job.trace_units,
            "groups_s": top(result_trace.groups(), 20), "launches": result_trace.launches,
            "idle_gaps_by_runtime_call": top(result_trace.gaps), "conv_s": (ops_trace.conv_us or 0) / 1e6}))
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
