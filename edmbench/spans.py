"""The program's spans on the device trace's clock: a cell's time and
launches by phase (forward, backward, optimizer; denoiser, solver loop).

    python3 edmbench/spans.py --workload <cell> --seed <n> [--seconds <s>] [--units <k>]

sets the cell up as ``run.py`` does, runs its units for ``--seconds`` (10 by
default), then profiles ``--units`` more (``UNITS`` times the cell's
``trace_units`` by default) twice: with the card's activity alone, as a
traced run's device-only profile, and with the host's ``record_function``
ranges as well (no operator), which slows the host little more. It prints
one line of JSON: both profiles' seconds a unit, the phases' per-unit
numbers (``PHASES``) and the per-span table. It checks nothing; ``run.py``
does. ``charge`` puts every instant of the card's timeline, from the
stretch's first operation to its last, under one of the program's spans
(``tinyedm.`` ...), or under ``outside``:

- a launch (any runtime call, on any thread) belongs to the innermost
  program span whose interval holds its start, read on the thread that holds
  the spans: the backward's kernels are launched from the autograd engine's
  thread while the calling thread waits inside the backward's span; the
  device operation it starts (same correlation id) belongs there too;
- a busy instant goes to the span of the operation running then (the
  earliest to start, where operations overlap);
- an idle gap of ``g`` us, ended by an operation whose launch call started
  at host time ``b``, goes to the spans the host's thread was in over
  ``[b - g, b]``, innermost first: the card was waiting for that host work.
  The solver's Python between two denoiser calls thus falls to the solver,
  not to the next call's span. Only the gap's length is read on the card's
  clock, so the clocks' drift (below) moves nothing but that length;
- operations launched outside every program span (the harness's feed, the
  uint8 mapping, the copies to the host), and host time outside them, go to
  ``outside``.

Every instant is charged once, so the charges sum to the device's window. A
span's own charge leaves out its children's; its whole charge holds them. So
does its time on the host's clock (the span's interval less its children's).

Only the launch calls are placed on the host's clock. The card's operations
are placed by their correlation ids and ordered on the card's own clock,
which the profiler converts to the host's with an error that grows across a
stretch (up to 12 ms over a 2.9 s Heun batch on an H100 80GB HBM3, either
way): the device's window is therefore its first operation to its last, not
the host's span, and the profile runs idle for a while before and after the
units, so that no operation falls outside the profiler's own capture window
and is lost.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

if __package__ in (None, ""):  # run as a file: the checkout's root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from edmbench import run  # noqa: E402
from edmbench.harness import Layout  # noqa: E402
from edmbench.trace import LAUNCHES, WINDOW, Event, events_of  # noqa: E402

PREFIX = "tinyedm."
OUTSIDE = "outside"
# idle seconds profiled before and after the units (the clocks' error above)
PAD_S = (0.1, 0.5)
# the units profiled by default, as a multiple of the job's ``trace_units``
UNITS = 3
# the per-unit numbers printed: (name, span, what): the span's ms charged
# (children held) a unit or an instance, its launch calls (children held) a
# unit, or its own time on the host's clock a unit (in a host-bound loop the
# host's work is the cost, even where the card meanwhile runs queued work and
# so waits on another span's host time)
PHASES = [
    ("forward_ms", "tinyedm.train_step.forward", "ms"),
    ("backward_ms", "tinyedm.train_step.backward", "ms"),
    ("optimizer_ms", "tinyedm.train_step.optimizer", "ms"),
    ("optimizer_launches", "tinyedm.train_step.optimizer", "launches"),
    ("denoise_ms_each", "tinyedm.solve.denoise", "ms_each"),
    ("solver_host_ms", "tinyedm.solve", "host_ms"),
]


@dataclasses.dataclass
class Charge:
    us: float = 0.0  # the device timeline charged
    busy_us: float = 0.0  # of which an operation ran
    launches: int = 0  # launch calls
    host_us: float = 0.0  # the span's own time on the host's clock

    def add(self, other: "Charge") -> None:
        self.us += other.us
        self.busy_us += other.busy_us
        self.launches += other.launches
        self.host_us += other.host_us

    def row(self) -> list:
        return [round(self.us / 1e3, 3), round(self.busy_us / 1e3, 3), self.launches, round(self.host_us / 1e3, 3)]


@dataclasses.dataclass
class Spans:
    units: int  # the units profiled
    window_us: float  # the card's first operation to its last
    host_window_us: float  # the harness's window span, on the host's clock
    lost: int  # launch calls in the host's window whose operation the profile lacks
    own: dict[str, Charge]  # by span name (and OUTSIDE): children left out
    whole: dict[str, Charge]  # by span name (and OUTSIDE): children held
    count: dict[str, int]  # instances by span name

    def table(self) -> dict[str, dict]:
        """Per name, own and whole: [ms charged, busy ms, launches, ms on the
        host's clock]; and the instances."""
        return {name: {"own": c.row(), "whole": self.whole[name].row(), "n": self.count.get(name, 0)}
                for name, c in sorted(self.own.items())}


def profiled_spans(job, first: int, units: int) -> list[Event]:
    """``units`` units from ``first`` under a profile of the card's activity
    and the host's ``record_function`` ranges, closed by the harness's window
    span and a fence; the profile's events."""
    import torch
    from torch._C._profiler import RecordScope
    from torch.autograd import profiler

    on_card = job.dev.type == "cuda"
    prof = profiler.profile(use_device="cuda" if on_card else None, use_kineto=True)
    config, activities = prof.config(create_trace_id=True), prof.kineto_activities
    profiler._prepare_profiler(config, activities)
    profiler._enable_profiler(config, activities, {RecordScope.USER_SCOPE})
    try:
        time.sleep(PAD_S[0])
        with torch.profiler.record_function(WINDOW):
            last = None
            for i in range(units):
                last = job.unit(first + i)
            job.fence(last)
            if on_card:
                torch.cuda.synchronize()
        time.sleep(PAD_S[1])
    finally:
        results = profiler._disable_profiler()
    return events_of(results)


def _innermost(spans: list[Event]):
    """A lookup from a time to the innermost of ``spans`` (nested on one
    thread) that holds it: (the boundaries, the span index after each), and
    each span's parent index (-1: none)."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i].start, -spans[i].end))
    parent = [-1] * len(spans)
    edges, owner, stack = [], [], []
    for i in order:
        s = spans[i]
        while stack and spans[stack[-1]].end <= s.start:
            top = stack.pop()
            edges.append(spans[top].end)
            owner.append(stack[-1] if stack else -1)
        parent[i] = stack[-1] if stack else -1
        stack.append(i)
        edges.append(s.start)
        owner.append(i)
    while stack:
        top = stack.pop()
        edges.append(spans[top].end)
        owner.append(stack[-1] if stack else -1)
    return edges, owner, parent


def charge(events: list[Event], units: int = 1) -> Spans:
    """Reduce the spans profile's events (``profiled_spans``, ``units``
    units) to the charges by span (module docstring)."""
    windows = [e for e in events if e.kind == "span" and e.name == WINDOW and e.thread != -1]
    if len(windows) != 1:
        raise RuntimeError(f"expected one {WINDOW} span in the profile, found {len(windows)}")
    w0, w1, host = windows[0].start, windows[0].end, windows[0].thread
    spans = [e for e in events if e.kind == "span" and e.name.startswith(PREFIX) and e.thread == host]
    edges, owner, parent = _innermost(spans)

    def at(t: float) -> int:
        i = bisect.bisect_right(edges, t) - 1
        return owner[i] if i >= 0 else -1

    own = defaultdict(Charge)  # by span index, -1 for outside

    def idle(t0: float, t1: float) -> None:
        """Charge the host's time from t0 to t1 to the spans it was in."""
        j = bisect.bisect_right(edges, t0) - 1
        while t0 < t1:
            end = min(edges[j + 1], t1) if j + 1 < len(edges) else t1
            own[owner[j] if j >= 0 else -1].us += end - t0
            t0, j = end, j + 1

    runtime = [e for e in events if e.kind == "runtime"]
    called = {e.correlation: e.start for e in runtime}  # a device operation's runtime call, on the host's clock
    device = sorted(((e.start, e.end, called.get(e.correlation)) for e in events if e.kind == "device"),
                    key=lambda d: d[:2])
    ran = {e.correlation for e in events if e.kind == "device"}
    lost = 0
    for e in runtime:
        if e.name.startswith(LAUNCHES) and w0 <= e.start <= w1:
            own[at(e.start)].launches += 1
            lost += e.correlation not in ran
    d0 = cursor = device[0][0] if device else 0.0
    for start, end, b in device:
        i = -1 if b is None else at(b)
        if start > cursor:  # idle: waiting for the host's work up to this operation's call
            if b is None:
                own[i].us += start - cursor
            else:
                idle(b - (start - cursor), b)
            cursor = start
        if end > cursor:
            own[i].us += end - cursor
            own[i].busy_us += end - cursor
            cursor = end

    own[-1].host_us += w1 - w0  # a span's host time, less its children's, or the window's outside them
    for i, s in enumerate(spans):
        own[i].host_us += s.end - s.start
        own[parent[i]].host_us -= s.end - s.start

    by_name, whole, count = defaultdict(Charge), defaultdict(Charge), defaultdict(int)
    for i, s in enumerate(spans):
        count[s.name] += 1
        by_name[s.name].add(own.get(i, Charge()))
    by_name[OUTSIDE].add(own[-1])
    whole[OUTSIDE].add(own[-1])
    for i in range(len(spans)):
        names, j = set(), i
        while j != -1:
            names.add(spans[j].name)
            j = parent[j]
        for name in names:
            whole[name].add(own.get(i, Charge()))
    return Spans(units, cursor - d0, w1 - w0, lost, dict(by_name), dict(whole), dict(count))


def phases(found: Spans) -> dict[str, float]:
    """``PHASES``' numbers, those whose span the profile holds (and for a
    charge or a count, those whose span was charged some of the card's time)."""
    out = {}
    for key, name, what in PHASES:
        if not found.count.get(name) or (what != "host_ms" and not found.whole[name].us):
            continue
        whole = found.whole[name]
        out[key] = {"ms": whole.us / 1e3 / found.units, "ms_each": whole.us / 1e3 / found.count[name],
                    "launches": whole.launches / found.units,
                    "host_ms": found.own[name].host_us / 1e3 / found.units}[what]
    return out


def main(argv=None, layout: Layout = Layout(), device=None) -> int:
    """The CLI (module docstring). ``device`` is for tests alone, as in
    ``run.main``."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=10.0, help="units run before the profiles")
    parser.add_argument("--units", type=int, default=0, help="units a profile (default: UNITS x trace_units)")
    args = parser.parse_args(argv)
    cell = layout.cell(args.workload)
    run.environment(layout.root)

    import torch

    torch.set_num_threads(1)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"spans: {args.workload} needs {cell['chips']} CUDA card(s)", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    job = layout.kind(cell["kind"]).setup(run.Context(layout, args.workload, args.seed, device))
    first = job.first_unit
    units, seconds, _ = run.window(job, args.seconds, first)
    n = args.units or UNITS * job.trace_units
    job.trace_units = n  # the device-only profile's units: as many as the spans profile's
    plain = run.profiled(job, first + units, ops=False)
    found = charge(profiled_spans(job, first + units + n, n), n)
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
        "units": n, "unit_s": seconds / units, "device_profile_unit_s": plain.window_us / 1e6 / n,
        "device_profile_busy_s": plain.busy_us / 1e6 / n, "device_profile_launches": plain.launches / n,
        "spans_profile_unit_s": found.host_window_us / 1e6 / n, "device_window_unit_s": found.window_us / 1e6 / n,
        "lost_launches": found.lost, "phases": phases(found), "spans": found.table()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
