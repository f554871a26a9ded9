"""The reduction of profiled stretches to what the per-layer metrics read.

A traced run profiles its units twice, from ``torch.profiler``'s raw
(kineto) events:

- with device activity alone (``extract(..., ops=False)``): kernels, copies
  and sets on the card and the CUDA runtime calls on the host, at a cost of
  a few microseconds a launch. Its window runs from its first event to its
  last, closed by a fence, and holds the busy time (the union of the
  device's operation intervals), the launch calls and the kernels' times;
- with the host's operators as well (``ops=True``), whose tracing slows
  the host several times over: the device time under the convolution
  operators, and what the host was doing in each idle gap.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Optional

WINDOW = "edmbench.window"
SPAN_PREFIX = "edmbench."
# the launch calls' names begin so (the runtime may add a version suffix)
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cuGraphLaunch")
CONV_OPS = ("aten::convolution", "aten::convolution_backward")
# kernel-name substrings -> group, first match wins; cuDNN's layout
# transforms ahead of the convolutions, whose names they would match
GROUPS = [
    ("layout transforms (cuDNN)", ("nchwtonhwc", "nhwctonchw")),
    ("block GEMMs (port's)", ("gemm::gemm_kernel", "gemm_tc::gemm_tc_kernel", "reduce_partials")),
    ("flash attention kernels", ("flash_",)),
    ("attention kernel", ("cosine_attention_fwd",)),
    ("attention bwd kernel", ("attn_bwd_",)),
    ("optimizer (foreach)", ("multi_tensor_apply", "foreach")),
    ("conv (cuDNN)", ("conv", "fprop", "implicit", "winograd", "dgrad", "wgrad")),
    ("gemm (cuBLAS)", ("gemm", "cutlass", "sm90_", "nvjet")),
    ("reduction", ("reduce",)),
    ("copy / cat / layout", ("copy", "cat", "transpose", "permute", "memcpy", "memset")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
]
# how many of the operators that started before an idle gap's middle are
# asked whether they still ran then (the backward's thread interleaves)
LOOKBACK = 64
# the port's attention kernels of rows 1-4 (csrc/cosine_attention_{fwd,bwd}.cuh)
ATTENTION_KERNELS = ("cosine_attention_fwd", "attn_bwd_dq", "attn_bwd_dkv")


@dataclasses.dataclass
class Trace:
    window_us: float
    busy_us: float
    launches: int
    device: list[tuple[str, float, float]]  # (name, start, end) inside the window, us
    gaps: dict[str, float]  # idle us by what the host was doing
    conv_us: Optional[float] = None  # device time under the convolution ops (ops=True)

    def device_us(self, substrings) -> float:
        return sum(e - s for n, s, e in self.device if any(k in n for k in substrings))

    def groups(self) -> dict[str, float]:
        out = defaultdict(float)
        for n, s, e in self.device:
            out[group_of(n)] += e - s
        return dict(out)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def union(intervals) -> list[tuple[float, float]]:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    kind: str  # "device", "runtime", "op" or "span"
    start: float  # us
    end: float
    thread: int
    correlation: int
    linked: int  # a kernel's launching operator's correlation id (0: none)


def _call(e, method: str, default):
    """A raw event's accessor where this PyTorch has it (older ones lack some)."""
    return getattr(e, method)() if hasattr(e, method) else default


def events_of(results) -> list[Event]:
    """Plain records of a profile's raw events (``prof.profiler.kineto_results``).
    The CUDA runtime's and driver's calls are known by their names (``cu``
    ...), the harness's spans by theirs (``edmbench.`` ...), where the
    event carries no kind."""
    from torch.autograd import DeviceType

    out = []
    for e in results.events():
        start = e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        activity, name = str(_call(e, "activity_type", "")).lower(), e.name()
        span = "annotation" in activity or _call(e, "is_user_annotation", False) or name.startswith(SPAN_PREFIX)
        if span:
            kind = "span"
        elif e.device_type() != DeviceType.CPU:
            kind = "device"
        elif "runtime" in activity or "driver" in activity or name.startswith("cu"):
            kind = "runtime"
        else:
            kind = "op"
        thread = e.start_thread_id() if kind != "span" or e.device_type() == DeviceType.CPU else -1
        out.append(Event(name, kind, start, end, thread, e.correlation_id(),
                         _call(e, "linked_correlation_id", 0)))
    return out


def _outermost(events: list[Event]) -> list[Event]:
    """Those of ``events`` that no other of them contains on the same thread."""
    out, by_thread = [], defaultdict(list)
    for e in events:
        by_thread[e.thread].append(e)
    for evs in by_thread.values():
        end = float("-inf")
        for e in sorted(evs, key=lambda e: (e.start, -e.end)):
            if e.start >= end:
                out.append(e)
                end = e.end
    return out


def _within(points: list[Event], spans: list[Event]) -> list[Event]:
    """The ``points`` that lie inside one of ``spans`` on the same thread
    (``spans`` do not overlap on a thread)."""
    by_thread = defaultdict(list)
    for s in sorted(spans, key=lambda s: s.start):
        by_thread[s.thread].append(s)
    starts = {t: [s.start for s in ss] for t, ss in by_thread.items()}
    out = []
    for p in points:
        ss = by_thread.get(p.thread)
        if ss:
            i = bisect.bisect_right(starts[p.thread], p.start) - 1
            if i >= 0 and p.end <= ss[i].end:
                out.append(p)
    return out


def extract(events: list[Event], ops: bool) -> Trace:
    """The stretch's trace. With ``ops`` the profile holds the host's
    operators and one ``WINDOW`` span, which is the window; without, the
    window runs from the first event to the last."""
    spans = [e for e in events if e.kind == "span" and e.name == WINDOW and e.thread != -1]
    if ops:
        if len(spans) != 1:
            raise RuntimeError(f"expected one {WINDOW} span in the profile, found {len(spans)}")
        w0, w1 = spans[0].start, spans[0].end
    else:
        w0, w1 = min(e.start for e in events), max(e.end for e in events)
    device = [(e.name, max(e.start, w0), min(e.end, w1)) for e in events
              if e.kind == "device" and e.end > w0 and e.start < w1]
    busy = union((s, e) for _, s, e in device)
    runtime = [e for e in events if e.kind == "runtime" and w0 <= e.start and e.end <= w1]
    launches = [e for e in runtime if e.name.startswith(LAUNCHES)]
    conv_us = None
    if ops:
        convs = _outermost([e for e in events if e.kind == "op" and e.name in CONV_OPS])
        # a kernel is a convolution's where its launch call, or the operator
        # that launched it, lies inside a convolution operator
        ids = {e.correlation for e in _within(launches, convs)}
        ops_in = {e.correlation for e in _within([e for e in events if e.kind == "op"], convs)}
        conv_us = sum(e.end - e.start for e in events if e.kind == "device"
                      and (e.correlation in ids or (e.linked and e.linked in ops_in)))
        hosts = _outermost([e for e in events if e.kind == "op" and w0 <= e.start and e.end <= w1])
        label = "between ops"
    else:
        hosts = runtime
        label = "between launches"
    hosts.sort(key=lambda e: e.start)
    starts = [e.start for e in hosts]
    harness = sorted((e for e in events if e.kind == "span" and e.name.startswith(SPAN_PREFIX)
                      and e.name != WINDOW and e.thread != -1 and w0 <= e.start), key=lambda e: e.start)
    gaps = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, e in zip(edges[::2], edges[1::2]):
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        what = label
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - LOOKBACK, -1), -1):
            if hosts[j].end >= mid:
                what = hosts[j].name
                break
        span = next((h.name for h in reversed(harness) if h.start <= mid <= h.end), None)
        gaps[f"{span.removeprefix(SPAN_PREFIX)}: {what}" if span else what] += e - s
    return Trace(w1 - w0, sum(e - s for s, e in busy), len(launches), device, dict(gaps), conv_us)


def top(values: dict[str, float], n: int = 10) -> list[list]:
    """The ``n`` largest entries as [name, seconds] pairs (values in us)."""
    return [[k, v / 1e6] for k, v in sorted(values.items(), key=lambda kv: -kv[1])[:n]]
