"""The collective inventory: what the port's data and tensor parallelism send.

Counterpart of ``tinyedm_tpu/parallel/audit.py``. The JAX package reads its
collectives out of the compiled HLO; the port has no compiled program to
read, so it records them as they are made: every collective of
``parallel.mesh`` goes through one wrapper, which reports its kind, payload
bytes, group ("world", "data" or "model") and group size to each inventory
open in this context. Nothing in torch is patched. The contract the tests
hold it to is the JAX package's (``tests/test_collective_audit.py``): a
data-parallel train step makes one all-reduce of about the parameter bytes,
ZeRO-1 adds one parameter-sized all-gather, validation reduces scalars only
and the data-parallel sampler makes no collective but a closing barrier;
under tensor parallelism a train step makes model-group all-reduces (the
activation gathers' backward) and a data-group gradient sync, sampling makes
model-group collectives, and no collective carries the parameter tree.

    with collective_inventory() as inv:
        state, metrics = train_step(state, batch, generator, count)
    inventory_summary(inv)  # {"all_reduce": {"count": 1, "bytes": ...}}
    print(format_inventory(inv))  # one row per collective
    sum(wire_bytes(c) for c in inv)  # what this rank puts on the wire (ring)

A collective made inside a Python loop (the sampler's Heun steps) is
recorded on every trip, so an inventory counts what a program sends, where
the JAX package's static HLO shows a loop body once
(``experiments/collective_audit.py``'s "PER TRIP").
"""

from __future__ import annotations

import contextlib
import dataclasses
from contextvars import ContextVar
from typing import Iterable, Iterator

# the inventories open in this context, innermost last
_open: ContextVar[tuple[list, ...]] = ContextVar("collective_inventories", default=())


@dataclasses.dataclass(frozen=True)
class Collective:
    kind: str  # "all_reduce", "all_gather" or "barrier"
    bytes: int  # payload: the reduced tensor, the gathered output; 0 for a barrier
    group_size: int  # ranks in the group
    dtype: str = ""  # the payload's element type ("" for a barrier)
    group: str = ""  # "world", "data" or "model"


def record(kind: str, nbytes: int, group_size: int, dtype: str = "", group: str = "") -> None:
    """Report one collective to every open inventory (``parallel.mesh``'s
    wrappers call this just before the collective)."""
    for inv in _open.get():
        inv.append(Collective(kind, int(nbytes), int(group_size), dtype, group))


@contextlib.contextmanager
def collective_inventory() -> Iterator[list[Collective]]:
    """A list that fills with the collectives made while the context is open,
    in program order."""
    inv: list[Collective] = []
    token = _open.set(_open.get() + (inv,))
    try:
        yield inv
    finally:
        _open.reset(token)


def open_inventories() -> tuple[list, ...]:
    """The inventories open in this context: what a backward, which autograd
    may run on another thread (its CUDA device thread), records into
    through ``recording_into``."""
    return _open.get()


@contextlib.contextmanager
def recording_into(inventories: tuple[list, ...]) -> Iterator[None]:
    """Record into ``inventories`` (``open_inventories()`` of another
    context) while the context is open."""
    token = _open.set(inventories)
    try:
        yield
    finally:
        _open.reset(token)


def inventory_summary(inv: Iterable[Collective]) -> dict[str, dict[str, int]]:
    """{kind: {"count": n, "bytes": payload}} over an inventory."""
    out: dict[str, dict[str, int]] = {}
    for c in inv:
        d = out.setdefault(c.kind, {"count": 0, "bytes": 0})
        d["count"] += 1
        d["bytes"] += c.bytes
    return out


def wire_bytes(c: Collective) -> float:
    """The bytes a rank puts on the wire for ``c`` under the ring algorithm
    (``experiments/collective_audit.py::_wire_bytes``): an all-reduce (a
    reduce-scatter and an all-gather) 2(n-1)/n of its payload, an
    all-gather (n-1)/n of the gathered output, a barrier none; n is the
    group size."""
    n = c.group_size
    if c.kind == "all_reduce":
        return c.bytes * 2 * (n - 1) / n
    if c.kind == "all_gather":
        return c.bytes * (n - 1) / n
    if c.kind == "barrier":
        return 0.0
    raise ValueError(f"no ring estimate for a collective of kind {c.kind!r}")


def format_inventory(inv: Iterable[Collective]) -> str:
    """A table of ``inv``, one row per collective in program order: kind,
    payload MB, group and its size, dtype (the JAX package's
    ``format_inventory``, for the port's records)."""
    lines = []
    for c in inv:
        group = f"{c.group or 'world'}[{c.group_size}]"
        lines.append(f"{c.kind:<12} {c.bytes / 1e6:>10.3f} MB  group={group:<10} {c.dtype or '-'}")
    if not lines:
        lines.append("(no collectives: single-device program)")
    return "\n".join(lines)
