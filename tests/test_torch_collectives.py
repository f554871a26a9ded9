"""The collective inventory of the port's data parallelism (``parallel.audit``)
held to the JAX package's contract (``tests/test_collective_audit.py``),
with ``param_bytes`` from the JAX model of the same config (the smoke
model). On 2 gloo ranks (``tests/_torch_dist_worker.py``):

- a data-parallel train step makes exactly one all-reduce, of all 2 ranks,
  whose payload lies in [param_bytes, 1.05 param_bytes + 1024], and no
  all-gather;
- a ZeRO-1 step makes all-reduces of [0.95, 1.10] param_bytes + 4096 bytes
  and all-gathers of [0.80, 1.05] param_bytes + 4096, and nothing else;
- validation reduces scalars only (one fp64 all-reduce of its sums); under
  ZeRO-1 it first gathers the EMA tree it evaluates;
- the data-parallel sampler (``generate``) makes no collective but the
  closing barrier.

Without a process group nothing is recorded; a one-rank process group
makes and records its sync, a one-rank group inside a larger world makes
none. The recorder itself: nested inventories and the summary.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from tests import _torch_dist_worker as worker
from tests.test_torch_dist_trainer import OPT, SCHED_COUNT, SIGMA_RELS, _batches, _start_tensors
from tests.test_torch_train_step import _jax_start
from tinyedm_tpu_torch.parallel.audit import (
    Collective,
    collective_inventory,
    inventory_summary,
    record,
)
from tinyedm_tpu_torch.parallel.mesh import ParallelPlan


@pytest.fixture(scope="module")
def inventories(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("inventories")
    start = _jax_start(torch.float32, tuple(sorted(OPT.items())))
    param_bytes = sum(np.asarray(x).size * 4 for x in jax.tree_util.tree_leaves(start.params))
    step = dict(start=_start_tensors(start), batches=_batches()[:1], opt=OPT, sigma_rels=SIGMA_RELS,
                sched_count=SCHED_COUNT)
    val = dict(val_rows=21)
    gen = dict(num_samples=7, image_size=16, batch_size=4, config="smoke", num_steps=2)
    ranks = worker.run("many", 2, tmp, calls=[
        ("train_steps", step), ("train_steps", {**step, "zero1": True}),
        ("validate", {**val, "out_dir": str(tmp / "dp")}),
        ("validate", {**val, "out_dir": str(tmp / "zero1"), "zero1": True}),
        ("generate", {**gen, "output_dir": str(tmp / "png")}),
    ])
    names = ("dp", "zero1", "val", "val_zero1", "sampler")
    out = {name: [[Collective(*c) for c in _inventory(r[i])] for r in ranks] for i, name in enumerate(names)}
    return out, param_bytes


def _inventory(result: dict) -> list:
    return result["inventories"][0] if "inventories" in result else result["inventory"]


def test_ranks_record_the_same_inventory(inventories):
    inv, _ = inventories
    for name, (a, b) in inv.items():
        assert a == b, name


def test_dp_step_is_exactly_one_gradient_allreduce(inventories):
    inv, param_bytes = inventories
    (ar,) = inv["dp"][0]
    assert (ar.kind, ar.group_size, ar.dtype) == ("all_reduce", 2, "float32")
    # every gradient (~param bytes, the alignment gaps included) and a few
    # scalars; below means a gradient skipped the sync
    assert param_bytes <= ar.bytes <= int(param_bytes * 1.05) + 1024, (ar.bytes, param_bytes)


def test_zero1_step_adds_one_param_sized_allgather(inventories):
    inv, param_bytes = inventories
    steps = inv["zero1"][0]
    assert {c.kind for c in steps} <= {"all_reduce", "all_gather"}
    s = inventory_summary(steps)
    assert s["all_reduce"]["count"] == s["all_gather"]["count"] == 1
    assert param_bytes * 0.95 <= s["all_reduce"]["bytes"] <= param_bytes * 1.10 + 4096
    assert param_bytes * 0.80 <= s["all_gather"]["bytes"] <= param_bytes * 1.05 + 4096
    assert all(c.group_size == 2 for c in steps)


def test_validation_reduces_only_scalars(inventories):
    inv, _ = inventories
    (ar,) = inv["val"][0]
    assert (ar.kind, ar.bytes, ar.dtype) == ("all_reduce", 16, "float64")  # (sse, count)
    # ZeRO-1: the evaluated EMA tree gathered whole, then the same scalars
    *gathers, last = inv["val_zero1"][0]
    assert [c.kind for c in gathers] == ["all_gather"] and last == ar


def test_dp_sampler_makes_no_collective_but_the_closing_barrier(inventories):
    inv, _ = inventories
    assert [c.kind for c in inv["sampler"][0]] == ["barrier"]


def test_no_group_no_collective():
    params = {"w": torch.ones(5, 3), "b": torch.zeros(5)}
    plan = ParallelPlan(params, zero1=True)
    with collective_inventory() as inv:
        plan.sync([torch.ones(5, 3), torch.ones(5)], [torch.tensor(1.0)], [torch.tensor(2.0)])
        plan.adopt_params(params)
        plan.gather_params(params)
        plan.gather(plan.shard(params))
    assert inv == []


def test_one_rank_world_still_makes_its_collectives(tmp_path):
    """A process group of one rank (``train --multihost`` under a one-rank
    torchrun) makes and records its gradient sync, a group of one rank
    inside a larger world does not (the data group of a 1 x 2 grid)."""
    (one,) = worker.run("plan_sync", 1, tmp_path / "one")
    # the two params at 64-element offsets and three scalars, fp32
    assert [c[:3] for c in one] == [("all_reduce", 64 * 4 + 64 * 4 + 3 * 4, 1)]
    for inv in worker.run("plan_sync", 2, tmp_path / "two", model_parallel=2):
        assert [(c.kind, c.group, c.group_size) for c in (Collective(*c) for c in inv)] == [
            ("all_reduce", "model", 2)]


def test_recorder_nesting_and_summary():
    with collective_inventory() as outer:
        record("all_reduce", 400, 4, "float32")
        with collective_inventory() as inner:
            record("all_gather", 1000, 4, "float32")
            record("barrier", 0, 4)
    record("all_reduce", 8, 4)  # no inventory open: nowhere
    assert [c.kind for c in outer] == ["all_reduce", "all_gather", "barrier"]
    assert inner == outer[1:]
    assert inventory_summary(outer) == {"all_reduce": {"count": 1, "bytes": 400},
                                        "all_gather": {"count": 1, "bytes": 1000},
                                        "barrier": {"count": 1, "bytes": 0}}
