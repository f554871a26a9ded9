"""The port's data-parallel pieces in one process: the rank slices against
the JAX package's (``process_local_slice``, ``local_rows``), the flat layout
of ``ParallelPlan`` and its ZeRO-1 pieces, the world-size-1 step bit-equal to
the step without a plan (data parallel and ZeRO-1), the per-rank generators,
the data modules' rank shares and churn's rank rows. The multi-rank cases
are in ``tests/test_torch_dist_trainer.py`` and
``tests/test_torch_collectives.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests import _torch_dist_worker as worker
from tests.test_torch_train_step import _jax_start
from tinyedm_tpu.generate import local_rows as jax_local_rows
from tinyedm_tpu.parallel.mesh import process_local_slice as jax_process_local_slice
from tinyedm_tpu_torch.data import datamodules as pdm
from tinyedm_tpu_torch.diffusion.solver import StochasticSolver
from tinyedm_tpu_torch.models.edm import init_weights
from tinyedm_tpu_torch.parallel import mesh
from tinyedm_tpu_torch.parallel.mesh import ALIGN, ParallelPlan, local_rows, process_local_slice, shard_batch
from tinyedm_tpu_torch.utils.cuda import folded_generator, step_generator
from tinyedm_tpu_torch.utils.interop import train_state_from_jax

OPT = dict(lr=0.01, rampup_steps=2, steady_steps=2, accum_steps=2, grad_clip_norm=1.0, log_norms=True)
SIGMA_RELS = (0.13, 0.05)


@pytest.mark.parametrize("rows,index,count", [(12, 0, 4), (12, 3, 4), (16, 1, 2), (6, 0, 1), (8, 7, 8)])
def test_process_local_slice_matches_jax(rows, index, count):
    x = np.arange(rows * 3).reshape(rows, 3)
    np.testing.assert_array_equal(process_local_slice(x, index, count), jax_process_local_slice(x, index, count))
    parts = [process_local_slice(x, i, count) for i in range(count)]
    np.testing.assert_array_equal(np.concatenate(parts), x)


def test_process_local_slice_raises_as_jax():
    for fn in (process_local_slice, jax_process_local_slice):
        with pytest.raises(ValueError, match="global batch 10 not divisible by 3 processes"):
            fn(np.arange(10), 0, 3)


@pytest.mark.parametrize("batch,n_valid,pc", [(8, 8, 2), (8, 5, 2), (8, 3, 4), (12, 7, 3), (6, 1, 2), (4, 4, 1)])
def test_local_rows_match_jax(batch, n_valid, pc):
    indices = list(range(100, 100 + n_valid))
    for pi in range(pc):
        ours, theirs = local_rows(batch, n_valid, indices, pi, pc), jax_local_rows(batch, n_valid, indices, pi, pc)
        np.testing.assert_array_equal(ours[0], theirs[0])
        assert ours[1] == theirs[1]
    written = [i for pi in range(pc) for i in local_rows(batch, n_valid, indices, pi, pc)[1]]
    assert written == indices  # every real row once, in order


@pytest.mark.parametrize("size", [1, 2, 3, 4])
def test_plan_layout_and_pieces_tile_the_params(size):
    model = worker.smoke_model()
    params = dict(model.named_parameters())
    plans = [ParallelPlan(params, zero1=True, rank=r, size=size) for r in range(size)]
    p = plans[0]
    assert p.param_bytes == 4 * sum(v.numel() for v in params.values())
    assert all(o % ALIGN == 0 for o in p.offsets) and p.chunk % ALIGN == 0 and p.padded >= p.numel
    # the gaps are fewer than ALIGN elements a param
    assert p.numel - sum(p.numels) < ALIGN * len(params)
    covered = {i: [] for i in range(len(params))}
    for r, plan in enumerate(plans):
        for i, a, b, s in plan.pieces:
            assert 0 <= s and s + b - a <= plan.chunk
            assert plan.offsets[i] + a == r * plan.chunk + s
            covered[i].append((a, b))
    for i, spans in covered.items():
        assert sorted(spans)[0][0] == 0 and sorted(spans)[-1][1] == p.numels[i]
        assert all(x[1] == y[0] for x, y in zip(sorted(spans), sorted(spans)[1:]))


def test_shard_and_gather_in_one_process_round_trip():
    model = worker.smoke_model()
    init_weights(model, torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    plan = ParallelPlan(params, zero1=True)
    tree = {k: torch.randn(v.shape) for k, v in params.items()}
    pieces = plan.shard(tree)
    back = plan.gather(pieces)
    assert all(torch.equal(back[k], tree[k]) for k in tree)
    before = {k: v.detach().clone() for k, v in params.items()}
    plan.adopt_params(params)
    assert all(torch.equal(v, before[k]) for k, v in params.items())
    plan.gather_params(params)  # one process: its range is everything
    assert all(torch.equal(v, before[k]) for k, v in params.items())
    model.load_state_dict({k: torch.zeros_like(v) for k, v in before.items()}, strict=False)
    plan.gather_params(params)  # load_state_dict copies into the flat buffer
    with torch.no_grad():
        next(iter(params.values())).data = torch.zeros(3)
    with pytest.raises(RuntimeError, match="not in this plan's flat buffer"):
        plan.gather_params(params)


def test_sync_without_a_group_keeps_gradients_and_scalars():
    model = worker.smoke_model()
    params = dict(model.named_parameters())
    plan = ParallelPlan(params)
    grads = [torch.randn(p.shape) for p in params.values()]
    views, means, sums = plan.sync(grads, [torch.tensor(0.5)], [torch.tensor(3.0), torch.tensor(1.0)])
    assert all(torch.equal(v, g) for v, g in zip(views, grads))
    assert means.tolist() == [0.5] and sums.tolist() == [3.0, 1.0]
    buffer = plan._buffer
    plan.sync(grads, [torch.tensor(0.5)], [torch.tensor(3.0), torch.tensor(1.0)])
    assert plan._buffer is buffer  # made once, reused


def test_fp32_params_only():
    with pytest.raises(ValueError, match="fp32"):
        ParallelPlan({"w": torch.zeros(4, dtype=torch.bfloat16)})


def _start():
    start = _jax_start(torch.float32, tuple(sorted(OPT.items())))
    state = train_state_from_jax(start, worker.smoke_model())
    return {"step": state.step, "count": state.count, "params": state.params, "constants": state.constants,
            "mu": state.mu, "nu": state.nu, "ema": list(state.ema)}


def _batches(n=3, b=4):
    dm = pdm.SyntheticDataModule(b, image_size=16, num_samples=n * b, seed=5)
    return list(dm.train_batches(0))


@pytest.mark.parametrize("zero1", [False, True], ids=["dp", "zero1"])
def test_world_size_one_step_is_bit_equal_to_the_step_without_a_plan(zero1):
    start, batches = _start(), _batches()
    common = dict(start=start, batches=batches, opt=OPT, sigma_rels=SIGMA_RELS, sched_count=10)
    plain = worker.train_steps(0, 1, grouped=False, **common)
    planned = worker.train_steps(0, 1, zero1=zero1, **common)
    assert planned["metrics"] == [{k: v for k, v in m.items()} | {"interrupt": 0.0} for m in plain["metrics"]]
    a, b = plain["state"], planned["state"]
    assert (a["step"], a["count"]) == (b["step"], b["count"]) == (start["step"] + 3, start["count"] + 3)
    for key in ("params", "mu", "nu"):
        assert all(torch.equal(a[key][k], b[key][k]) for k in a[key]), key
    for ta, tb in zip(a["ema"], b["ema"]):
        assert all(torch.equal(ta[k], tb[k]) for k in ta)
    assert planned["inventories"] == [[]] * 3  # no group: no collective


def test_step_generators():
    a = torch.randn(8, generator=step_generator(3, 5, "cpu"))
    assert torch.equal(a, torch.randn(8, generator=folded_generator(3, 5, "cpu")))
    ranks = [torch.randn(8, generator=step_generator(3, 5, "cpu", r, 4)) for r in range(4)]
    again = [torch.randn(8, generator=step_generator(3, 5, "cpu", r, 4)) for r in range(4)]
    assert all(torch.equal(x, y) for x, y in zip(ranks, again))
    assert len({tuple(x.tolist()) for x in ranks + [a]}) == 5
    assert not torch.equal(ranks[0], torch.randn(8, generator=step_generator(3, 6, "cpu", 0, 4)))


def _as_rank(monkeypatch, rank, size):
    monkeypatch.setattr(mesh, "world", lambda: (rank, size))


@pytest.mark.parametrize("raw", [False, True], ids=["host", "raw"])
def test_rank_shares_of_the_data_modules_batches_tile_the_global_batches(monkeypatch, raw):
    """Every rank draws the same global batches (the data module does not
    depend on the world), and the ranks' ``shard_batch`` shares of each,
    concatenated in rank order, are that batch."""
    dm = pdm.SyntheticDataModule(8, image_size=4, num_samples=40, seed=1)
    dm._flip_flags = lambda n, rng: rng.random(n) < 0.5  # flips, as CIFAR-10 draws them
    fn = dm.train_batches_raw if raw else dm.train_batches
    whole = list(fn(1, skip=1))
    shares = []
    for rank in range(4):
        _as_rank(monkeypatch, rank, 4)
        batches = list(fn(1, skip=1))
        assert all(all(np.array_equal(x, y) for x, y in zip(a, b)) for a, b in zip(batches, whole))
        shares.append([shard_batch(b) for b in batches])
    assert not getattr(dm, "yields_process_local", False) and len(whole) == 4
    for b, batch in enumerate(whole):
        for j, part in enumerate(batch):
            np.testing.assert_array_equal(np.concatenate([s[b][j] for s in shares]), part)


def test_shard_batch(monkeypatch):
    batch = (np.arange(8), None, np.arange(16).reshape(8, 2))
    assert shard_batch(batch) == batch
    _as_rank(monkeypatch, 1, 2)
    x, none, y = shard_batch(batch)
    np.testing.assert_array_equal(x, np.arange(4, 8))
    np.testing.assert_array_equal(y, np.arange(8, 16).reshape(4, 2))
    assert none is None and shard_batch(batch, process_local=True) == batch


def test_churn_rows_are_the_global_solves_rows():
    solver = StochasticSolver(num_steps=4, S_churn=40.0, S_min=0.05, S_max=50.0, S_noise=1.003)
    x0 = torch.randn((6, 2, 4, 4), generator=torch.Generator().manual_seed(0))

    def denoise(x, sigma, labels):  # row-wise
        return 0.5 * x / (1.0 + sigma.reshape(-1, 1, 1, 1))

    whole = solver.solve(denoise, x0, None, generator=torch.Generator().manual_seed(9))
    for first in (0, 2, 4):
        part = solver.solve(denoise, x0[first : first + 2], None, generator=torch.Generator().manual_seed(9),
                            rows=(first, 6))
        assert torch.equal(part, whole[first : first + 2])
