"""The port's spans (``utils/profiling.py::span``): nothing entered while no
profiler records; under a CPU profile, the train step's and the solvers'
span trees; a step's numbers bitwise the same with spans recorded."""

from __future__ import annotations

import contextlib

import pytest
import torch

from tinyedm_tpu_torch.configs import CONFIGS
from tinyedm_tpu_torch.data.datamodules import SyntheticDataModule, to_device
from tinyedm_tpu_torch.diffusion.diffuser import Diffuser
from tinyedm_tpu_torch.diffusion.solver import DeterministicSolver, MultistepSolver, StochasticSolver
from tinyedm_tpu_torch.models.edm import EDM, init_weights
from tinyedm_tpu_torch.models.layers import Embedding
from tinyedm_tpu_torch.models.unet import Denoiser
from tinyedm_tpu_torch.training.ema import EMAConfig
from tinyedm_tpu_torch.training.train_step import OptimizerConfig, init_train_state, make_train_step
from tinyedm_tpu_torch.utils import profiling
from tinyedm_tpu_torch.utils.profiling import span

FORWARD, BACKWARD = ("tinyedm.train_step.forward", []), ("tinyedm.train_step.backward", [])
# per microbatch a forward and a backward, then the gradients' mean (a backward of its own)
STEP_TREE = [("tinyedm.train_step", [FORWARD, BACKWARD, FORWARD, BACKWARD, BACKWARD, ("tinyedm.train_step.optimizer", [
    ("tinyedm.train_step.optimizer.adam", []),
    ("tinyedm.train_step.optimizer.weight_norm", []),
    ("tinyedm.train_step.optimizer.ema", []),
])])]


def _cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _tree(prof) -> list:
    """The ``tinyedm.*`` ranges of a profile as nested (name, children), in
    order of their start."""
    events = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                     for e in prof.profiler.kineto_results.events() if e.name().startswith("tinyedm.")),
                    key=lambda t: (t[0], -t[1]))
    root: list = []
    stack = [(float("inf"), root)]
    for start, end, name in events:
        while start >= stack[-1][0]:
            stack.pop()
        node = (name, [])
        stack[-1][1].append(node)
        stack.append((end, node[1]))
    return root


def _smoke_step(record: bool):
    """One step of the smoke model with 2 microbatches and two EMA trees,
    under a CPU profile or none: (its metrics, the state after it, the profile)."""
    cfg = CONFIGS["smoke"]
    den = {k: v for k, v in cfg["denoiser"].items() if k != "dtype"}
    model = EDM(Embedding(**cfg["embedding"]), Denoiser(**den, dtype=torch.float32))
    init_weights(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.denoiser.gain_out.fill_(1.0)
    opt = OptimizerConfig(lr=1e-2, accum_steps=2)
    ema = EMAConfig(sigma_rels=(0.05, 0.1), every_n_steps=1)
    state = init_train_state(model, opt, ema)
    step = make_train_step(model, Diffuser(), opt, ema)
    images, labels = next(SyntheticDataModule(4, image_size=16, num_samples=4).train_batches(0))
    batch = to_device(images, labels, "cpu")
    with _cpu_profile() if record else contextlib.nullcontext() as prof:
        _, metrics = step(state, batch, torch.Generator().manual_seed(3), 10)
    return metrics, state, prof


def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: entered.append(name))
    assert not torch.autograd._profiler_enabled()
    with span("tinyedm.anything") as inside:
        assert inside is None
    assert span("tinyedm.other") is profiling._OFF and entered == []
    with _cpu_profile():
        span("tinyedm.recorded")
    assert entered == ["tinyedm.recorded"]


def test_train_step_records_its_span_tree():
    _, _, prof = _smoke_step(record=True)
    assert _tree(prof) == STEP_TREE


def test_step_is_bitwise_the_same_with_spans_recorded():
    (m0, s0, _), (m1, s1, _) = _smoke_step(record=False), _smoke_step(record=True)
    assert torch.equal(m0["train_loss"], m1["train_loss"]) and torch.equal(m0["sse"], m1["sse"])
    for name, p in s0.params.items():
        assert torch.equal(p, s1.params[name]), name
    for tree0, tree1 in zip(s0.ema, s1.ema, strict=True):
        assert all(torch.equal(v, tree1[k]) for k, v in tree0.items())
    assert all(torch.equal(v, s1.mu[k]) and torch.equal(s0.nu[k], s1.nu[k]) for k, v in s0.mu.items())


@pytest.mark.parametrize("solver, forwards", [
    (DeterministicSolver(num_steps=3), 5),
    (StochasticSolver(num_steps=3, S_churn=10.0), 5),
    (MultistepSolver(num_steps=3), 3),
])
def test_solve_records_one_span_around_its_denoiser_calls(solver, forwards):
    x0 = torch.randn(2, 3, 4, 4, generator=torch.Generator().manual_seed(0))
    kwargs = {"generator": torch.Generator().manual_seed(1)} if isinstance(solver, StochasticSolver) else {}
    with _cpu_profile() as prof:
        solver.solve(lambda x, sigma, labels: 0.5 * x, x0, None, **kwargs)
    assert _tree(prof) == [("tinyedm.solve", [("tinyedm.solve.denoise", [])] * forwards)]
