"""The spans' charges on hand-made profiles: every instant of the device's
window charged once, a launch by time on any thread, an idle gap to the host
work that ends it, own charges without the children's, launches per span,
host time per span, a launch whose operation the profile lost, the phases'
per-unit numbers, and the CLI on the CPU."""

from __future__ import annotations

import contextlib
import io
import json

import pytest

from edmbench import spans
from edmbench.spans import OUTSIDE, PHASES, charge, phases
from edmbench.trace import Event

from .conftest import SMOKE_CELLS
HOST, ENGINE = 1, 2  # the thread that holds the spans, the autograd engine's


def ev(name, kind, s, e, corr=0, thread=HOST):
    return Event(name, kind, s, e, thread, corr, 0)


def _step() -> list[Event]:
    """One train step: the feed's copy outside the spans, two forward
    kernels and one that overlaps the second, a backward kernel launched
    from the engine's thread, Adam's kernel, one of the optimizer's own, a
    sync after the step. The device's window runs from 2 to 80."""
    return [
        ev("edmbench.window", "span", 0, 100),
        ev("tinyedm.train_step", "span", 5, 90),
        ev("tinyedm.train_step.forward", "span", 5, 30),
        ev("tinyedm.train_step.forward", "span", 10, 35, thread=-1),  # its copy on the device's track
        ev("tinyedm.train_step.backward", "span", 30, 60),
        ev("tinyedm.train_step.optimizer", "span", 60, 85),
        ev("tinyedm.train_step.optimizer.adam", "span", 62, 70),
        ev("cudaMemcpyAsync", "runtime", 1, 2, corr=6),
        ev("Memcpy HtoD (Pageable -> Device)", "device", 2, 4, corr=6),
        ev("cudaLaunchKernel", "runtime", 6, 7, corr=1),
        ev("fwd_a", "device", 10, 20, corr=1),
        ev("cudaLaunchKernel", "runtime", 25, 26, corr=2),
        ev("fwd_b", "device", 22, 35, corr=2),
        ev("cudaLaunchKernel", "runtime", 28, 29, corr=7),
        ev("fwd_c", "device", 30, 33, corr=7),
        ev("cudaLaunchKernel", "runtime", 40, 41, corr=3, thread=ENGINE),
        ev("bwd", "device", 45, 55, corr=3),
        ev("cuLaunchKernel", "runtime", 63, 64, corr=4),
        ev("multi_tensor_apply_kernel", "device", 64, 70, corr=4),
        ev("cudaLaunchKernel", "runtime", 75, 76, corr=5),
        ev("norm", "device", 76, 80, corr=5),
        ev("cudaStreamSynchronize", "runtime", 86, 99, corr=8),
    ]


def _solve() -> list[Event]:
    """One batch: two denoiser calls, each followed by a kernel of the
    solver's own; the device's window runs from 5 to 41."""
    return [
        ev("edmbench.window", "span", 0, 50),
        ev("edmbench.solve", "span", 0, 48),
        ev("tinyedm.solve", "span", 0, 48),
        ev("tinyedm.solve.denoise", "span", 2, 10),
        ev("tinyedm.solve.denoise", "span", 20, 30),
        ev("cudaLaunchKernel", "runtime", 3, 4, corr=1),
        ev("d1", "device", 5, 12, corr=1),
        ev("cudaLaunchKernel", "runtime", 15, 15.5, corr=2),
        ev("axpy", "device", 15, 16, corr=2),
        ev("cudaLaunchKernel", "runtime", 21, 22, corr=3),
        ev("d2", "device", 22, 35, corr=3),
        ev("cudaLaunchKernel", "runtime", 38, 39, corr=4),
        ev("axpy", "device", 40, 41, corr=4),
    ]


def _own(events, name):
    c = charge(events).own[name]
    return c.us, c.busy_us, c.launches


def _whole(events, name):
    c = charge(events).whole[name]
    return c.us, c.busy_us, c.launches


@pytest.mark.parametrize("events, window", [(_step(), 80 - 2), (_solve(), 41 - 5)], ids=["step", "solve"])
def test_the_charges_sum_to_the_devices_window(events, window):
    s = charge(events)
    assert s.window_us == window and s.host_window_us == events[0].end - events[0].start and s.lost == 0
    assert sum(c.us for c in s.own.values()) == pytest.approx(window)


def test_a_launch_on_the_engine_thread_is_charged_to_the_backward():
    # idle 35-45 (the host's 30-40), busy 45-55, and 6 of the idle 55-64 (the host's 54-60)
    assert _own(_step(), "tinyedm.train_step.backward") == (10 + 10 + 6, 10, 1)


def test_an_idle_gap_goes_to_the_host_work_that_ends_it():
    # the idle 55-64 ended by a launch at 63 is the host's 54-63: 6 backward,
    # 2 optimizer, 1 adam; the idle 70-76 ended at 75 is the host's 69-75
    assert _own(_step(), "tinyedm.train_step.optimizer.adam") == (1 + 6 + 1, 6, 1)
    assert _own(_step(), "tinyedm.train_step.optimizer") == (2 + 5 + 4, 4, 1)
    # the feed's copy and the host's time before the step (the idle 4-10 is the host's 0-6) are outside
    assert _own(_step(), OUTSIDE) == (2 + 5, 2, 0)


def test_the_solvers_host_work_between_denoiser_calls_is_the_solvers():
    """The second call's kernel waits 6 us (16-22) for its launch at 21:
    the host's 15-21, 5 of them in the solver's own Python after the first
    call's span, 1 in the second call's span."""
    s = charge(_solve())
    assert (s.own["tinyedm.solve"].us, s.own["tinyedm.solve"].busy_us) == (3 + 1 + 5 + 5 + 1, 2)
    assert (s.whole["tinyedm.solve.denoise"].us, s.whole["tinyedm.solve.denoise"].busy_us) == (7 + 1 + 13, 20)
    late = [ev("cudaLaunchKernel", "runtime", 29, 29.5, corr=3) if (e.correlation, e.kind) == (3, "runtime") else e
            for e in _solve()]
    assert charge(late).own["tinyedm.solve"].us == 3 + 1 + 5 + 1  # the same gap ended at 29: the host's 23-29, the call's


def test_an_operation_without_a_launch_call_takes_its_idle_gap():
    events = [e for e in _step() if e.correlation != 3 or e.kind == "device"]
    assert _own(events, OUTSIDE) == (2 + 5 + 10 + 10, 2 + 10, 0)
    # beside one with a call, at the same times
    twin = events + [ev("cudaLaunchKernel", "runtime", 41, 42, corr=10), ev("bwd", "device", 45, 55, corr=10)]
    assert charge(twin).own[OUTSIDE].us == 2 + 5 + 10 + 10


def test_overlapping_operations_charge_the_earliest_to_start():
    assert _own(_step(), "tinyedm.train_step.forward") == (1 + 10 + 2 + 13, 23, 3)


def test_a_parents_own_charge_leaves_out_its_childrens():
    events = _step()
    assert _own(events, "tinyedm.train_step.optimizer") == (11, 4, 1)
    assert _whole(events, "tinyedm.train_step.optimizer") == (19, 10, 2)
    assert _own(events, "tinyedm.train_step") == (0, 0, 0)
    assert _whole(events, "tinyedm.train_step") == (26 + 26 + 19, 23 + 10 + 10, 3 + 1 + 2)
    assert _own(_solve(), "tinyedm.solve") == (15, 2, 2)


def test_a_launch_whose_operation_the_profile_lacks_is_lost():
    events = _step() + [ev("cudaLaunchKernel", "runtime", 86, 87, corr=9)]
    assert charge(events).lost == 1 and charge(_step()).lost == 0


def test_host_time_is_each_spans_interval_less_its_childrens():
    s = charge(_step())
    assert {k: c.host_us for k, c in s.own.items()} == {
        "tinyedm.train_step": 85 - 25 - 30 - 25, "tinyedm.train_step.forward": 25, "tinyedm.train_step.backward": 30,
        "tinyedm.train_step.optimizer": 25 - 8, "tinyedm.train_step.optimizer.adam": 8, OUTSIDE: 100 - 85}
    assert s.whole["tinyedm.train_step"].host_us == 85
    solve = charge(_solve())
    assert solve.own["tinyedm.solve"].host_us == 48 - 8 - 10 and solve.own[OUTSIDE].host_us == 2


def test_launches_are_counted_per_span():
    s = charge(_step())
    assert {k: c.launches for k, c in s.own.items()} == {
        "tinyedm.train_step": 0, "tinyedm.train_step.forward": 3, "tinyedm.train_step.backward": 1,
        "tinyedm.train_step.optimizer": 1, "tinyedm.train_step.optimizer.adam": 1, OUTSIDE: 0}
    assert s.count == {"tinyedm.train_step": 1, "tinyedm.train_step.forward": 1, "tinyedm.train_step.backward": 1,
                       "tinyedm.train_step.optimizer": 1, "tinyedm.train_step.optimizer.adam": 1}


def test_the_phases_read_the_charges():
    assert phases(charge(_step())) == pytest.approx(
        {"forward_ms": 0.026, "backward_ms": 0.026, "optimizer_ms": 0.019, "optimizer_launches": 2})
    assert phases(charge(_solve())) == pytest.approx(
        {"denoise_ms_each": (7 + 1 + 13) / 2 / 1e3, "solver_host_ms": (48 - 8 - 10) / 1e3})  # the host's, not the card's 15


def test_the_phases_are_per_unit_of_the_profile():
    """Two units' charges read half a unit's each; a denoiser call's charge
    is per instance."""
    step = phases(charge(_step(), units=2))
    assert (step["forward_ms"], step["optimizer_launches"]) == pytest.approx((0.026 / 2, 1))
    solve = phases(charge(_solve(), units=2))
    assert (solve["solver_host_ms"], solve["denoise_ms_each"]) == pytest.approx((0.030 / 2, 0.021 / 2))


@pytest.mark.parametrize("key", [k for k, _, _ in PHASES])
def test_a_phase_is_left_out_without_its_span(key):
    bare = [e for e in _step() + _solve()[1:] if not e.name.startswith("tinyedm.")]
    assert key not in phases(charge(bare))


@pytest.mark.parametrize("cell", [c[0] for c in SMOKE_CELLS])
def test_the_cli_prints_the_phases_of_a_cell(smoke_layout, cell):
    """On the CPU the profile holds no device operation: the spans' host
    times and instances, every span of the program's step or solve."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert spans.main(["--workload", cell, "--seed", str(2**31 + 19), "--seconds", "0.2", "--units", "2"],
                          smoke_layout, device="cpu") == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["units"] == 2 and line["device"] == "cpu" and line["lost_launches"] == 0
    table = line["spans"]
    if "train" in cell:
        accum = smoke_layout.config("smoke")["training"]["accum_steps"]
        assert table["tinyedm.train_step"]["n"] == 2 and table["tinyedm.train_step.forward"]["n"] == 2 * accum
        assert {"tinyedm.train_step.optimizer.adam", "tinyedm.train_step.optimizer.ema"} <= set(table)
        assert line["phases"] == {}  # no device time charged on the CPU
    else:
        steps = smoke_layout.cell(cell)["params"]["num_steps"]
        assert table["tinyedm.solve"]["n"] == 2 and table["tinyedm.solve.denoise"]["n"] == 2 * (2 * steps - 1)
        assert set(line["phases"]) == {"solver_host_ms"}  # no device time charged on the CPU
