"""The harness on the CPU: ``BENCHMARK.json`` against its format's rules and
the files it names, the result line, the refusal without a card, the imports,
a cell added as new files only, and ``correct`` against the control and
against faults planted under the timed path."""

from __future__ import annotations

import ast
import contextlib
import io
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from edmbench import run
from edmbench.control import readings
from edmbench.harness import ROOT, Layout, checks_from
from edmbench.tests.conftest import SMOKE_CELLS

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
BENCH = Layout().benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text: str) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_its_format():
    b = BENCH
    assert set(b) == KEYS["top"]
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in b["paths"])
    assert 1 <= len(b["command"]) <= 32 and all(_line(w) for w in b["command"])
    assert all(not w.startswith("/") for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # the window fits a measurement of 24 cells in 12 hours: 2 + 14 runs a
    # cell, each with 60 s beside the window, 180 s a cell to build, 1200 s spare
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for c in b["configs"]:
        assert set(c) == KEYS["config"] and NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert sorted(c["reduced"]) == sorted(json.loads((ROOT / c["file"]).read_text())["reduced"])
    assert len({c["file"] for c in b["configs"]}) == len(b["configs"])
    assert {c["name"] for c in b["configs"]} == {w["config"] for w in b["workloads"]}
    assert 1 <= len(b["workloads"]) <= 24
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(b["workloads"])
    for w in b["workloads"]:
        assert set(w) == KEYS["workload"] and NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    assert 1 <= len(b["end_to_end"]) <= 16 and 1 <= len(b["per_layer"]) <= 128
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["end_to_end"] and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["per_layer"] and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert run.reports(e2e[m["moves"]], cell, set()), (m["name"], cell)
    for cell in CELLS:
        reported = {n for n, m in e2e.items() if run.reports(m, cell, set())}
        assert "setup_s" in reported and len(reported) >= 2
        assert any(run.reports(m, cell, reported) for m in b["per_layer"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_entry_finds_its_files_by_name():
    layout = Layout()
    for c in BENCH["configs"]:
        assert layout.config(c["name"])["source"] == c["source"]
    for w in BENCH["workloads"]:
        cell = layout.cell(w["name"])
        assert all(cell[k] == w[k] for k in ("config", "traffic", "chips", "why"))
        assert callable(layout.kind(cell["kind"]).setup)
        assert cell["rate_metric"] in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert callable(layout.metric(m["name"]).read)


@pytest.mark.parametrize("name", ["cifar10", "imagenet512"])
def test_configs_are_the_ports_recipes(name):
    """The benchmark's files hold the port's own configuration constants."""
    from tinyedm_tpu_torch.configs import CONFIGS, TRAINING

    cfg, port, recipe = Layout().config(name), CONFIGS[name], TRAINING[name]
    assert cfg["embedding"] == port["embedding"] and cfg["denoiser"] == port["denoiser"]
    t = cfg["training"]
    assert t["lr"] == recipe["lr"] and t["diffuser"] == recipe["diffuser"]
    assert t["accum_steps"] == recipe["accumulate_grad_batches"]
    assert t["ema_lengths"] == list(recipe.get("ema_lengths") or [recipe["ema_length"]])
    assert cfg["use_uncertainty"] == recipe["use_uncertainty"]


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".", 1)[0])
    return out


def test_no_jax_and_a_reference_free_of_the_port():
    bench = ROOT / "edmbench"
    for path in bench.rglob("*.py"):
        assert not _imports(path) & set(run.FORBIDDEN), path
    for path in (bench / "reference").rglob("*.py"):
        assert "tinyedm_tpu_torch" not in _imports(path), path


def test_without_a_card_it_refuses_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    done = subprocess.run([sys.executable, str(ROOT / "edmbench" / "run.py"), "--workload", CELLS[0],
                           "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert done.returncode != 0 and done.stdout == ""
    assert "CUDA" in done.stderr


def _run(layout: Layout, cell: str, seed: int, trace: int = 0) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.5", "--trace", str(trace)],
                        layout, device="cpu") == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", [c[0] for c in SMOKE_CELLS])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_added_as_files_runs_and_prints_the_result_line(smoke_layout, cell, trace):
    result = _run(smoke_layout, cell, 2**31 + 17, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else []) + ["checks"]
    assert list(result) == keys
    assert result["correct"] is True and result["attempted"] > 0 and result["failed"] == 0
    bench = smoke_layout.benchmark()
    if trace:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(m["unit"] == next(p["unit"] for p in bench["per_layer"] if p["name"] == k)
                   for k, m in result["metrics"].items())
    else:
        wanted = {m["name"] for m in bench["end_to_end"] if run.reports(m, cell, set())}
        assert set(result["metrics"]) == wanted
    assert set(result["checks"]) == set(smoke_layout.cell(cell)["limits"])


@contextlib.contextmanager
def _planted(monkeypatch, fault: str):
    """A fault under the timed path, planted in the port's functions."""
    import tinyedm_tpu_torch.generate as generate
    import tinyedm_tpu_torch.training.train_step as ts

    real_step, real_solver = ts.make_train_step, generate.make_solver

    def make_train_step(*args, **kwargs):
        step = real_step(*args, **kwargs)

        def faulty(state, batch, gen, count, interrupt=False):
            images, labels = batch
            if fault == "state_unchanged":
                saved = [{k: v.clone() for k, v in d.items()} for d in (state.params, state.mu, state.nu)]
                saved_ema = [{k: v.clone() for k, v in e.items()} for e in state.ema]
                out = step(state, batch, gen, count)
                with torch.no_grad():
                    for d, s in zip((state.params, state.mu, state.nu), saved):
                        for k in d:
                            d[k].copy_(s[k])
                    for e, s in zip(state.ema, saved_ema):
                        for k in e:
                            e[k].copy_(s[k])
                return out
            if fault == "half_batch":
                half = images.shape[0] // 2
                return step(state, (images[:half], None if labels is None else labels[:half]), gen, count)
            out = step(state, batch, gen, count)  # an answer altered where it is produced
            with torch.no_grad():
                next(iter(state.params.values())).add_(0.05)
            return out

        return faulty

    def make_solver(*args, **kwargs):
        solver = real_solver(*args, **kwargs)

        class Faulty:
            t_steps = solver.t_steps

            def solve(self, fn, x0, labels=None):
                if fault == "state_unchanged":
                    return x0 * float(solver.t_steps[0])
                if fault == "half_batch":
                    half = x0.shape[0] // 2
                    x = solver.solve(fn, x0[:half], None if labels is None else labels[:half])
                    return torch.cat([x, x[: x0.shape[0] - half]])
                x = solver.solve(fn, x0, labels).clone()
                x[0] += 0.5 * x[0].std()
                return x

        return Faulty()

    monkeypatch.setattr(ts, "make_train_step", make_train_step)
    monkeypatch.setattr(generate, "make_solver", make_solver)
    yield


@pytest.mark.parametrize("cell", [c[0] for c in SMOKE_CELLS])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_a_fault_under_the_timed_path_comes_out_not_correct(smoke_layout, monkeypatch, cell, fault):
    with _planted(monkeypatch, fault):
        result = _run(smoke_layout, cell, 2**32 + 5)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", [c[0] for c in SMOKE_CELLS])
def test_the_control_comes_out_not_correct(smoke_layout, cell):
    """The reference one precision lower (fp8) against the fp32 reference
    fails a limit of the cell that the program, on the same seed, keeps."""
    limits = smoke_layout.cell(cell)["limits"]
    r = readings(smoke_layout, cell, 77, True, torch.device("cpu"))
    assert all(c.ok for c in checks_from(r["program"], limits)), r["program"]
    assert not all(c.ok for c in checks_from(r["control"], limits)), r["control"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_correct_on_the_card(cuda_device, cell):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert run.main(["--workload", cell, "--seed", "2147483777", "--seconds", "2", "--trace", "0"]) == 0
    assert json.loads(out.getvalue().strip().splitlines()[-1])["correct"] is True
