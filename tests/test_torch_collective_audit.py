"""The port's collective-audit CLI (``tinyedm_tpu_torch/collective_audit.py``)
and its table (``parallel/audit.py``: ``format_inventory``, ``wire_bytes``).

- ``wire_bytes`` equals the JAX tool's ring estimate
  (``experiments/collective_audit.py::_wire_bytes``) of the same collective
  at group sizes 1, 2, 4 and 8: all-reduce 2(n-1)/n, all-gather (n-1)/n of
  the payload; a barrier moves none, an unknown kind raises.
  ``format_inventory`` prints one row per collective in order, and the JAX
  line for an empty inventory.
- The CLI's in-process function (``audit``) on 2 gloo CPU ranks at the
  smoke width, held to what ``tests/test_torch_collectives.py`` and
  ``tests/test_torch_tensor_parallel.py`` pin, with ``param_bytes`` from the
  JAX model of the same YAML: a data-parallel step is exactly one
  all-reduce of [param_bytes, 1.05 param_bytes + 1024] over the 2 data
  ranks, and its wire bytes are 2(n-1)/n of it; ZeRO-1 adds one
  parameter-sized all-gather; on a 1 x 2 grid the step makes model-group
  collectives only, none as large as the params, more all-reduces than
  gathers; the data-parallel sampler makes no collective but the closing
  barrier, the tensor-parallel one model-group gathers and the barrier.
  Both ranks record the same inventory.
- ``main`` spawns its ranks and prints the report; ``--backend nccl`` with
  more ranks than cards raises, and so do the other impossible requests.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import _torch_dist_worker as worker
from tinyedm_tpu.config.registry import instantiate as jax_instantiate
from tinyedm_tpu.config.registry import load_config as jax_load_config
from tinyedm_tpu.parallel import audit as jaudit
from tinyedm_tpu_torch import collective_audit as cli
from tinyedm_tpu_torch.parallel.audit import Collective, format_inventory, inventory_summary, wire_bytes

ROOT = Path(__file__).resolve().parents[1]
SMOKE = dict(config="smoke", batch=8)


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_collective_audit", ROOT / "experiments" / "collective_audit.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["all_reduce", "all_gather"])
def test_wire_bytes_equals_the_jax_ring_estimate(kind, n):
    nbytes = 142_491_664
    ours = wire_bytes(Collective(kind, nbytes, n, "float32", "data"))
    theirs = _jax_tool()._wire_bytes(
        jaudit.Collective(kind.replace("_", "-"), "x", ("f32[35622916]",), nbytes, f"[1,{n}]<=[{n}]", ""),
        None, jaudit.group_shape)
    assert ours == theirs
    assert ours == nbytes * (2 if kind == "all_reduce" else 1) * (n - 1) / n


def test_wire_bytes_of_a_barrier_and_an_unknown_kind():
    assert wire_bytes(Collective("barrier", 0, 8)) == 0.0
    with pytest.raises(ValueError, match="reduce_scatter"):
        wire_bytes(Collective("reduce_scatter", 8, 2))


def test_format_inventory_rows_and_empty():
    inv = [Collective("all_reduce", 142_491_664, 8, "float32", "data"),
           Collective("all_gather", 4096, 2, "bfloat16", "model"), Collective("barrier", 0, 8, "", "world")]
    rows = format_inventory(inv).splitlines()
    assert len(rows) == 3
    assert rows[0].split() == ["all_reduce", "142.492", "MB", "group=data[8]", "float32"]
    assert rows[1].split() == ["all_gather", "0.004", "MB", "group=model[2]", "bfloat16"]
    assert rows[2].split() == ["barrier", "0.000", "MB", "group=world[8]", "-"]
    assert format_inventory([]) == jaudit.format_inventory([]) == "(no collectives: single-device program)"


def _jax_param_bytes(config: str) -> int:
    """fp32 bytes of the JAX model of ``experiments/conf/<config>.yaml``."""
    cfg = jax_load_config(str(ROOT / "experiments" / "conf" / f"{config}.yaml"))
    model = jax_instantiate(cfg["model"]).build_model()
    size, channels = cfg["datamodule"]["image_size"], cfg["model"]["denoiser"]["in_channels"]
    shapes = jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, size, size, channels)),
                                               jnp.ones((1,)), jnp.zeros((1,), jnp.int32)))
    return sum(int(np.prod(x.shape)) * 4 for x in jax.tree_util.tree_leaves(shapes["params"]))


@pytest.fixture(scope="module")
def audits(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("audit")
    cases = {"dp": {}, "zero1": {"zero1": True}, "tp": {"model_parallel": 2}, "dp_sampler": {"sampler": True},
             "tp_sampler": {"model_parallel": 2, "sampler": True}}
    ranks = worker.run("many", 2, tmp, calls=[("collective_audit", {**SMOKE, **kw}) for kw in cases.values()],
                       timeout=240)
    return {name: [r[i] for r in ranks] for i, name in enumerate(cases)}, _jax_param_bytes("smoke")


def _program(result: dict, name: str) -> list:
    (program,) = [p for p in result["programs"] if p["name"].startswith(name)]
    return program["inventory"]


def test_ranks_record_the_same_inventories(audits):
    runs, _ = audits
    for name, (a, b) in runs.items():
        assert [p["inventory"] for p in a["programs"]] == [p["inventory"] for p in b["programs"]], name


def test_dp_step_is_one_gradient_allreduce_and_its_ring_bytes(audits):
    runs, param_bytes = audits
    r = runs["dp"][0]
    assert r["param_bytes"] == r["rank_param_bytes"] == param_bytes
    assert (r["data_size"], r["model_size"], r["backend"]) == (2, 1, "gloo")
    (ar,) = _program(r, "train step")
    assert (ar.kind, ar.group, ar.group_size, ar.dtype) == ("all_reduce", "data", 2, "float32")
    assert param_bytes <= ar.bytes <= int(param_bytes * 1.05) + 1024
    assert wire_bytes(ar) == ar.bytes * 2 * (2 - 1) / 2
    text = r["report"]
    assert f"payload total: {ar.bytes / 1e6:.2f} MB" in text
    assert f"ring-estimate wire bytes/rank/step: {ar.bytes / 1e6:.2f} MB (params: {param_bytes / 1e6:.2f} MB" in text
    assert "grid=2 x 1 (data x model)" in text and format_inventory([ar]) in text


def test_zero1_step_adds_one_param_sized_allgather(audits):
    runs, param_bytes = audits
    inv = _program(runs["zero1"][0], "train step")
    s = inventory_summary(inv)
    assert set(s) == {"all_reduce", "all_gather"} and s["all_reduce"]["count"] == s["all_gather"]["count"] == 1
    assert param_bytes * 0.95 <= s["all_reduce"]["bytes"] <= param_bytes * 1.10 + 4096
    assert param_bytes * 0.80 <= s["all_gather"]["bytes"] <= param_bytes * 1.05 + 4096
    assert all(c.group_size == 2 for c in inv)


def test_1x2_step_makes_model_collectives_only(audits):
    runs, param_bytes = audits
    r = runs["tp"][0]
    assert (r["data_size"], r["model_size"]) == (1, 2) and r["rank_param_bytes"] < 0.6 * param_bytes
    inv = _program(r, "train step")
    assert inv and {(c.group, c.group_size) for c in inv} == {("model", 2)}
    assert max(c.bytes for c in inv) < param_bytes
    assert 0 < sum(c.kind == "all_gather" for c in inv) < sum(c.kind == "all_reduce" for c in inv)
    assert sum(wire_bytes(c) for c in inv) == pytest.approx(
        sum(c.bytes * (1.0 if c.kind == "all_reduce" else 0.5) for c in inv))


def test_sampler_collectives(audits):
    runs, _ = audits
    assert [c.kind for c in _program(runs["dp_sampler"][0], "sampler")] == ["barrier"]
    assert "ring-estimate wire bytes/rank/solve: 0.00 MB" in runs["dp_sampler"][0]["report"]
    inv = _program(runs["tp_sampler"][0], "sampler")
    assert {(c.kind, c.group) for c in inv} == {("all_gather", "model"), ("barrier", "world")}
    assert inv[-1].kind == "barrier"
    # the step's inventory is the same with and without the sampler
    assert _program(runs["tp_sampler"][0], "train step") == _program(runs["tp"][0], "train step")


def test_main_spawns_its_ranks_and_prints_the_report(capsys):
    text = cli.main(["--config", "smoke", "--batch", "8", "--devices", "2", "--device", "cpu", "--sampler"])
    assert capsys.readouterr().out.strip() == text.strip()
    assert text.startswith("config=smoke batch=8 grid=2 x 1 (data x model) zero1=False")
    assert "===== train step =====" in text and "===== sampler (Heun-4, 7 forwards) =====" in text
    assert "rows 1-4 kernel launches on rank 0: none" in text  # the CPU runs the plain versions


def test_impossible_requests_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 ranks over NCCL need 2 cards, this machine has 1.*--backend gloo"):
        cli.parse_args(["--devices", "2"])
    with pytest.raises(ValueError, match="8 ranks over NCCL need 8 cards"):
        cli.parse_args(["--backend", "nccl"])
    assert cli.parse_args(["--devices", "1"]).backend == "nccl"
    with pytest.raises(ValueError, match="needs --device cuda"):
        cli.parse_args(["--device", "cpu", "--backend", "nccl"])
    with pytest.raises(ValueError, match="not divisible by --model_parallel"):
        cli.parse_args(["--device", "cpu", "--devices", "3", "--model_parallel", "2"])
    with pytest.raises(ValueError, match="--batch 30 not divisible by 8"):
        cli.parse_args(["--device", "cpu", "--batch", "30"])
    assert cli.parse_args(["--device", "cpu"]).backend == "gloo"
    if not torch.cuda.is_available():  # the card by default, never a quiet CPU fallback
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.parse_args(["--backend", "gloo"])
