"""The port's tensor parallelism (``parallel/tensor.py``, the grid of
``parallel/mesh.py``) on the CPU, over gloo ranks spawned by
``tests/_torch_dist_worker.py``:

- The shard rule agrees with the JAX package's ``tp_param_spec`` on every
  leaf of the smoke and CIFAR-10 trees (named through ``utils/interop``), at
  model sizes 2 and 4: the same leaves shard, to the same shard sizes.
- The head partition: each simulated rank's local attention (the plain
  version) on its ``head_rows`` equals its slice of the whole layer's output;
  over 2 ranks the sharded ``CosineAttention`` equals the whole layer in
  output, input gradient and weight gradients within fp32 1e-5 with heads
  that divide the model group, with heads that do not (qkv gathered, every
  head on each rank) and with ``fused="block"`` (the split route).
- A 1 x 2 grid: 3 steps of the smoke model in fp32 with dropout 0.1 (2
  microbatches, clipping and the global and per-layer norms on) against one
  process: the loss within rtol 1e-4, params within rtol 1e-3 and atol 1e-5
  (``tests/test_tensor_parallel.py``'s tolerances), moments and EMA too; the
  dropout bits one process's; every weight-normed output unit at RMS 1
  within 2e-4 (the eps offset); each rank about half the params' bytes.
- A 2 x 2 grid, with and without ZeRO-1, one step against one process at
  the same global batch (``ContentDiffuser`` draws) within 2e-5 relative
  L2 per tensor, the moments sharded over both axes (a quarter a rank).
- The inventory (``tests/test_collective_audit.py:211-258``): a step makes
  model-group all-reduces and a data-group gradient sync, no collective
  carries the parameter tree, sampling makes model-group collectives only.
- Heun-3 on 2 ranks against the JAX package's single-device
  ``DeterministicSolver`` on the same weights in fp32, relative L2 <= 1e-4
  (``tests/test_torch_solver.py``'s bound for the port against JAX).
- Checkpoints written at N = 2 restore at N = 1, and the reverse, bit for
  bit; ``Trainer(model_parallel=2).fit`` with previews writes each preview
  once; ``generate --model_parallel 2`` writes every row once, within 1
  level of one process; ``trainer.model_parallel=2`` trains ``smoke.yaml``
  through the training CLI and saves whole tensors.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import _torch_dist_worker as worker
from tests._torch_parity import nhwc_to_torch, rel_l2, small_models, torch_to_nhwc
from tests.test_torch_dist_trainer import OPT, SCHED_COUNT, SIGMA_RELS, _batches, _start_tensors
from tests.test_torch_train_step import _jax_start
from tinyedm_tpu.diffusion.solver import DeterministicSolver as JaxSolver
from tinyedm_tpu.models.edm import EDM as JaxEDM
from tinyedm_tpu.models.layers import Embedding as JaxEmbedding
from tinyedm_tpu.models.unet import Denoiser as JaxDenoiser
from tinyedm_tpu.parallel.mesh import _TP_OUT_AXIS, MODEL_AXIS, tp_param_spec
from tinyedm_tpu_torch.configs import CONFIGS, model_from_config
from tinyedm_tpu_torch.models.layers import CosineAttention
from tinyedm_tpu_torch.ops.fused_attention import cosine_attention_qkv_plain
from tinyedm_tpu_torch.parallel.audit import Collective
from tinyedm_tpu_torch.parallel.tensor import head_rows, tp_shards
from tinyedm_tpu_torch.utils.interop import _port_key

OPT_TP = {**OPT, "log_norms_per_layer": True}
DROPOUT, DROP_SEED = 0.1, 3
GEN = dict(num_samples=5, image_size=16, batch_size=4, num_steps=2)  # a tail batch of 1


def _gen_argv(out_dir, extra=()) -> list:
    return ["--config", "smoke", "--device", "cpu", "--output_dir", str(out_dir),
            *[f"--{k}={v}" for k, v in GEN.items()], *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of 2 ranks (a 1 x 2 grid) and one of 4 (2 x 2), and the
    one-process runs they are held against."""
    tmp = tmp_path_factory.mktemp("tp")
    start = _jax_start(torch.float32, tuple(sorted(OPT_TP.items())))
    batches = _batches()
    common = dict(start=_start_tensors(start), batches=batches, opt=OPT_TP, sigma_rels=SIGMA_RELS,
                  sched_count=SCHED_COUNT)
    dropout = dict(common, dropout_rate=DROPOUT, seed=DROP_SEED)
    _, _, port = small_models(10, torch.float32)
    x0 = torch.randn((4, 3, 16, 16), generator=torch.Generator().manual_seed(7))
    labels = torch.tensor([2, 9, 0, 4])
    sample = dict(state_dict={k: v.clone() for k, v in port.state_dict().items()}, x0=x0, labels=labels)
    n1 = worker.fit(0, 1, out_dir=str(tmp / "n1"), max_epochs=1)  # restored at N = 2 below
    two = worker.run("many", 2, tmp / "two", calls=[
        ("train_steps", {**dropout, "model_parallel": 2}),
        ("attention_layer", {"heads": 4}), ("attention_layer", {"heads": 1}),
        ("attention_layer", {"heads": 4, "fused": "block"}),
        ("sample", sample),
        ("fit", {"out_dir": str(tmp / "n2"), "model_parallel": 2, "previews": True}),
        ("restore", {"out_dir": str(tmp / "n2"), "model_parallel": 2}),
        ("restore", {"out_dir": str(tmp / "n1"), "model_parallel": 2}),
        ("generate_cli", {"argv": _gen_argv(tmp / "png2", ["--model_parallel", "2"])}),
        ("train_cli", {"argv": ["--config-name=smoke", "--device", "cpu", f"trainer.out_dir={tmp / 'cli'}",
                                "trainer.max_epochs=1", "trainer.model_parallel=2"]}),
    ], timeout=240)
    one_step = dict(common, batches=batches[:1])
    four = worker.run("many", 4, tmp / "four", calls=[
        ("train_steps", {**one_step, "model_parallel": 2}),
        ("train_steps", {**one_step, "model_parallel": 2, "zero1": True}),
    ], timeout=240)
    names = ("steps", "attn4", "attn1", "attn_block", "sample", "fit", "restore_n2", "restore_n1", "gen", "cli")
    out = {name: [r[i] for r in two] for i, name in enumerate(names)}
    out["grid"], out["grid_zero1"] = ([r[i] for r in four] for i in range(2))
    out["one_dropout"] = worker.train_steps(0, 1, grouped=False, **dropout)
    out["one_step"] = worker.train_steps(0, 1, grouped=False, **one_step)
    out["n1_fit"] = n1
    out["n1_restore_of_n2"] = worker.restore(0, 1, out_dir=str(tmp / "n2"))
    out["n1_restore_of_n1"] = worker.restore(0, 1, out_dir=str(tmp / "n1"))
    worker.generate_cli(0, 1, _gen_argv(tmp / "png1"))
    out["tmp"], out["sample_args"] = tmp, sample
    out["param_bytes"] = sum(v.numel() * 4 for v in common["start"]["params"].values())
    return out


def _trees(state: dict) -> list:
    return [("params", state["params"]), ("mu", state["mu"]), ("nu", state["nu"])] + [
        (f"ema{i}", t) for i, t in enumerate(state["ema"])]


def _inventory(result: dict, step: int = 0) -> list:
    raw = result["inventories"][step] if "inventories" in result else result["inventory"]
    return [Collective(*c) for c in raw]


# ----------------------------------------------------------------- the rule
def _jax_leaves(name: str) -> dict[str, tuple]:
    """Port key -> shape of every params leaf of the JAX model of config
    ``name`` (``jax.eval_shape``: nothing is drawn)."""
    cfg = CONFIGS[name]
    den = {k: v for k, v in cfg["denoiser"].items() if k != "dtype"}
    jmodel = JaxEDM(embedding=JaxEmbedding(**cfg["embedding"]), denoiser=JaxDenoiser(**den))
    side, channels = 8, den["in_channels"]
    labels = jnp.zeros((1,), jnp.int32) if cfg["embedding"]["num_classes"] else None
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, side, side, channels)),
                                                jnp.ones((1,)), labels))
    return {_port_key(tuple(k.key for k in path)): (tuple(leaf.shape), path[-1].key)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}


@pytest.mark.parametrize("name", ["smoke", "cifar10"])
@pytest.mark.parametrize("model_size", [2, 4])
def test_shard_rule_matches_jax_tp_param_spec(name, model_size):
    with torch.device("meta"):
        model = model_from_config(name)
    port = {k: tuple(p.shape) for k, p in model.named_parameters()}
    jax_leaves = _jax_leaves(name)
    assert set(jax_leaves) == set(port)
    shards = tp_shards(model, model_size)
    for key, (shape, leaf) in jax_leaves.items():
        spec = tp_param_spec(shape, model_size) if leaf == "w" else tp_param_spec((), model_size)
        jax_sharded = MODEL_AXIS in tuple(spec)
        assert (key in shards) == jax_sharded, key
        if jax_sharded:
            per = shape[_TP_OUT_AXIS[len(shape)]] // model_size
            assert all(len(rows) == per for rows in shards[key]) and port[key][0] // model_size == per, key
    assert shards, "nothing shards"


@pytest.mark.parametrize("heads, model_size", [(4, 2), (4, 4), (2, 2), (3, 2)])
def test_head_partition_simulated_ranks(heads, model_size):
    """Each rank's rows of qkv give, through the plain attention on its
    heads, its slice of the whole layer's attention output; where the heads
    do not divide the model group, the rows are a contiguous split and the
    layer gathers them (every head on every rank: the spawned cases below)."""
    channels, n = 8 * heads, 9
    layer = CosineAttention(channels, heads)
    rows = tp_shards(layer, model_size)["qkv_conv.weight"]
    qkv = torch.randn((2, n, 3 * channels), generator=torch.Generator().manual_seed(heads))
    whole = cosine_attention_qkv_plain(qkv, heads)
    if heads % model_size:
        per = 3 * channels // model_size
        assert [r.tolist() for r in rows] == [list(range(m * per, (m + 1) * per)) for m in range(model_size)]
        return
    c = channels // model_size
    for m in range(model_size):
        assert torch.equal(rows[m], head_rows(channels, heads, model_size, m))
        mine = cosine_attention_qkv_plain(qkv[..., rows[m]], heads // model_size)
        torch.testing.assert_close(mine, whole[..., m * c : (m + 1) * c], rtol=1e-6, atol=1e-6)
    assert sorted(torch.cat(rows).tolist()) == list(range(3 * channels))


@pytest.mark.parametrize("case, qkv_gathered", [("attn4", False), ("attn1", True), ("attn_block", False)])
def test_sharded_attention_layer_matches_whole(runs, case, qkv_gathered):
    for rank in runs[case]:
        whole, tp = rank["whole"], rank["tp"]
        torch.testing.assert_close(tp["y"], whole["y"], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(tp["dx"], whole["dx"], rtol=1e-5, atol=1e-5)
        for k in whole["dw"]:
            torch.testing.assert_close(tp["dw"][k], whole["dw"][k], rtol=1e-5, atol=1e-5, msg=k)
        inv = [Collective(*c) for c in tp["inventory"]]
        # (2, 16 tokens, C 16) fp32: the heads' outputs, or qkv, 3x that;
        # then the output's gather; the backward (on a thread of its own)
        # all-reduces each gather's gradient, last gather first
        assert [(c.kind, c.group, c.group_size) for c in inv] == (
            [("all_gather", "model", 2)] * 2 + [("all_reduce", "model", 2)] * 2)
        assert inv[0].bytes == inv[3].bytes == (3 if qkv_gathered else 1) * 2 * 16 * 16 * 4
        assert inv[1].bytes == inv[2].bytes == 2 * 16 * 16 * 4
        assert whole["inventory"] == []


# ------------------------------------------------------------- train steps
def test_1x2_grid_matches_one_process(runs):
    one = runs["one_dropout"]
    a, b = runs["steps"]
    for rank in (a, b):
        for mine, ref in zip(rank["metrics"], one["metrics"]):
            assert mine["train_loss"] == pytest.approx(ref["train_loss"], rel=1e-4)
            for k in ("grad_norm", "param_norm", "clip_scale"):
                assert mine[k] == pytest.approx(ref[k], rel=1e-4), k
            per_layer = [k for k in ref if "/" in k]
            assert per_layer and all(mine[k] == pytest.approx(ref[k], rel=1e-4, abs=1e-7) for k in per_layer)
        for (what, tree), (_, ref) in zip(_trees(rank["state"]), _trees(one["state"])):
            assert tree.keys() == ref.keys(), what
            for k in ref:
                torch.testing.assert_close(tree[k], ref[k], rtol=1e-3, atol=1e-5, msg=f"{what} {k}")
    for (_, x), (_, y) in zip(_trees(a["state"]), _trees(b["state"])):
        assert all(torch.equal(x[k], y[k]) for k in x)  # the ranks agree bit for bit


def test_1x2_grid_dropout_bits_are_one_process(runs):
    one = runs["one_dropout"]
    for rank in runs["steps"]:
        assert torch.equal(rank["bits"], one["bits"])


def test_1x2_grid_keeps_unit_rms_and_half_the_bytes(runs):
    one = runs["one_dropout"]
    for rank in runs["steps"]:
        assert rank["rms_dev"] <= 2e-4
        for what in ("param_bytes", "moment_bytes", "ema_bytes"):
            # the kernels halve; gains, conv_out and the uncertainty-free
            # heads replicate
            assert 0.45 * one[what] <= rank[what] <= 0.55 * one[what], (what, rank[what], one[what])


@pytest.mark.parametrize("case", ["grid", "grid_zero1"])
def test_2x2_grid_matches_one_process(runs, case):
    one = runs["one_step"]
    for rank in runs[case]:
        assert rank["metrics"][0]["train_loss"] == pytest.approx(one["metrics"][0]["train_loss"], rel=1e-5)
        for (what, tree), (_, ref) in zip(_trees(rank["state"]), _trees(one["state"])):
            for k in ref:
                b = ref[k].double()
                err = float((tree[k].double() - b).norm() / b.norm()) if float(b.norm()) else float(tree[k].abs().max())
                assert err <= 2e-5, (case, what, k, err)
    z1, grid = runs["grid_zero1"], runs["grid"]
    for r in range(4):  # the moments and EMA sharded over both axes
        assert z1[r]["moment_bytes"] <= 0.3 * one["moment_bytes"], (r, z1[r]["moment_bytes"])
        assert z1[r]["ema_bytes"] <= 0.3 * one["ema_bytes"]
        assert 0.45 * one["moment_bytes"] <= grid[r]["moment_bytes"] <= 0.55 * one["moment_bytes"]


# --------------------------------------------------------------- inventory
@pytest.mark.parametrize("case", ["grid", "grid_zero1"])
def test_2x2_step_has_model_psums_and_a_data_gradient_sync(runs, case):
    param_bytes = runs["param_bytes"]
    for rank in runs[case]:
        inv = _inventory(rank)
        assert {c.group for c in inv} == {"model", "data"}
        model = [c for c in inv if c.group == "model"]
        assert model and all(c.group_size == 2 for c in model)
        # each activation gather's backward psum, the replicated params' sum
        # and the norms'
        gathers = sum(c.kind == "all_gather" for c in model)
        assert 0 < gathers < sum(c.kind == "all_reduce" for c in model), "the gathers' backward lost its psums"
        sync = [c for c in inv if c.group == "data" and c.kind == "all_reduce"]
        assert len(sync) == 1 and sync[0].group_size == 2
        # the rank's shards and the replicated params, not the param tree
        assert rank["param_bytes"] <= sync[0].bytes <= 1.05 * rank["param_bytes"] + 1024
        assert max(c.bytes for c in inv) < param_bytes
        gathers = [c for c in inv if c.group == "data" and c.kind == "all_gather"]
        assert len(gathers) == (1 if case == "grid_zero1" else 0)


def test_1x2_step_makes_no_data_collective(runs):
    for rank in runs["steps"]:
        for step in range(3):
            inv = _inventory(rank, step)
            assert inv and {c.group for c in inv} == {"model"}
            assert max(c.bytes for c in inv) < runs["param_bytes"]
            assert 0 < sum(c.kind == "all_gather" for c in inv) < sum(c.kind == "all_reduce" for c in inv)


def test_sampler_makes_model_collectives_only(runs):
    for rank in runs["sample"]:
        inv = _inventory(rank)
        assert inv and {(c.kind, c.group, c.group_size) for c in inv} == {("all_gather", "model", 2)}
        assert max(c.bytes for c in inv) < runs["param_bytes"]
    for rank in runs["gen"]:
        kinds = {(c.kind, c.group) for c in _inventory(rank)}
        assert kinds == {("all_gather", "model"), ("barrier", "world")}


# ----------------------------------------------------------------- sampler
def test_tp_heun_matches_the_jax_solver(runs):
    jmodel, variables, _ = small_models(10, torch.float32)
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    args = runs["sample_args"]
    x0 = torch_to_nhwc(args["x0"])
    ref = np.asarray(jax.jit(lambda x, lab: JaxSolver(num_steps=3).solve(
        lambda xx, s, l: jmodel.apply(jvars, xx, s, l), x, lab))(jnp.asarray(x0), jnp.asarray(args["labels"].numpy())))
    for rank in runs["sample"]:
        out = torch_to_nhwc(rank["samples"])
        assert np.isfinite(out).all()
        assert rel_l2(out, ref) <= 1e-4
    assert torch.equal(runs["sample"][0]["samples"], runs["sample"][1]["samples"])
    assert nhwc_to_torch(x0).shape == args["x0"].shape


# ------------------------------------------------- checkpoints, fit, generate
def _equal(a: dict, b: dict) -> None:
    assert (a["step"], a["count"]) == (b["step"], b["count"])
    for (what, x), (_, y) in zip(_trees(a), _trees(b)):
        assert x.keys() == y.keys(), what
        assert all(torch.equal(x[k], y[k]) for k in x), what


def test_checkpoint_of_n2_restores_at_n1_bit_for_bit(runs):
    at_n1 = runs["n1_restore_of_n2"]["state"]
    for rank in runs["restore_n2"]:
        _equal(rank["state"], at_n1)
    for rank in runs["fit"]:  # the trained params are the saved ones
        assert all(torch.equal(rank["params"][k], at_n1["params"][k]) for k in at_n1["params"])


def test_checkpoint_of_n1_restores_at_n2_bit_for_bit(runs):
    at_n1 = runs["n1_restore_of_n1"]["state"]
    for rank in runs["restore_n1"]:
        _equal(rank["state"], at_n1)
    assert all(torch.equal(runs["n1_fit"]["params"][k], at_n1["params"][k]) for k in at_n1["params"])
    one_bytes = runs["n1_restore_of_n1"]["moment_bytes"]
    assert all(r["moment_bytes"] < 0.6 * one_bytes for r in runs["restore_n1"])


def test_fit_with_previews_writes_each_preview_once(runs):
    rank0, rank1 = runs["fit"]
    assert rank0["images"] == [("Generated", 0), ("Generated", 1)] and rank1["images"] == []
    assert rank0["logger_enabled"] and not rank1["logger_enabled"]
    assert rank0["writes"] == [4, 8] and rank1["writes"] == []
    assert rank0["global_step"] == rank1["global_step"] == 8
    assert all(torch.equal(rank0["params"][k], rank1["params"][k]) for k in rank0["params"])
    assert len(list((runs["tmp"] / "n2" / "images").glob("Generated_*.png"))) == 2


def test_generate_model_parallel_writes_every_row_once(runs):
    from tinyedm_tpu_torch.training.callbacks import read_png

    rank0, rank1 = runs["gen"]
    assert sorted(rank0["written"]) == list(range(GEN["num_samples"])) and rank1["written"] == []
    names = sorted(p.name for p in (runs["tmp"] / "png2").iterdir())
    assert names == sorted(p.name for p in (runs["tmp"] / "png1").iterdir())
    assert len(names) == GEN["num_samples"]
    for name in names:
        a = read_png(runs["tmp"] / "png2" / name).astype(np.int16)
        b = read_png(runs["tmp"] / "png1" / name).astype(np.int16)
        assert np.abs(a - b).max() <= 1, name


def test_yaml_model_parallel_trains_through_the_cli(runs):
    """``trainer.model_parallel: 2`` from the YAML (smoke.yaml, an override)
    trains its epoch on the 1 x 2 grid and saves once, whole."""
    from tinyedm_tpu_torch.training.checkpoint import load_checkpoint

    for rank in runs["cli"]:
        assert rank["model_size"] == 2 and rank["global_step"] == 8 and rank["steps"] == [8]
        assert len(rank["sharded"]) > 20
    state, config = load_checkpoint(runs["tmp"] / "cli" / "checkpoints")
    with torch.device("meta"):
        whole = dict(model_from_config("smoke").named_parameters())
    assert {k: tuple(v.shape) for k, v in state.params.items()} == {k: tuple(v.shape) for k, v in whole.items()}
    assert config is not None
