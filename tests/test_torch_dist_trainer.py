"""The port's data parallelism and ZeRO-1 over 2 ranks on the CPU (gloo), each
run spawned by ``tests/_torch_dist_worker.py`` with a timeout of its own.

- Three steps of the smoke model in fp32 (2 microbatches, clipping and the
  norm metrics on, dropout 0), the diffuser's draws a function of each image
  (``ContentDiffuser``, the same rows on any rank): data parallel against
  the JAX step on a 2-device mesh and against the port's step in one
  process at the global batch, within ``tests/test_torch_train_step.py``'s
  2e-5 per tensor and 1e-4 for the metrics; ZeRO-1 bit-equal to data
  parallel in params, moments and EMA, and against the JAX ZeRO-1 step
  within 2e-5, each rank keeping about half the moment and EMA bytes; with
  dropout on the two ranks draw different bits and end with equal params.
- The padded validation of the JAX package's
  ``test_padded_validation_exact_on_nondivisible_val_set`` (batch 16, a val
  set of 20, and of 21, whose tail of 5 takes a pad row on 2 ranks): 2 ranks,
  1 process and the JAX Trainer on a 2-device mesh, all on JAX's draws, give
  one val_loss within 1e-6 relative.
- ``Trainer.fit`` of the tiny spec on 2 ranks, data parallel and ZeRO-1: only
  rank 0 logs and writes, the ranks end with the same params bit for bit,
  the ZeRO-1 checkpoints equal the data-parallel ones bit for bit, and a
  2-rank checkpoint resumes in one process.
- ``train --multihost`` as two torchrun-style processes (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).
- ``generate`` on 2 ranks writes the PNGs of one process byte for byte,
  with a tail batch that takes a pad row, with Heun and with churn.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import _torch_dist_worker as worker
from tests.test_torch_train_step import IMAGE, _compare_trees, _jax_model, _jax_start
from tinyedm_tpu.config import registry as jax_registry
from tinyedm_tpu.data.datamodules import SyntheticDataModule as JaxSynthetic
from tinyedm_tpu.diffusion.diffuser import Diffuser as JaxDiffuser
from tinyedm_tpu.parallel.mesh import ShardingPlan, make_mesh, place_state, shard_batch
from tinyedm_tpu.training import train_step as jts
from tinyedm_tpu.training.ema import EMAConfig as JaxEMAConfig
from tinyedm_tpu.training.trainer import Trainer as JaxTrainer
from tinyedm_tpu_torch.training.checkpoint import CheckpointManager
from tinyedm_tpu_torch.training.state import TrainState
from tinyedm_tpu_torch.utils.cuda import fold_seed
from tinyedm_tpu_torch.utils.interop import train_state_from_jax

ROOT = Path(__file__).resolve().parent.parent
OPT = dict(lr=0.01, rampup_steps=2, steady_steps=2, accum_steps=2, grad_clip_norm=1.0, log_norms=True)
SIGMA_RELS = (0.13, 0.05)
SCHED_COUNT = 10
GLOBAL_BATCH = 4  # 2 ranks x 2 rows, 2 microbatches of 1 on each


class _JaxContent(JaxDiffuser):
    """``ContentDiffuser`` on the JAX side (NHWC)."""

    def __call__(self, rng, clean_image):
        x = clean_image.astype(jnp.float32)
        eps = 1.5 * (x[:, 0, 0, 0] + x[:, -1, -1, -1])
        sigma = jnp.exp(self.P_mean + eps * self.P_std)
        return x + 1.5 * x[:, ::-1, ::-1, ::-1] * sigma.reshape(-1, 1, 1, 1), sigma


def _batches():
    dm = JaxSynthetic(GLOBAL_BATCH, image_size=IMAGE[1], num_samples=3 * GLOBAL_BATCH, seed=5)
    return list(dm.train_batches(0))


def _start_tensors(start) -> dict:
    state = train_state_from_jax(start)
    return {"step": state.step, "count": state.count, "params": state.params, "constants": state.constants,
            "mu": state.mu, "nu": state.nu, "ema": list(state.ema)}


def _jax_steps(start, batches, zero1: bool) -> dict:
    mesh = make_mesh(num_devices=2)
    jstate = place_state(mesh, jax.tree_util.tree_map(jnp.asarray, start), zero1=zero1)
    step = ShardingPlan(mesh, zero1=zero1).jit_train_step(
        jts.make_train_step(_jax_model(torch.float32), _JaxContent(), jts.OptimizerConfig(**OPT),
                            JaxEMAConfig(SIGMA_RELS)), state=jstate)
    metrics = []
    for images, labels in batches:
        jstate, m = step(jstate, shard_batch(mesh, (images, labels)), jax.random.PRNGKey(1),
                         jnp.asarray(float(SCHED_COUNT)))
        metrics.append({k: float(v) for k, v in m.items()})
    ref = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate))
    return {"state": ref, "metrics": metrics}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """2-rank data parallel, ZeRO-1 and dropout runs (one spawn), the port's
    one-process run, and the JAX mesh steps."""
    start = _jax_start(torch.float32, tuple(sorted(OPT.items())))
    batches = _batches()
    common = dict(start=_start_tensors(start), batches=batches, opt=OPT, sigma_rels=SIGMA_RELS,
                  sched_count=SCHED_COUNT)
    dp, z1, drop = zip(*worker.run("many", 2, tmp_path_factory.mktemp("steps"), calls=[
        ("train_steps", common), ("train_steps", {**common, "zero1": True}),
        ("train_steps", {**common, "dropout_rate": 0.1, "seed": 3}),
    ]))
    one = worker.train_steps(0, 1, grouped=False, **common)
    return dict(dp=dp, zero1=z1, dropout=drop, one=one, start=start, batches=batches)


def _equal_states(a: dict, b: dict) -> bool:
    trees = [(a["params"], b["params"]), (a["mu"], b["mu"]), (a["nu"], b["nu"])] + list(zip(a["ema"], b["ema"]))
    return (a["step"], a["count"]) == (b["step"], b["count"]) and all(
        x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x) for x, y in trees)


def _held(state: dict, ref, bound: float = 2e-5) -> None:
    assert (state["step"], state["count"]) == (ref.step, ref.count)
    _compare_trees(state["params"], ref.params, bound, "params")
    _compare_trees(state["mu"], ref.mu, bound, "mu")
    _compare_trees(state["nu"], ref.nu, bound, "nu")
    for tree, rtree in zip(state["ema"], ref.ema):
        _compare_trees(tree, rtree, bound, "ema")


def _metrics_close(ours: list[dict], ref: list[dict]) -> None:
    for m, r in zip(ours, ref):
        m = {k: v for k, v in m.items() if k != "interrupt"}
        assert set(m) == set(r)
        for k, v in m.items():
            assert abs(v - r[k]) <= 1e-4 * abs(r[k]) + 1e-7, (k, v, r[k])


def test_dp_step_matches_the_jax_mesh_step_and_one_process(steps):
    dp = steps["dp"]
    assert _equal_states(dp[0]["state"], dp[1]["state"])  # the ranks agree bit for bit
    assert dp[0]["metrics"] == dp[1]["metrics"]
    ref = _jax_steps(steps["start"], steps["batches"], zero1=False)
    _held(dp[0]["state"], ref["state"])
    _metrics_close(dp[0]["metrics"], ref["metrics"])
    one = steps["one"]
    _held(dp[0]["state"], _as_state(one["state"]))
    _metrics_close(dp[0]["metrics"], one["metrics"])


def _as_state(d: dict) -> TrainState:
    return TrainState(step=d["step"], params=d["params"], constants={}, mu=d["mu"], nu=d["nu"], count=d["count"],
                      ema=tuple(d["ema"]))


def test_zero1_is_bit_equal_to_dp_and_matches_the_jax_zero1_step(steps):
    dp, z1 = steps["dp"], steps["zero1"]
    for r in range(2):
        assert _equal_states(z1[r]["state"], dp[r]["state"])
        assert z1[r]["metrics"] == dp[r]["metrics"]
        # each rank keeps about half of the moment and EMA bytes
        assert 0.45 <= z1[r]["moment_bytes"] / dp[r]["moment_bytes"] <= 0.55
        assert 0.45 <= z1[r]["ema_bytes"] / dp[r]["ema_bytes"] <= 0.55
    ref = _jax_steps(steps["start"], steps["batches"], zero1=True)
    _held(z1[0]["state"], ref["state"])
    _metrics_close(z1[0]["metrics"], ref["metrics"])


def test_ranks_draw_their_own_dropout_bits(steps):
    a, b = steps["dropout"]
    assert a["bits"] is not None and a["bits"].shape == b["bits"].shape
    assert not torch.equal(a["bits"], b["bits"])
    assert _equal_states(a["state"], b["state"])  # one update, all the same
    assert all(np.isfinite(m["train_loss"]) for m in a["metrics"])


# ------------------------------------------------------------------ validation
def _jax_val(val_rows: int, out_dir) -> tuple[float, dict, dict]:
    """The JAX Trainer's val_loss on a 2-device mesh from its seeded init,
    that state (numpy leaves), and its eval draws of every padded row by the
    seed of the port's per-sample generator for that row."""
    dm = JaxSynthetic(**worker.DATA)
    dm.val_images, dm.val_labels = dm.train_images[:val_rows], dm.train_labels[:val_rows]
    trainer = JaxTrainer(spec=jax_registry.instantiate(worker.TINY), datamodule=dm, seed=0,
                         mesh=make_mesh(num_devices=2), out_dir=out_dir)
    trainer.datamodule.setup("fit")
    trainer.state = trainer._init_state()
    val_loss = trainer.validate()
    key = jax.random.PRNGKey(0 + 777)  # the JAX Trainer's validation key
    draws = {}
    for i, start in enumerate(range(0, val_rows, dm.batch_size)):
        n = min(dm.batch_size, val_rows - start)
        batch_seed = fold_seed(0 + 777, i) % 2**32  # the port Trainer's
        for j in range(n + n % 2):
            k_sigma, k_noise = jax.random.split(jax.random.fold_in(jax.random.fold_in(key, i), j))
            draws[fold_seed(batch_seed, j)] = (np.asarray(jax.random.normal(k_sigma, (1,))),
                                               np.asarray(jax.random.normal(k_noise, (1, 8, 8, 1))))
    return val_loss, jax.tree_util.tree_map(np.asarray, trainer.state), draws


@pytest.mark.parametrize("val_rows", [20, 21])
def test_padded_validation_matches_one_process_and_jax(tmp_path, val_rows):
    jax_loss, jstate, draws = _jax_val(val_rows, tmp_path / "jax")
    start = _start_tensors(jstate)
    args = dict(out_dir=str(tmp_path / "run"), val_rows=val_rows, start=start, draws=draws)
    ranks = worker.run("validate", 2, tmp_path, **args)
    one = worker.validate(0, 1, **args)
    assert ranks[0]["val_loss"] == ranks[1]["val_loss"]
    for loss in (ranks[0]["val_loss"], one["val_loss"]):
        assert abs(loss - jax_loss) <= 1e-6 * abs(jax_loss), (loss, jax_loss)
    assert abs(ranks[0]["val_loss"] - one["val_loss"]) <= 1e-6 * abs(one["val_loss"])


# ------------------------------------------------------------------------- fit
@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fits")
    dp, z1, stopped, local = zip(*worker.run("many", 2, tmp, calls=[
        ("fit", {"out_dir": str(tmp / "dp")}), ("fit", {"out_dir": str(tmp / "zero1"), "zero1": True}),
        ("fit", {"out_dir": str(tmp / "stopped"), "interrupt": (1, 0, 1)}),
        ("fit", {"out_dir": str(tmp / "local"), "process_local": True})]))
    return tmp, dp, z1, stopped, local


def test_fit_rank0_writes_and_the_ranks_agree(fits):
    tmp, dp, z1, *_ = fits
    for run, name in ((dp, "dp"), (z1, "zero1")):
        assert [r["writes"] for r in run] == [[4, 8], []]
        assert [r["logger_enabled"] for r in run] == [True, False]
        assert [(r["global_step"], r["latest_step"]) for r in run] == [(8, 8), (8, 8)]
        assert all(torch.equal(run[0]["params"][k], run[1]["params"][k]) for k in run[0]["params"])
        rows = [json.loads(line) for line in (tmp / name / "metrics.jsonl").read_text().splitlines()]
        val_steps = [r["step"] for r in rows if "val_loss" in r]
        epoch_steps = [r["step"] for r in rows if "samples_per_sec" in r]
        assert val_steps == epoch_steps == [4, 8]  # one writer: no row twice
        assert all(np.isfinite(r["val_loss"]) for r in rows if "val_loss" in r)
    assert 0.45 <= z1[0]["moment_bytes"] / dp[0]["moment_bytes"] <= 0.55


def test_one_ranks_signal_stops_every_rank_after_the_same_step(fits):
    """Rank 1 alone is signalled as it draws batch 1; the flag rides step 1's
    all-reduce, every rank reads it after queueing step 2 and leaves the loop
    there, and rank 0 writes the preemption save."""
    tmp, _, _, stopped, _ = fits
    assert [(r["global_step"], r["latest_step"]) for r in stopped] == [(3, 3), (3, 3)]
    assert [r["writes"] for r in stopped] == [[3], []]
    assert all(torch.equal(stopped[0]["params"][k], stopped[1]["params"][k]) for k in stopped[0]["params"])
    assert [p.name for p in (tmp / "stopped" / "checkpoints").iterdir()] == ["3"]


def test_trainer_takes_a_process_local_data_module_as_is(fits):
    """A data module that yields only its rank's rows of each global batch
    (``yields_process_local``, as latpack does) is not sliced again: the same
    run as the trainer slicing the global batches, bit for bit."""
    _, dp, _, _, local = fits
    for a, b in zip(dp, local):
        assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])


def test_zero1_fit_checkpoints_are_the_dp_checkpoints(fits):
    tmp = fits[0]
    for step in (4, 8):
        a, _ = CheckpointManager(tmp / "dp" / "checkpoints").restore(step)
        b, _ = CheckpointManager(tmp / "zero1" / "checkpoints").restore(step)
        trees = [(a.params, b.params), (a.constants, b.constants), (a.mu, b.mu), (a.nu, b.nu)]
        assert (a.step, a.count, len(a.ema)) == (b.step, b.count, len(b.ema)) == (step, step, 1)
        for x, y in trees + list(zip(a.ema, b.ema)):
            assert x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)


@pytest.mark.parametrize("zero1", [False, True], ids=["dp", "zero1"])
def test_two_rank_checkpoint_resumes_in_one_process(fits, tmp_path, capsys, zero1):
    import shutil

    run = tmp_path / "run"
    shutil.copytree(fits[0] / ("zero1" if zero1 else "dp"), run)
    saved, _ = CheckpointManager(run / "checkpoints").restore(8)
    trainer = worker._trainer(str(run), zero1=zero1, max_epochs=3, check_val_every_n_epoch=1,
                              ckpt_every_n_epochs=1)
    trainer.datamodule.setup("fit")
    trainer.restore()
    assert all(torch.equal(trainer.state.params[k], saved.params[k]) for k in saved.params)
    trainer.fit(resume=True)
    assert "[trainer] resumed at step 8 (epoch 2)" in capsys.readouterr().out
    assert trainer.global_step == 12 and trainer.ckpt.latest_step == 12
    assert all(torch.isfinite(p).all() for p in trainer.state.params.values())


# ------------------------------------------------------------------------- CLI
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _torchrun_ranks(cmd: list, env: dict, run: Path, tries: int = 3) -> tuple[list, list]:
    """Two ranks of ``cmd`` under torchrun's environment variables; their
    return codes and outputs. Rank 0's store binds ``MASTER_PORT`` only after
    it starts, so another process may take the free port first: then the
    ranks are stopped and started again on another port."""
    for _ in range(tries):
        env = {**env, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()), "WORLD_SIZE": "2"}
        procs = [subprocess.Popen(cmd, cwd=ROOT, env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
        outs = []
        try:
            outs.append(procs[0].communicate(timeout=worker.TIMEOUT)[0])
            if procs[0].returncode != 0 and "EADDRINUSE" in outs[0]:
                shutil.rmtree(run, ignore_errors=True)
                continue
            outs.append(procs[1].communicate(timeout=worker.TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        return [p.returncode for p in procs], outs
    raise AssertionError(f"rank 0 found its port taken {tries} times:\n{outs[0]}")


def test_train_multihost_cli_under_torchrun_environment(tmp_path):
    run = tmp_path / "run"
    cmd = [sys.executable, "-m", "tinyedm_tpu_torch.train", "--config-name=smoke", "--multihost", "--device", "cpu",
           f"trainer.out_dir={run}", "trainer.max_epochs=1", "datamodule.num_samples=64", "trainer.zero1=true"]
    codes, outs = _torchrun_ranks(cmd, {**os.environ, "OMP_NUM_THREADS": "1"}, run)
    assert codes == [0, 0], outs
    assert "device: cpu" in outs[0] and "[trainer]" not in outs[1]
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if "samples_per_sec" in r] == [4]  # 4 steps of 16 = 2 x 8
    assert all(np.isfinite(r["val_loss"]) for r in rows if "val_loss" in r)
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["4"]
    assert [p.name for p in (run / "images").iterdir()] == ["Generated_0000000.png"]


# -------------------------------------------------------------------- generate
CHURN = dict(s_churn=40.0, s_min=0.05, s_max=50.0, s_noise=1.003)


def test_generate_on_two_ranks_writes_the_one_process_pngs(tmp_path):
    from tinyedm_tpu_torch.generate import generate

    kw = dict(num_samples=7, image_size=16, batch_size=4, config="smoke", num_steps=3, seed=1)
    worker.run("many", 2, tmp_path, calls=[
        ("generate", {**kw, "output_dir": str(tmp_path / "heun-2")}),
        ("generate", {**kw, **CHURN, "output_dir": str(tmp_path / "churn-2")}),
    ])
    for name, extra in (("heun", {}), ("churn", CHURN)):
        generate(str(tmp_path / f"{name}-1"), device="cpu", **kw, **extra)
        one, two = tmp_path / f"{name}-1", tmp_path / f"{name}-2"
        names = sorted(p.name for p in one.iterdir())
        assert names == sorted(p.name for p in two.iterdir()) == [f"{i}.png" for i in range(7)]
        assert all((one / n).read_bytes() == (two / n).read_bytes() for n in names), name
