"""The port's Trainer and training CLI, against the JAX Trainer and alone.

Against JAX (the loop's trace; nothing depends on either framework's RNG):
both Trainers run one small spec on one ``SyntheticDataModule`` seed, their
step and eval functions replaced by recorders, for 2 epochs (4 steps each,
a validation set of 37 with its tail), and once interrupted mid-epoch and
resumed. The sequences of (global_step, epoch, schedule count, batch bytes)
and of the validation calls (step, epoch, the real rows' bytes), the steps
left on disk with ``latest_step``/``best_step``, the ``metrics.jsonl`` rows
(step, keys and every value but ``time`` and ``samples_per_sec``) and the
trainer's messages must be equal (exact).

The port alone, on the CPU (fp32, the smoke-size spec of the JAX e2e
tests): a real fit with checkpoints and previews; an interrupted-then-
resumed fit equal bit for bit to an uninterrupted one (params, Adam
moments, EMA); ``device_preprocess`` batches within 1 ulp of the host
pipeline's and trained weights within the JAX e2e test's rtol 2e-3 / atol
1e-4; a val set smaller than a batch; the per-profile val series; the final
save that carries the last val_loss; SIGTERM's preemption save; the
preview callbacks; the raises (``solve(use_ema=True)`` without EMA,
tensor parallelism, a batch the accumulation count does not split); the profiling
hooks; and ``train.main`` on ``smoke.yaml`` with ``--device cpu``,
resumed, then sampled by ``generate --ckpt_path --load_ema``.
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyedm_tpu.config import registry as jax_registry
from tinyedm_tpu.data import datamodules as jdm
from tinyedm_tpu.training.trainer import Trainer as JaxTrainer
from tinyedm_tpu_torch import generate as port_generate
from tinyedm_tpu_torch import train as port_train
from tinyedm_tpu_torch.config import registry
from tinyedm_tpu_torch.data import datamodules as pdm
from tinyedm_tpu_torch.diffusion.solver import DeterministicSolver
from tinyedm_tpu_torch.training.callbacks import Callback, GenerateCallback, LatentsGenerateCallback
from tinyedm_tpu_torch.training.trainer import Trainer

TINY = {
    "_target_": "tinyedm_tpu.training.experiment.EDMSpec",
    "diffuser": {"_target_": "tinyedm_tpu.diffusion.diffuser.Diffuser", "P_mean": -1.2, "P_std": 1.2},
    "embedding": {"_target_": "tinyedm_tpu.models.layers.Embedding", "fourier_dim": 8, "embedding_dim": 16,
                  "num_classes": 10},
    "denoiser": {
        "_target_": "tinyedm_tpu.models.unet.Denoiser", "in_channels": 1, "out_channels": 1, "embedding_dim": 16,
        "num_heads": 2, "sigma_data": 0.5, "encoder_block_types": ["Enc", "EncD"],
        "decoder_block_types": ["Dec", "DecU", "Dec", "Dec"], "encoder_out_channels": [8, 16],
        "decoder_out_channels": [16, 8, 8, 8], "skip_connections": [True, False, True, True],
        "dtype": "float32",
    },
    "use_ema": True, "ema_length": 0.13, "lr": 1e-3, "rampup_steps": 2, "steady_steps": 4,
    "scheduler_interval": "epoch",
}
DATA = dict(batch_size=16, image_size=8, num_channels=1, num_samples=64)
CONF = Path(__file__).resolve().parent.parent / "experiments" / "conf"


def _tiny(**changes) -> dict:
    return {**TINY, **changes}


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str((a.dtype, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def _val_value(step: int) -> float:
    return 1.0 + ((step * 5) % 7) / 4.0  # exact in fp32, not monotonic: retention prunes


def _jax_recorders(trainer, log):
    def train_step(state, batch, rng, sched_count):
        images, labels = batch
        log.append(("train", trainer.global_step, trainer.epoch, float(sched_count),
                    _digest(np.asarray(images), np.asarray(labels))))
        loss = jnp.float32(0.25 + 0.125 * trainer.global_step)
        return state.replace(step=state.step + 1), {
            "train_loss": loss, "learning_rate": jnp.float32(0.5), "sse": loss * 16, "count": jnp.float32(16)}

    def eval_step(state, batch, rng):
        images, labels, mask = (np.asarray(a) for a in batch)
        real = mask > 0
        log.append(("eval", trainer.global_step, trainer.epoch, _digest(images[real], labels[real])))
        n = float(real.sum())
        return {"sse": jnp.float32(_val_value(trainer.global_step) * n), "count": jnp.float32(n)}

    trainer._train_step, trainer._eval_step = train_step, eval_step


def _port_recorders(trainer, log):
    def nhwc(x):
        return x.permute(0, 2, 3, 1).contiguous().numpy()

    def train_step(state, batch, generator, sched_count):
        images, labels = batch
        log.append(("train", trainer.global_step, trainer.epoch, float(sched_count),
                    _digest(nhwc(images), labels.numpy().astype(np.int32))))
        loss = torch.tensor(0.25 + 0.125 * trainer.global_step)
        state.step += 1
        return state, {"train_loss": loss, "learning_rate": torch.tensor(0.5), "sse": loss * 16,
                       "count": torch.tensor(16.0)}

    def eval_step(state, batch, seed):
        images, labels = batch
        log.append(("eval", trainer.global_step, trainer.epoch,
                    _digest(nhwc(images), labels.numpy().astype(np.int32))))
        n = float(images.shape[0])
        return {"sse": torch.tensor(_val_value(trainer.global_step) * n), "count": torch.tensor(n)}

    trainer._train_step, trainer._eval_step = train_step, eval_step


def _make(framework, out_dir, interrupt_at=None, max_epochs=2, **kw):
    dm = (jdm if framework == "jax" else pdm).SyntheticDataModule(**DATA)
    dm.val_images, dm.val_labels = dm.val_images[:37], dm.val_labels[:37]
    common = dict(datamodule=dm, max_epochs=max_epochs, check_val_every_n_epoch=1, out_dir=out_dir,
                  ckpt_every_n_epochs=1, ckpt_top_k=2, log_every_n_steps=3, seed=0, **kw)
    if framework == "jax":
        trainer = JaxTrainer(spec=jax_registry.instantiate(TINY), config={"model": TINY, "seed": 0}, **common)
    else:
        trainer = Trainer(spec=registry.instantiate(TINY), config={"model": TINY, "seed": 0}, device="cpu",
                          **common)
    if interrupt_at is not None:
        original = dm.train_batches

        def interrupting(epoch, **kwargs):
            for i, b in enumerate(original(epoch, **kwargs)):
                if (epoch, i) == interrupt_at:
                    trainer._interrupted = True
                yield b

        dm.train_batches = interrupting
    return trainer


def _trace(framework, tmp_path, capsys, runs):
    """The recorded calls, saves, metrics rows and messages of ``runs``
    ((interrupt_at, resume) pairs) in one run directory."""
    log = []
    out_dir = tmp_path / framework
    for interrupt_at, resume in runs:
        trainer = _make(framework, out_dir, interrupt_at)
        (_jax_recorders if framework == "jax" else _port_recorders)(trainer, log)
        trainer.fit(resume=resume)
        trainer.ckpt.wait()
    kept = sorted(int(p.name) for p in (out_dir / "checkpoints").iterdir() if p.name.isdigit())
    rows = [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
    rows = [{k: v for k, v in r.items() if k not in ("time", "samples_per_sec")} | {"keys": sorted(r)}
            for r in rows]
    messages = [line for line in capsys.readouterr().out.splitlines() if line.startswith("[trainer]")]
    return log, kept, trainer.ckpt.latest_step, trainer.ckpt.best_step, rows, messages


@pytest.mark.parametrize("runs", [
    [(None, False)],
    [((0, 2), False), (None, True)],  # stopped after step 3 of 4, resumed
], ids=["two_epochs", "mid_epoch_resume"])
def test_loop_trace_matches_jax(runs, tmp_path, capsys):
    jax_trace = _trace("jax", tmp_path, capsys, runs)
    port_trace = _trace("port", tmp_path, capsys, runs)
    assert port_trace == jax_trace
    log = port_trace[0]
    assert [e[1] for e in log if e[0] == "train"] == list(range(8))
    assert sum(e[0] == "eval" for e in log) == 2 * 3  # two validations of 16 + 16 + 5 rows
    if len(runs) > 1:
        assert any("skipping 3 consumed batches" in m for m in port_trace[5])


# ------------------------------------------------------------ the port alone
def _port(tmp_path, max_epochs=2, spec_cfg=None, dm=None, **kw):
    kw.setdefault("check_val_every_n_epoch", 1)
    kw.setdefault("ckpt_every_n_epochs", 1)
    return Trainer(spec=registry.instantiate(spec_cfg or TINY), datamodule=dm or pdm.SyntheticDataModule(**DATA),
                   max_epochs=max_epochs, out_dir=tmp_path / "run", log_every_n_steps=2, seed=0,
                   config={"model": spec_cfg or TINY, "seed": 0}, device="cpu", **kw)


def _trees(state):
    return [state.params, state.mu, state.nu, *state.ema]


def test_fit_checkpoints_previews_and_metrics(tmp_path):
    cb = GenerateCallback(DeterministicSolver(num_steps=3), img_shape=(1, 8, 8), num_samples=4, every_n_epochs=1)
    trainer = _port(tmp_path, callbacks=[cb])
    trainer.fit()
    assert trainer.global_step == 8 and trainer.state.step == 8 and trainer.state.count == 8
    rows = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if "val_loss" in r] == [4, 8]
    assert [r["step"] for r in rows if "samples_per_sec" in r] == [4, 8]
    assert all(np.isfinite(r["train_loss"]) for r in rows if "train_loss" in r)
    assert sorted(p.name for p in (tmp_path / "run" / "images").iterdir()) == [
        "Generated_0000000.png", "Generated_0000001.png"]
    assert trainer.ckpt.all_steps == [4, 8]
    restored, config = trainer.ckpt.restore()
    assert config == {"model": TINY, "seed": 0} and restored.step == 8
    for live, saved in zip(_trees(trainer.state), _trees(restored)):
        assert all(torch.equal(live[k], saved[k]) for k in live)


def test_resumed_fit_is_bitwise_equal_to_uninterrupted(tmp_path):
    ref = _port(tmp_path / "ref")
    ref.fit()
    first = _port(tmp_path / "pre")
    original = first.datamodule.train_batches

    def interrupting(epoch, **kw):
        for i, b in enumerate(original(epoch, **kw)):
            if (epoch, i) == (0, 2):
                first._interrupted = True
            yield b

    first.datamodule.train_batches = interrupting
    first.fit()
    assert first.global_step == 3 and first.ckpt.latest_step == 3
    resumed = _port(tmp_path / "pre")
    resumed.fit(resume=True)
    assert resumed.global_step == 8
    for a, b in zip(_trees(ref.state), _trees(resumed.state)):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert ref.state.count == resumed.state.count


class _FlippySynthetic(pdm.SyntheticDataModule):
    raw_flip = True

    def _flip_flags(self, n, rng):
        return rng.random(n) < 0.5


def test_device_preprocess_matches_host_pipeline(tmp_path):
    trainer = _port(tmp_path / "dev", dm=_FlippySynthetic(**DATA), device_preprocess=True)
    assert trainer.device_preprocess
    dm = trainer.datamodule
    for raw, host in zip(dm.train_batches_raw(1), dm.train_batches(1)):
        x, y = trainer._to_device(raw)
        hx, hy = pdm.to_device(*host, "cpu")
        torch.testing.assert_close(x, hx, rtol=0, atol=2**-23)  # 1 ulp in [-1, 1]
        assert torch.equal(y, hy)
    params = {}
    for name, dev_pre in (("host", False), ("device", True)):
        t = _port(tmp_path / name, dm=_FlippySynthetic(**DATA), device_preprocess=dev_pre)
        t.fit()
        params[name] = _trees(t.state)
    for a, b in zip(params["host"], params["device"]):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=2e-3, atol=1e-4)


def test_small_val_set_gives_a_real_val_loss(tmp_path):
    dm = pdm.SyntheticDataModule(**DATA)
    dm.val_images, dm.val_labels = dm.val_images[:5], dm.val_labels[:5]
    trainer = _port(tmp_path, spec_cfg=_tiny(use_ema=False), dm=dm)
    trainer.state = trainer._init_state()
    val = trainer.validate()
    assert val is not None and val > 0.01
    dm.val_images, dm.val_labels = dm.val_images[:0], dm.val_labels[:0]
    assert trainer.validate() is None


def test_per_profile_val_series(tmp_path):
    trainer = _port(tmp_path, spec_cfg=_tiny(ema_lengths=[0.05, 0.13], val_ema_index=1))
    trainer.fit()
    rows = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    rec = [r for r in rows if "val_loss/ema_0.05" in r][-1]
    assert "val_loss/ema_0.13" in rec and rec["val_loss"] == rec["val_loss/ema_0.13"]
    assert rec["val_loss/ema_0.05"] != rec["val_loss"]


def test_final_save_carries_the_last_val_loss(tmp_path):
    trainer = _port(tmp_path, max_epochs=1, spec_cfg=_tiny(use_ema=False), ckpt_every_n_epochs=100)
    trainer.fit()
    assert trainer.ckpt.latest_step == trainer.global_step == trainer.ckpt.best_step == 4


def test_solve_with_ema_needs_ema(tmp_path):
    trainer = _port(tmp_path, max_epochs=1, spec_cfg=_tiny(use_ema=False))
    trainer.fit()
    solver = DeterministicSolver(num_steps=2)
    x0, labels = torch.zeros((2, 1, 8, 8)), torch.tensor([0, 1])
    with pytest.raises(ValueError, match="no EMA"):
        trainer.solve(solver, x0, labels, use_ema=True)
    assert torch.isfinite(trainer.solve(solver, x0, labels)).all()
    assert torch.isfinite(trainer.solve(solver, x0, labels, guidance_scale=2.0)).all()
    with pytest.raises(ValueError, match="class labels"):
        trainer.solve(solver, x0, None, guidance_scale=2.0)


def test_sigterm_checkpoints_and_stops(tmp_path, capsys):
    class Preempt(Callback):
        def on_train_epoch_end(self, trainer) -> None:
            os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    trainer = _port(tmp_path, max_epochs=5, spec_cfg=_tiny(use_ema=False), callbacks=[Preempt()],
                    ckpt_every_n_epochs=100)
    trainer.fit()
    assert trainer.global_step == 4 and trainer.ckpt.latest_step == 4
    assert "preemption signal received" in capsys.readouterr().out
    assert signal.getsignal(signal.SIGTERM) is before
    again = _port(tmp_path, max_epochs=2, spec_cfg=_tiny(use_ema=False))
    again.fit(resume=True)
    assert again.global_step == 8


def test_latents_callback_logs_latents_without_a_vae(tmp_path, capsys):
    cb = LatentsGenerateCallback(DeterministicSolver(num_steps=3), img_shape=(1, 8, 8), mean=(0.1,), std=(0.5,),
                                 num_samples_per_class=2, num_classes=2, every_n_epochs=1)
    trainer = _port(tmp_path, max_epochs=1, callbacks=[cb])
    trainer.fit()
    assert list((tmp_path / "run" / "images").glob("Generated_*.png"))
    assert "VAE unavailable" in capsys.readouterr().out
    assert cb.class_labels.tolist()[:2] == cb.class_labels.tolist()[2:]


def test_multi_gpu_options_raise(tmp_path):
    """Tensor parallelism needs a world that the model group divides: one
    process raises the grid's ``ValueError`` (over ranks it trains:
    tests/test_torch_tensor_parallel.py; zero1 and --multihost:
    tests/test_torch_dist_trainer.py)."""
    with pytest.raises(ValueError, match="1 ranks not divisible by model_parallel=2"):
        _port(tmp_path, model_parallel=2)
    assert not (tmp_path / "run").exists()


def test_cli_trains_resumes_and_samples_on_smoke(tmp_path, capsys):
    run = tmp_path / "run"
    args = ["--config-name=smoke", "--device", "cpu", f"trainer.out_dir={run}", "trainer.max_epochs=1"]
    trainer = port_train.main(args)
    assert trainer.global_step == 8 and trainer.ckpt.all_steps == [8]
    assert trainer.spec.conditional and trainer.model.denoiser.dtype is torch.bfloat16
    trainer = port_train.main(args + ["--resume", "--max-epochs", "2"])
    out = capsys.readouterr().out
    assert "[trainer] resumed at step 8 (epoch 1)" in out
    assert trainer.global_step == 16 and trainer.ckpt.all_steps == [8, 16]
    assert len(list((run / "images").glob("Generated_*.png"))) == 2
    port_generate.main(["--ckpt_path", str(run / "checkpoints"), "--load_ema", "--output_dir",
                        str(tmp_path / "samples"), "--num_samples", "3", "--batch_size", "2", "--image_size", "16",
                        "--num_steps", "2", "--device", "cpu"])
    assert "EMA weights loaded." in capsys.readouterr().out
    assert sorted(p.name for p in (tmp_path / "samples").iterdir()) == ["0.png", "1.png", "2.png"]


def test_uneven_accumulation_raises_as_the_jax_cli(tmp_path):
    """A step batch that the accumulation count does not split raises at the
    first step, as the JAX training CLI raises on imagenet.yaml's 176 / 3."""
    trainer = _port(tmp_path, max_epochs=1, spec_cfg=_tiny(accum_steps=3))
    with pytest.raises(ValueError, match="does not split into 3 equal microbatches"):
        trainer.fit()


def test_profiling_hooks_on_the_cpu(tmp_path):
    from tinyedm_tpu_torch.utils.profiling import span, trace

    with trace(tmp_path / "profile") as prof:
        with span("tinyedm.test_region"):
            torch.ones(64).sum()
    written = (tmp_path / "profile" / "trace.json").read_text()
    assert prof.key_averages() and '"tinyedm.test_region"' in written
