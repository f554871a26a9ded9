"""The port's training and generation CLIs against the JAX package's surface.

- ``trainer.accumulate_grad_batches`` with a step batch it does not split
  raises before the trainer is built, naming the override of Lightning's
  reading (``imagenet.yaml``: 176 / 3 -> ``datamodule.batch_size=528``);
  with that override the smoke config trains through the CLI and every step
  sees 3 equal microbatches.
- ``generate``'s parser accepts every option of the JAX CLI's (the JAX
  parser is captured from ``tinyedm_tpu.generate.main``, not listed by
  hand); ``--num_channels`` must agree with the model, ``--num_workers`` is
  taken and unused.
"""

from __future__ import annotations

import argparse
from collections import Counter

import pytest

from tinyedm_tpu import generate as jax_generate
from tinyedm_tpu_torch import generate as port_generate
from tinyedm_tpu_torch import train as port_train
from tinyedm_tpu_torch.models.edm import EDM


class _Captured(Exception):
    pass


def _options(main, monkeypatch) -> set[str]:
    """The option strings of the parser that ``main`` builds."""
    seen = []

    def capture(self, args=None, namespace=None):
        seen.append(self)
        raise _Captured

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Captured):
        main([])
    monkeypatch.undo()
    return {s for action in seen[0]._actions for s in action.option_strings}


@pytest.fixture(scope="module")
def smoke_run(tmp_path_factory):
    """The smoke config through the CLI with 3 microbatches of 16 per step;
    returns (run directory, training microbatch sizes seen, trainer)."""
    run = tmp_path_factory.mktemp("accum") / "run"
    sizes = Counter()
    forward = EDM.denoise_with_aux

    def counted(self, noisy, sigma, labels=None, train=False, **kw):
        if train:
            sizes[noisy.shape[0]] += 1
        return forward(self, noisy, sigma, labels, train=train, **kw)

    EDM.denoise_with_aux = counted
    try:
        trainer = port_train.main(["--config-name=smoke", "--device", "cpu", f"trainer.out_dir={run}",
                                   "trainer.max_epochs=1", "trainer.accumulate_grad_batches=3",
                                   "datamodule.batch_size=48", "datamodule.num_samples=96"])
    finally:
        EDM.denoise_with_aux = forward
    return run, sizes, trainer


def test_lightning_reading_trains_through_the_cli(smoke_run):
    _, sizes, trainer = smoke_run
    assert trainer.spec.accum_steps == 3 and trainer.global_step == 2
    assert sizes == Counter({16: 3 * 2})


@pytest.mark.parametrize("config, batch, accum", [("smoke", 16, 3), ("imagenet", 176, 3)])
def test_uneven_accumulation_raises_before_training_and_names_the_override(config, batch, accum, tmp_path):
    args = ["--config-name=" + config, "--device", "cpu", f"trainer.out_dir={tmp_path / 'run'}",
            f"trainer.accumulate_grad_batches={accum}"]
    with pytest.raises(ValueError, match=f"does not split into {accum} equal microbatches") as err:
        port_train.main(args)
    assert f"datamodule.batch_size={batch * accum}" in str(err.value)
    assert not (tmp_path / "run").exists()  # raised before the trainer made its directories
    port_train.check_accumulation(4 * 32, 4)  # imagenet512.yaml: 128 in 4 microbatches of 32


def test_generate_accepts_every_option_of_the_jax_cli(monkeypatch):
    jax_options = _options(jax_generate.main, monkeypatch)
    port_options = _options(port_generate.main, monkeypatch)
    assert {"--num_channels", "--num_workers", "--ckpt_path", "--model_parallel"} <= jax_options
    assert jax_options <= port_options, sorted(jax_options - port_options)


def test_num_channels_must_agree_with_the_model(smoke_run, tmp_path, capsys):
    run = smoke_run[0]
    common = ["--ckpt_path", str(run / "checkpoints"), "--load_ema", "--num_samples", "2", "--batch_size", "2",
              "--image_size", "16", "--num_steps", "2", "--device", "cpu"]
    with pytest.raises(ValueError, match="num_channels=4 but .* has 3 channels"):
        port_generate.main(common + ["--output_dir", str(tmp_path / "bad"), "--num_channels", "4"])
    port_generate.main(common + ["--output_dir", str(tmp_path / "ok"), "--num_channels", "3", "--num_workers", "2",
                                 "--num_classes", "10"])
    assert sorted(p.name for p in (tmp_path / "ok").iterdir()) == ["0.png", "1.png"]
    assert "EMA weights loaded." in capsys.readouterr().out
