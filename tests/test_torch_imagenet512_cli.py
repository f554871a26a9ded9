"""EDM2's ImageNet-512 workflow through the port's CLIs, at smoke width on
the CPU: pack synthetic latents into a latpack store
(``python -m tinyedm_tpu_torch.data.latpack``), train
``experiments/conf/imagenet512.yaml`` on it for 2 epochs with a checkpoint
each (the recipe's structure kept: 4 microbatches per step, two EMA
profiles, the uncertainty loss; the widths cut by overrides), reconstruct
a post-hoc EMA from both checkpoints (``posthoc_ema``) and sample from it
(``generate --ckpt_path --load_ema``).
"""

from __future__ import annotations

import json
from collections import Counter

import numpy as np

from tinyedm_tpu_torch import generate, posthoc_ema, train
from tinyedm_tpu_torch.data import latpack
from tinyedm_tpu_torch.models.edm import EDM
from tinyedm_tpu_torch.training.checkpoint import load_checkpoint

N, SIDE = 40, 8
SMALL = [
    "model.embedding.fourier_dim=16", "model.embedding.embedding_dim=32",
    "model.denoiser.encoder_block_types=[EncA, EncD]",
    "model.denoiser.decoder_block_types=[Dec, Dec, DecU, DecA, Dec]",
    "model.denoiser.encoder_out_channels=[32, 64]", "model.denoiser.decoder_out_channels=[64, 64, 32, 32, 32]",
    "model.denoiser.skip_connections=[False, True, False, True, True]", "model.denoiser.num_heads=2",
]


def test_pack_train_posthoc_and_sample(tmp_path, capsys):
    rng = np.random.default_rng(0)
    for sub in ("latents", "labels"):
        (tmp_path / sub).mkdir()
    for i in range(N):
        np.save(tmp_path / "latents" / f"{i}.npy", rng.standard_normal((4, SIDE, SIDE)).astype(np.float32))
        np.save(tmp_path / "labels" / f"{i}.npy", np.int64(rng.integers(0, 1000)))
    store = tmp_path / "latents.latpack"
    latpack.main([str(tmp_path / "latents"), str(tmp_path / "labels"), str(store)])
    assert f"packed {N} samples" in capsys.readouterr().out

    run = tmp_path / "run"
    sizes = Counter()
    forward = EDM.denoise_with_aux

    def counted(self, noisy, sigma, labels=None, train=False, **kw):
        if train:
            sizes[noisy.shape[0]] += 1
        return forward(self, noisy, sigma, labels, train=train, **kw)

    EDM.denoise_with_aux = counted
    try:
        trainer = train.main([
            "--config-name=imagenet512", "--device", "cpu", f"datamodule.data_file={store}",
            "datamodule.batch_size=8", "datamodule.num_workers=2", f"trainer.out_dir={run}", "trainer.max_epochs=2",
            "trainer.check_val_every_n_epoch=1", "callbacks.checkpoint_callback.every_n_epochs=1",
            "callbacks.generate_callback.every_n_epochs=1", f"callbacks.generate_callback.img_shape=[4, {SIDE}, {SIDE}]",
            "callbacks.generate_callback.num_classes=2", "callbacks.generate_callback.num_samples_per_class=1",
            "callbacks.generate_callback.solver.num_steps=2", *SMALL])
    finally:
        EDM.denoise_with_aux = forward
    # 39 train samples: 4 steps of 8 per epoch, each 4 microbatches of 2
    assert type(trainer.datamodule).__name__ == "PackedLatentsDataModule"
    assert trainer.spec.accum_steps == 4 and trainer.model.u is not None
    assert trainer.global_step == 8 and sizes == Counter({2: 4 * 8})
    assert len(trainer.state.ema) == 2 and trainer.ckpt.all_steps == [4, 8]
    rows = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    val = [r for r in rows if "val_loss" in r]
    assert [r["step"] for r in val] == [4, 8]
    assert all(np.isfinite(r[k]) for r in val for k in ("val_loss", "val_loss/ema_0.05", "val_loss/ema_0.13"))

    out = tmp_path / "posthoc"
    posthoc_ema.main(["--ckpt_path", str(run / "checkpoints"), "--target_sigma_rel", "0.1", "--out_dir", str(out),
                      "--steps", "4", "8", "--device", "cpu"])
    state, config = load_checkpoint(out)
    assert state.step == 8 and len(state.ema) == 1 and config["model"]["ema_lengths"] is None

    samples = tmp_path / "samples"
    generate.main(["--ckpt_path", str(out), "--load_ema", "--output_dir", str(samples), "--num_samples", "3",
                   "--batch_size", "2", "--image_size", str(SIDE), "--num_classes", "1000", "--num_channels", "4",
                   "--num_steps", "2", "--mean", "5.81", "3.25", "0.12", "-2.15", "--std", "4.17", "4.62", "3.71",
                   "3.28", "--device", "cpu"])
    assert "EMA weights loaded." in capsys.readouterr().out
    pngs = sorted(samples.glob("*.png"))
    assert [p.name for p in pngs] == ["0.png", "1.png", "2.png"]
    assert {p.read_bytes()[25] for p in pngs} == {6}  # RGBA: 4 latent channels
