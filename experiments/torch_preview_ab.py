"""Does a decoded latent preview slow the training epochs after it? A/B of
imagenet512.yaml through the CLI on the card.

    python experiments/torch_preview_ab.py [--rounds 2]

Packs 1000 synthetic latents into a latpack store, writes the seeded random
sd-vae weights into a fake Hugging Face cache, then runs
``tinyedm_tpu_torch.train --config-name=imagenet512`` for 3 epochs of 7
steps of 4 x 32 (a Heun-32 preview of 32 after every validation, no
checkpoints) in turns: ``raw`` (no VAE found: the preview logs latents),
``decode`` (the VAE decodes the preview on the card) and ``decode+free``
(the same, with the allocator's cache emptied after each preview), each
``--rounds`` times. Prints each run's ms/step per epoch (``metrics.jsonl``'s
samples_per_sec) and the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tinyedm_tpu_torch.data.latpack import pack  # noqa: E402
from tinyedm_tpu_torch.training import callbacks  # noqa: E402
from tinyedm_tpu_torch.utils.cuda import resolve_device  # noqa: E402

EPOCHS = 3


def run(tmp: Path, store: Path, tag: str, i: int) -> list[float]:
    out = tmp / f"{tag}-{i}"
    args = ["--config-name=imagenet512", f"--config-path={ROOT / 'experiments' / 'conf'}",
            f"datamodule.data_file={store}", f"trainer.out_dir={out}", f"trainer.max_epochs={EPOCHS}",
            "trainer.check_val_every_n_epoch=1", "callbacks.checkpoint_callback.every_n_epochs=1000",
            "callbacks.generate_callback.every_n_epochs=1"]
    trainer, text, _ = cs._run_train(args, f"ab {tag}")
    rows = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    ms = [1e3 * trainer.datamodule.batch_size / r["samples_per_sec"] for r in rows if "samples_per_sec" in r]
    decoded = "VAE unavailable" not in text
    del trainer
    torch.cuda.empty_cache()
    print(f"[ab] {tag} #{i}: decoded {decoded}; ms/step by epoch {[round(m, 3) for m in ms]}", flush=True)
    return ms


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--rounds", type=int, default=2)
    rounds = p.parse_args().rounds
    resolve_device("cuda")
    smi = cs.phase_environment()
    cs.phase_build()
    decode = callbacks.LatentsGenerateCallback.decode

    def decode_and_free(self, lat, device):
        out = decode(self, lat, device)
        torch.cuda.empty_cache()
        return out

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cs._write_latents(tmp / "npy", cs.IN512_SAMPLES, seed=2)
        store = tmp / "latents.latpack"
        pack(tmp / "npy" / "latents", tmp / "npy" / "labels", store)
        files = cs.write_vae_files(tmp / "vae")
        results = {}
        for i in range(rounds):
            for tag in ("raw", "decode", "decode+free"):
                callbacks.LatentsGenerateCallback.decode = decode_and_free if tag == "decode+free" else decode
                if tag == "raw":
                    results.setdefault(tag, []).append(run(tmp, store, tag, i))
                else:
                    with cs._hf_home(files["hf_home"]):
                        results.setdefault(tag, []).append(run(tmp, store, tag, i))
        callbacks.LatentsGenerateCallback.decode = decode
    for tag, runs in results.items():
        print(f"[ab] {tag}: epochs 2-{EPOCHS} ms/step {[round(m, 3) for r in runs for m in r[1:]]} | {smi}",
              flush=True)


if __name__ == "__main__":
    main()
