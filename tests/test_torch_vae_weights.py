"""The VAE's weights from disk: the hand-written ``.safetensors`` reader and
writer (``tinyedm_tpu_torch/utils/safetensors.py``) against the
``safetensors`` package, and ``load_vae``'s search (a diffusers directory,
one weight file, ``.npz``, the Hugging Face cache) with the error that names
every place it looked. Exact comparisons throughout."""

from __future__ import annotations

import struct

import numpy as np
import pytest
import torch

from tinyedm_tpu_torch.data import vae as pvae
from tinyedm_tpu_torch.utils.safetensors import load_safetensors, save_safetensors

st_torch = pytest.importorskip("safetensors.torch")


def _tensors() -> dict[str, torch.Tensor]:
    g = torch.Generator().manual_seed(0)
    return {
        "f32": torch.randn((3, 5), generator=g),
        "f16": torch.randn((7,), generator=g).half(),
        "bf16": torch.randn((2, 2, 3), generator=g).bfloat16(),
        "f64": torch.randn((4,), generator=g).double(),
        "i64": torch.arange(-3, 9),
        "u8": torch.arange(0, 200, 7, dtype=torch.uint8),
        "i8": torch.tensor([-128, 0, 127], dtype=torch.int8),
        "bool": torch.tensor([True, False, True]),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros((0, 4)),
        "a.b.weight": torch.randn((8, 4, 3, 3), generator=g),
    }


def _equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                                    and torch.equal(a[k], b[k]) for k in a)


def test_reader_reads_what_the_package_writes(tmp_path):
    t = _tensors()
    st_torch.save_file(t, str(tmp_path / "pkg.safetensors"), metadata={"format": "pt"})
    assert _equal(load_safetensors(tmp_path / "pkg.safetensors"), t)


def test_package_reads_what_the_writer_writes(tmp_path):
    t = _tensors()
    save_safetensors(t, tmp_path / "ours.safetensors", metadata={"format": "pt"})
    assert _equal(st_torch.load_file(str(tmp_path / "ours.safetensors")), t)
    assert _equal(load_safetensors(tmp_path / "ours.safetensors"), t)
    from safetensors import safe_open

    with safe_open(str(tmp_path / "ours.safetensors"), "pt") as f:
        assert f.metadata() == {"format": "pt"}
    # a non-contiguous view is written as its values
    view = {"t": torch.arange(12.0).reshape(3, 4).t()}
    save_safetensors(view, tmp_path / "view.safetensors")
    assert torch.equal(st_torch.load_file(str(tmp_path / "view.safetensors"))["t"], view["t"])


def test_malformed_files_raise_naming_the_file(tmp_path):
    good = tmp_path / "good.safetensors"
    save_safetensors({"x": torch.ones(4)}, good)
    data = good.read_bytes()
    cases = {
        "short.safetensors": data[:5],
        "cut.safetensors": data[:-3],  # the tensor's bytes end early
        "huge.safetensors": struct.pack("<Q", 10**12) + data[8:],
        "notjson.safetensors": struct.pack("<Q", 8) + b"{nope!!}" + b"\0" * 16,
        "dtype.safetensors": (lambda h: struct.pack("<Q", len(h)) + h + b"\0" * 16)(
            b'{"x":{"dtype":"Q9","shape":[4],"data_offsets":[0,16]}}'),
    }
    for name, blob in cases.items():
        (tmp_path / name).write_bytes(blob)
        with pytest.raises(ValueError, match=name):
            load_safetensors(tmp_path / name)


def _small_sd(seed: int = 0) -> dict[str, torch.Tensor]:
    return pvae.random_state_dict(seed, base_channels=32, channel_mults=(1, 2))


def _hf_repo(hub, repo_id="stabilityai/sd-vae-ft-ema"):
    return hub / f"models--{repo_id.replace('/', '--')}"


def test_find_weights_in_a_diffusers_directory_and_files(tmp_path):
    sd = _small_sd()
    d = tmp_path / "model"
    (d / "vae").mkdir(parents=True)
    torch.save(sd, d / "vae" / "diffusion_pytorch_model.bin")
    assert pvae.find_vae_weights(str(d)) == d / "vae" / "diffusion_pytorch_model.bin"
    save_safetensors(sd, d / "diffusion_pytorch_model.safetensors")
    assert pvae.find_vae_weights(str(d)) == d / "diffusion_pytorch_model.safetensors"
    np.savez(tmp_path / "sd.npz", **{k: v.numpy() for k, v in sd.items()})
    for path in (d / "diffusion_pytorch_model.safetensors", d / "vae" / "diffusion_pytorch_model.bin",
                 tmp_path / "sd.npz"):
        assert pvae.find_vae_weights(str(path)) == path
        assert _equal(pvae.read_state_dict(path), sd)
    (tmp_path / "w.txt").write_text("x")
    with pytest.raises(ValueError, match="w.txt"):
        pvae.read_state_dict(tmp_path / "w.txt")


def test_hf_cache_resolution(tmp_path, monkeypatch):
    """A repo id resolves in ``$HF_HUB_CACHE``, else ``$HF_HOME/hub``:
    ``refs/main``'s snapshot first, else the newest, at its root or in
    ``vae/``."""
    import os

    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "home"))
    repo = _hf_repo(tmp_path / "home" / "hub")
    old, new = repo / "snapshots" / "aaa", repo / "snapshots" / "bbb"
    for snap in (old, new):
        (snap / "vae").mkdir(parents=True)
    save_safetensors(_small_sd(1), old / "diffusion_pytorch_model.safetensors")
    torch.save(_small_sd(2), new / "vae" / "diffusion_pytorch_model.bin")
    os.utime(old, (1, 1))
    assert pvae.find_vae_weights("stabilityai/sd-vae-ft-ema") == new / "vae" / "diffusion_pytorch_model.bin"
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text("aaa\n")
    assert pvae.find_vae_weights("stabilityai/sd-vae-ft-ema") == old / "diffusion_pytorch_model.safetensors"
    hub = tmp_path / "elsewhere"
    (_hf_repo(hub) / "snapshots" / "c").mkdir(parents=True)
    torch.save(_small_sd(3), _hf_repo(hub) / "snapshots" / "c" / "diffusion_pytorch_model.bin")
    monkeypatch.setenv("HF_HUB_CACHE", str(hub))
    assert pvae.find_vae_weights("stabilityai/sd-vae-ft-ema") == (
        _hf_repo(hub) / "snapshots" / "c" / "diffusion_pytorch_model.bin")


def test_missing_weights_name_every_place_tried(tmp_path, monkeypatch):
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "home"))
    monkeypatch.setattr(pvae, "GOLDEN_STATE_DICT", tmp_path / "datasets" / "sd_vae_ft_ema_state_dict.npz")
    with pytest.raises(FileNotFoundError) as e:
        pvae.load_vae("stabilityai/sd-vae-ft-ema", device="cpu")
    msg = str(e.value)
    for place in ("stabilityai/sd-vae-ft-ema", str(_hf_repo(tmp_path / "home" / "hub") / "snapshots"),
                  str(tmp_path / "datasets" / "sd_vae_ft_ema_state_dict.npz"), "nothing is downloaded"):
        assert place in msg, (place, msg)
    # an empty snapshot: the files looked for in it are named
    snap = _hf_repo(tmp_path / "home" / "hub") / "snapshots" / "s1"
    snap.mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="s1/diffusion_pytorch_model.safetensors"):
        pvae.find_vae_weights("stabilityai/sd-vae-ft-ema")
    with pytest.raises(FileNotFoundError, match="no_such_dir"):
        pvae.find_vae_weights(str(tmp_path / "no_such_dir"))
    # the golden state dict is the last place for the default name only
    monkeypatch.setattr(pvae, "GOLDEN_STATE_DICT", tmp_path / "sd.npz")
    np.savez(tmp_path / "sd.npz", x=np.zeros(1))
    assert pvae.find_vae_weights("stabilityai/sd-vae-ft-ema") == tmp_path / "sd.npz"
    with pytest.raises(FileNotFoundError):
        pvae.find_vae_weights("stabilityai/sd-vae-ft-mse")


def test_load_vae_full_width_from_the_hf_cache(tmp_path, monkeypatch):
    """sd-vae-ft-ema's width through the whole path: seeded random weights
    written by the port's safetensors writer into a fake cache, found by the
    repo id, loaded on the CPU; equal to the state dict, and it encodes."""
    sd = pvae.random_state_dict(7)
    snap = _hf_repo(tmp_path / "hub") / "snapshots" / "0"
    snap.mkdir(parents=True)
    save_safetensors(sd, snap / "diffusion_pytorch_model.safetensors")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    vae = pvae.load_vae(device="cpu")
    got = vae.state_dict()
    assert set(got) == set(sd) and all(torch.equal(got[k], sd[k]) for k in sd)
    assert sum(v.numel() for v in got.values()) == 83_653_863
    with torch.no_grad():
        mean, logvar = vae.encode_moments(torch.zeros((1, 3, 16, 16)))
    assert mean.shape == logvar.shape == (1, 4, 2, 2) and torch.isfinite(mean).all()
