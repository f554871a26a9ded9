"""The Stable-Diffusion VAE (AutoencoderKL) as ``nn.Module``s, and its
weights.

Counterpart of ``tinyedm_tpu/data/vae.py``: the sd-vae-ft-ema architecture
(channel levels 128/256/512/512, 2 resnets per encoder level and 3 per
decoder level, a resnet-attention-resnet mid block on each side, 4-channel
latents at 1/8 of the image side), NCHW inside, images in [-1, 1]. Details
kept from the JAX module: GroupNorm with 32 groups and eps 1e-6 computed in
fp32; downsampling pads by (0, 1) on the right and bottom, then runs a
stride-2 VALID conv; upsampling is nearest-neighbour 2x; the mid attention is
one head over the h*w tokens with fp32 logits scaled by 1/sqrt(c) and its
softmax weights cast back to ``dtype``; ``logvar`` clipped to (-30, 20).
``dtype`` is the compute type of the convs and projections; parameters stay
fp32, as flax keeps them. The convs and products go to cuDNN and cuBLAS (the
JAX module has no Pallas kernel); fp32 runs without TF32 on the card
(``utils.cuda.resolve_device``).

Submodules carry diffusers' names (``encoder.down_blocks.{i}.resnets.{j}``,
``decoder.up_blocks.{i}.upsamplers.0.conv``, ``*.mid_block.attentions.0.to_q``,
``to_out.0``, ``conv_norm_out``, ``quant_conv``, ...), so a diffusers state
dict loads with ``load_state_dict(strict=True)`` after
``diffusers_state_dict_to_port`` has renamed the legacy attention keys.
``state_dict_from_jax`` carries the JAX module's params across.
``load_vae`` reads local files only (a diffusers directory, one weight file,
the repo's ``datasets/sd_vae_ft_ema_state_dict.npz`` or a Hugging Face cache
snapshot); nothing is downloaded.
"""

from __future__ import annotations

import math
import os
import re
from pathlib import Path
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

DEFAULT_VAE = "stabilityai/sd-vae-ft-ema"
# what make_vae_golden.py writes: the diffusers state dict as numpy arrays
GOLDEN_STATE_DICT = Path(__file__).resolve().parents[2] / "datasets" / "sd_vae_ft_ema_state_dict.npz"
WEIGHT_FILES = ("diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin")
WEIGHT_SUFFIXES = (".safetensors", ".bin", ".pt", ".pth", ".npz")


class Conv2d(nn.Conv2d):
    """A conv that computes in ``dtype`` (input and weights cast to it)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, k, stride=stride, padding=padding)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        return F.conv2d(x.to(d), self.weight.to(d), self.bias.to(d), self.stride, self.padding)


class Linear(nn.Linear):
    """A projection that computes in ``dtype``."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        return F.linear(x.to(d), self.weight.to(d), self.bias.to(d))


class GroupNorm(nn.GroupNorm):
    """32 groups, eps 1e-6, in fp32 whatever the input's type."""

    def __init__(self, channels: int):
        super().__init__(32, channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight.float(), self.bias.float(), self.eps)


def _residual(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``x + h``, into ``h``'s storage where the types agree (h is fresh)."""
    return h.add_(x) if h.dtype == x.dtype and not h.requires_grad else x + h


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = GroupNorm(cin)
        self.conv1 = Conv2d(cin, cout, 3, padding=1, dtype=dtype)
        self.norm2 = GroupNorm(cout)
        self.conv2 = Conv2d(cout, cout, 3, padding=1, dtype=dtype)
        self.conv_shortcut = Conv2d(cin, cout, 1, dtype=dtype) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x), inplace=True))
        h = self.conv2(F.silu(self.norm2(h), inplace=True))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return _residual(x, h)


class AttnBlock(nn.Module):
    """Single-head self-attention over the spatial tokens (the mid block's)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.group_norm = GroupNorm(channels)
        self.to_q = Linear(channels, channels, dtype)
        self.to_k = Linear(channels, channels, dtype)
        self.to_v = Linear(channels, channels, dtype)
        self.to_out = nn.ModuleList([Linear(channels, channels, dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        t = self.group_norm(x).flatten(2).transpose(1, 2)  # (b, h*w, c)
        q, k, v = self.to_q(t), self.to_k(t), self.to_v(t)
        logits = torch.bmm(q.float(), k.float().transpose(1, 2))
        logits = logits.div_(torch.tensor(float(c), device=x.device).sqrt())  # fp32 sqrt, as jnp.sqrt(float32(c))
        w = torch.softmax(logits, dim=-1).to(self.dtype)
        del logits
        out = self.to_out[0](torch.bmm(w, v))
        return _residual(x, out.transpose(1, 2).reshape(b, c, hh, ww))


class Downsample(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class MidBlock(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(channels, channels, dtype) for _ in range(2)])
        self.attentions = nn.ModuleList([AttnBlock(channels, dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class Level(nn.Module):
    """One resolution level: ``resnets``, then ``downsamplers`` (encoder) or
    ``upsamplers`` (decoder) unless it is the last."""

    def __init__(self, cin: int, cout: int, n: int, resample: Optional[str], dtype: torch.dtype):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(cin if j == 0 else cout, cout, dtype) for j in range(n)])
        if resample == "down":
            self.downsamplers = nn.ModuleList([Downsample(cout, dtype)])
        elif resample == "up":
            self.upsamplers = nn.ModuleList([Upsample(cout, dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for r in self.resnets:
            x = r(x)
        for s in getattr(self, "downsamplers", getattr(self, "upsamplers", ())):
            x = s(x)
        return x


class Encoder(nn.Module):
    def __init__(self, base_channels: int = 128, channel_mults: Sequence[int] = (1, 2, 4, 4),
                 latent_channels: int = 4, layers_per_block: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        chans = [base_channels * m for m in channel_mults]
        self.conv_in = Conv2d(3, chans[0], 3, padding=1, dtype=dtype)
        last = len(chans) - 1
        self.down_blocks = nn.ModuleList([
            Level(chans[max(i - 1, 0)], c, layers_per_block, "down" if i < last else None, dtype)
            for i, c in enumerate(chans)])
        self.mid_block = MidBlock(chans[-1], dtype)
        self.conv_norm_out = GroupNorm(chans[-1])
        self.conv_out = Conv2d(chans[-1], 2 * latent_channels, 3, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in self.down_blocks:
            h = level(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h), inplace=True))


class Decoder(nn.Module):
    def __init__(self, base_channels: int = 128, channel_mults: Sequence[int] = (1, 2, 4, 4),
                 latent_channels: int = 4, out_channels: int = 3, layers_per_block: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        chans = [base_channels * m for m in reversed(channel_mults)]
        self.conv_in = Conv2d(latent_channels, chans[0], 3, padding=1, dtype=dtype)
        self.mid_block = MidBlock(chans[0], dtype)
        last = len(chans) - 1
        self.up_blocks = nn.ModuleList([
            Level(chans[max(i - 1, 0)], c, layers_per_block, "up" if i < last else None, dtype)
            for i, c in enumerate(chans)])
        self.conv_norm_out = GroupNorm(chans[-1])
        self.conv_out = Conv2d(chans[-1], out_channels, 3, padding=1, dtype=dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(self.conv_in(z))
        for level in self.up_blocks:
            h = level(h)
        return self.conv_out(F.silu(self.conv_norm_out(h), inplace=True))


class AutoencoderKL(nn.Module):
    """SD VAE: ``encode_moments`` -> the diagonal Gaussian's (mean, logvar),
    ``encode_sample`` -> a draw from it, ``decode`` -> images. NCHW; images
    in [-1, 1]; latents 4-channel at 1/8 resolution."""

    def __init__(self, base_channels: int = 128, channel_mults: Sequence[int] = (1, 2, 4, 4),
                 latent_channels: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder = Encoder(base_channels, channel_mults, latent_channels, dtype=dtype)
        self.decoder = Decoder(base_channels, channel_mults, latent_channels, dtype=dtype)
        self.quant_conv = Conv2d(2 * latent_channels, 2 * latent_channels, 1, dtype=dtype)
        self.post_quant_conv = Conv2d(latent_channels, latent_channels, 1, dtype=dtype)

    def encode_moments(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode_sample(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``latent_dist.sample()``: mean + exp(logvar / 2) * noise, the noise
        drawn from ``generator`` (on the module's device) or given."""
        mean, logvar = self.encode_moments(x)
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
        elif noise.shape != mean.shape:
            raise ValueError(f"noise {tuple(noise.shape)} does not match the latents {tuple(mean.shape)}")
        return mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.decode(self.encode_sample(x, generator))


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

_JAX_NAMES = [  # JAX module path -> diffusers key (convert_torch_vae's map, inverted)
    (re.compile(r"down_(\d+)_block_(\d+)"), r"down_blocks.\1.resnets.\2"),
    (re.compile(r"down_(\d+)_downsample"), r"down_blocks.\1.downsamplers.0"),
    (re.compile(r"up_(\d+)_block_(\d+)"), r"up_blocks.\1.resnets.\2"),
    (re.compile(r"up_(\d+)_upsample"), r"up_blocks.\1.upsamplers.0"),
    (re.compile(r"mid_block_1"), "mid_block.resnets.0"),
    (re.compile(r"mid_block_2"), "mid_block.resnets.1"),
    (re.compile(r"mid_attn"), "mid_block.attentions.0"),
    (re.compile(r"norm_out"), "conv_norm_out"),
    (re.compile(r"to_out"), "to_out.0"),
]


def state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """The JAX module's params (nested dicts of arrays) as this module's
    state dict: conv kernels HWIO -> OIHW, Dense kernels (in, out) ->
    Linear weights (out, in), GroupNorm ``scale`` -> ``weight``."""
    out: dict[str, torch.Tensor] = {}

    def walk(tree, path):
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, path + [key])
                continue
            a = np.asarray(value, np.float32)
            if key == "kernel":
                a, key = (a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T), "weight"
            elif key == "scale":
                key = "weight"
            name = ".".join(path)
            for pattern, repl in _JAX_NAMES:
                name = pattern.sub(repl, name)
            out[f"{name}.{key}"] = torch.from_numpy(np.ascontiguousarray(a))

    walk(params, [])
    return out


_LEGACY = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}
_LEGACY_KEY = re.compile(r"^(.*\.attentions\.\d+)\.(query|key|value|proj_attn)\.(weight|bias)$")
_PROJECTION = re.compile(r"\.attentions\.\d+\.(to_q|to_k|to_v|to_out\.0)\.weight$")


def diffusers_state_dict_to_port(sd: Mapping) -> dict[str, torch.Tensor]:
    """A diffusers AutoencoderKL state dict (torch tensors or numpy arrays)
    as this module's: the legacy attention names ``query``, ``key``,
    ``value`` and ``proj_attn`` renamed, projections stored as 1x1 convs
    flattened; every other key kept as it is (``load_state_dict(strict=True)``
    names what is missing or extra)."""
    out = {}
    for key, value in sd.items():
        t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.asarray(value))
        m = _LEGACY_KEY.match(key)
        if m:
            key = f"{m.group(1)}.{_LEGACY[m.group(2)]}.{m.group(3)}"
        if _PROJECTION.search(key) and t.ndim == 4:
            t = t[:, :, 0, 0]
        out[key] = t.float().contiguous()
    return out


def _hub_cache() -> Path:
    if os.environ.get("HF_HUB_CACHE"):
        return Path(os.environ["HF_HUB_CACHE"])
    if os.environ.get("HF_HOME"):
        return Path(os.environ["HF_HOME"]) / "hub"
    return Path.home() / ".cache" / "huggingface" / "hub"


def _snapshots(repo_id: str) -> tuple[list[Path], Path]:
    """The local snapshots of a Hugging Face repo, ``refs/main``'s first,
    then the newest; and the directory they were looked for in."""
    repo = _hub_cache() / f"models--{repo_id.replace('/', '--')}"
    found = sorted((p for p in (repo / "snapshots").glob("*") if p.is_dir()), key=lambda p: -p.stat().st_mtime)
    ref = repo / "refs" / "main"
    if ref.is_file():
        main = repo / "snapshots" / ref.read_text().strip()
        found = [main] + [p for p in found if p != main] if main.is_dir() else found
    return found, repo / "snapshots"


def find_vae_weights(name_or_path: str) -> Path:
    """The local weight file for ``name_or_path``: the path itself if it is
    a file; a diffusers directory's ``diffusion_pytorch_model.safetensors``
    or ``.bin`` (or its ``vae/`` folder's); for a repo id, the same files in
    the Hugging Face cache's snapshots (``$HF_HUB_CACHE``, else
    ``$HF_HOME/hub``, else ``~/.cache/huggingface/hub``), and for
    sd-vae-ft-ema the repo's ``datasets/sd_vae_ft_ema_state_dict.npz``.
    Raises ``FileNotFoundError`` naming every place it looked."""
    path = Path(name_or_path).expanduser()
    if path.is_file():
        return path
    dirs, tried = [], []
    if path.is_dir():
        dirs.append(path)
    else:
        tried.append(str(path))
    if re.fullmatch(r"[\w.-]+/[\w.-]+", name_or_path) and not path.exists():
        snapshots, where = _snapshots(name_or_path)
        dirs += snapshots
        if not snapshots:
            tried.append(f"{where}/*")
    for d in dirs:
        for sub in (d, d / "vae"):
            for f in WEIGHT_FILES:
                tried.append(str(sub / f))
                if (sub / f).is_file():
                    return sub / f
    if name_or_path == DEFAULT_VAE:
        tried.append(str(GOLDEN_STATE_DICT))
        if GOLDEN_STATE_DICT.is_file():
            return GOLDEN_STATE_DICT
    raise FileNotFoundError(f"no VAE weights for {name_or_path!r} (nothing is downloaded); looked in: "
                            + ", ".join(tried))


def read_state_dict(path: str | Path) -> dict[str, torch.Tensor]:
    """A weight file's tensors on the CPU, by suffix: ``.safetensors``
    (read by hand), ``.bin``/``.pt``/``.pth`` (``torch.load``, tensors
    only) or ``.npz`` (``make_vae_golden.py``'s layout)."""
    path = Path(path)
    if path.suffix == ".safetensors":
        from tinyedm_tpu_torch.utils.safetensors import load_safetensors

        return load_safetensors(path)
    if path.suffix in (".bin", ".pt", ".pth"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if not isinstance(sd, Mapping):
            raise ValueError(f"{path}: not a state dict ({type(sd).__name__})")
        return dict(sd)
    if path.suffix == ".npz":
        with np.load(path) as f:
            return {k: torch.from_numpy(f[k]) for k in f.files}
    raise ValueError(f"{path}: not a weight file ({', '.join(WEIGHT_SUFFIXES)})")


def build_vae(state_dict: Mapping[str, torch.Tensor], device=None, dtype: torch.dtype = torch.float32,
              base_channels: int = 128, channel_mults: Sequence[int] = (1, 2, 4, 4)) -> AutoencoderKL:
    """An inference-mode ``AutoencoderKL`` holding ``state_dict`` (this
    module's names) on ``device`` (the card unless the CPU is asked for)."""
    from tinyedm_tpu_torch.utils.cuda import resolve_device

    dev = resolve_device(device)
    with torch.device("meta"):
        vae = AutoencoderKL(base_channels, channel_mults, dtype=dtype)
    vae.load_state_dict(state_dict, strict=True, assign=True)
    return vae.to(dev).eval().requires_grad_(False)


def load_vae(name_or_path: str = DEFAULT_VAE, device=None, dtype: torch.dtype = torch.float32) -> AutoencoderKL:
    """The sd-vae architecture with local weights (``find_vae_weights``),
    on ``device`` (the card unless the CPU is asked for)."""
    path = find_vae_weights(name_or_path)
    return build_vae(diffusers_state_dict_to_port(read_state_dict(path)), device, dtype)


def random_state_dict(seed: int, base_channels: int = 128,
                      channel_mults: Sequence[int] = (1, 2, 4, 4)) -> dict[str, torch.Tensor]:
    """Seeded random weights (the same on every machine): conv and linear
    weights normal with variance 1 / fan_in (flax's lecun_normal without its
    truncation), biases 0, GroupNorm scales 1."""
    with torch.device("meta"):
        shapes = AutoencoderKL(base_channels, channel_mults).state_dict()
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, t in shapes.items():
        if name.endswith(".weight") and t.ndim >= 2:
            fan_in = math.prod(t.shape[1:])
            out[name] = torch.randn(t.shape, generator=gen) / math.sqrt(fan_in)
        elif name.endswith(".weight") and ("norm" in name):
            out[name] = torch.ones(t.shape)
        else:
            out[name] = torch.zeros(t.shape)
    return out


def random_vae(seed: int = 0, device=None, dtype: torch.dtype = torch.float32, base_channels: int = 128,
               channel_mults: Sequence[int] = (1, 2, 4, 4)) -> AutoencoderKL:
    """A seeded random VAE, for the pipeline without pretrained weights."""
    return build_vae(random_state_dict(seed, base_channels, channel_mults), device, dtype, base_channels,
                     channel_mults)
