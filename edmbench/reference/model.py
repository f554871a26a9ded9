"""The plain reference of the EDM2 magnitude-preserving U-Net and its EDM
preconditioning (Karras et al. 2022, 2023), in fp32 PyTorch.

Written from the papers' equations and the configuration files under
``edmbench/configs``; it imports nothing of the program. The weights are a
dict by the names the program's modules give them (``param_shapes``), drawn
on the card from the seed (``draw_weights``) and handed to both sides.
Activations are NCHW and conv weights OIHW. Every product's operands pass
through ``prec.op`` (``reference/precision.py``): fp32 for the reference,
fp8 for the control. Training draws the same randomness, in the same order,
from the generator it is given: the sigmas and noise of each microbatch,
then each block's dropout bits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from edmbench.reference.precision import FP32, Precision

EPS = 1e-4  # the weight and pixel norms' offset
SILU_SCALE = 1.0 / 0.596  # silu(x) / 0.596 keeps unit variance
HEADS = 4


@dataclasses.dataclass(frozen=True)
class Block:
    prefix: str
    decoder: bool
    resample: bool  # down for the encoder, up for the decoder
    attention: bool
    in_channels: int
    out_channels: int
    skip_channels: int  # decoder only; 0 = no skip

    @property
    def cat_channels(self) -> int:
        return self.in_channels + self.skip_channels


def topology(cfg: dict) -> list[Block]:
    """The U-Net's blocks in forward order. Skips are the conv_in output and
    every encoder block's output, taken last-in first-out by the decoder
    blocks whose ``skip_connections`` entry is true."""
    d = cfg["denoiser"]
    enc_out = list(d["encoder_out_channels"])
    ch = enc_out[0]
    blocks = []
    for i, (kind, out) in enumerate(zip(d["encoder_block_types"], enc_out)):
        blocks.append(Block(f"denoiser.encoder_blocks.{i}.", False, kind.endswith("D"),
                            kind.endswith("A"), ch, out, 0))
        ch = out
    sources = list(reversed(enc_out)) + [enc_out[0]]
    for i, (kind, out, has_skip) in enumerate(zip(d["decoder_block_types"], d["decoder_out_channels"],
                                                  d["skip_connections"])):
        skip = sources.pop(0) if has_skip else 0
        blocks.append(Block(f"denoiser.decoder_blocks.{i}.", True, kind.endswith("U"),
                            kind.endswith("A"), ch, out, skip))
        ch = out
    return blocks


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every weight, gain and Fourier constant by name, with its shape."""
    e, d = cfg["embedding"], cfg["denoiser"]
    fd, ed = e["fourier_dim"], e["embedding_dim"]
    shapes = {
        "embedding.fourier_embed.freqs": (fd,),
        "embedding.fourier_embed.phases": (fd,),
        "embedding.sigma_embed.weight": (ed, fd),
    }
    if conditional(cfg):
        shapes["embedding.class_embed.linear.weight"] = (ed, e["num_classes"])
    c0 = d["encoder_out_channels"][0]
    shapes["denoiser.conv_in.weight"] = (c0, d["in_channels"] + 1, 3, 3)
    ch = c0
    for b in topology(cfg):
        p, out = b.prefix, b.out_channels
        res_in = b.cat_channels if b.decoder else out
        shapes[p + "conv_3x3_1.weight"] = (out, res_in, 3, 3)
        shapes[p + "embed.weight"] = (out, d["embedding_dim"])
        shapes[p + "gain"] = ()
        shapes[p + "conv_3x3_2.weight"] = (out, out, 3, 3)
        if b.attention:
            shapes[p + "attention.qkv_conv.weight"] = (3 * out, out, 1, 1)
            shapes[p + "attention.out_conv.weight"] = (out, out, 1, 1)
        if b.skip_channels:
            s = b.skip_channels
            hidden = max(1, s // 16)
            shapes[p + "cat_factor.conv_0.weight"] = (hidden, s + 1, 1, 1)
            shapes[p + "cat_factor.conv_1.weight"] = (s, hidden, 1, 1)
        cin = b.cat_channels if b.decoder else b.in_channels
        if cin != out:
            shapes[p + "conv_1x1.weight"] = (out, cin, 1, 1)
        ch = out
    shapes["denoiser.gain_out"] = ()
    shapes["denoiser.conv_out.weight"] = (d["out_channels"], ch, 1, 1)
    if cfg.get("use_uncertainty"):
        shapes["u.linear.weight"] = (fd, fd + 1)
        shapes["u.linear_out.weight"] = (1, fd)
        shapes["u.gain"] = ()
    return shapes


def conditional(cfg: dict) -> bool:
    return cfg["embedding"].get("num_classes") not in (None, -1)


def is_constant(name: str) -> bool:
    """The Fourier frequencies and phases: fixed, not trained."""
    return name.startswith("embedding.fourier_embed.")


@torch.no_grad()
def draw_weights(cfg: dict, seed: int, device: torch.device | str) -> dict[str, torch.Tensor]:
    """The weights of ``cfg`` from ``seed``, on ``device``, in three draws:
    every weight N(0, 1) from one normal draw; every gain, ``gain_out`` and
    the uncertainty gain among them, U(0.5, 1.5), never 0, so that the
    network's output reaches the denoiser's; the Fourier frequencies 2 pi
    N(0, 1) and phases 2 pi U(0, 1)."""
    shapes = param_shapes(cfg)
    g = torch.Generator(device=device).manual_seed(seed)
    weights = [n for n, s in shapes.items() if n.endswith(".weight")]
    gains = [n for n, s in shapes.items() if not s]
    flat = torch.randn(sum(math.prod(shapes[n]) for n in weights), generator=g, device=device)
    gain_values = torch.rand(len(gains), generator=g, device=device) + 0.5
    fd = cfg["embedding"]["fourier_dim"]
    fourier = torch.randn(fd, generator=g, device=device) * (2 * math.pi)
    phases = torch.rand(fd, generator=g, device=device) * (2 * math.pi)
    out, at = {}, 0
    for n in weights:
        size = math.prod(shapes[n])
        out[n] = flat[at:at + size].view(shapes[n])
        at += size
    for n, v in zip(gains, gain_values):
        out[n] = v
    out["embedding.fourier_embed.freqs"] = fourier
    out["embedding.fourier_embed.phases"] = phases
    return {n: out[n] for n in shapes}


# --- the magnitude-preserving primitives (EDM2, section 3 and appendix B)

def pixel_norm(x: torch.Tensor, dims: tuple[int, ...]) -> torch.Tensor:
    """``x`` over ``eps + |x| / sqrt(N)`` along ``dims``: unit RMS."""
    n = math.prod(x.shape[d] for d in dims)
    return x / (EPS + torch.sqrt(torch.sum(x * x, dim=dims, keepdim=True)) / math.sqrt(n))


def normalize_weight(w: torch.Tensor) -> torch.Tensor:
    """Unit RMS per output unit (dim 0)."""
    return pixel_norm(w, tuple(range(1, w.ndim)))


def effective_weight(w: torch.Tensor) -> torch.Tensor:
    return normalize_weight(w) / math.sqrt(w[0].numel())


def mp_silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x) * SILU_SCALE


def mp_sum(a: torch.Tensor, b: torch.Tensor, t: float) -> torch.Tensor:
    return (a + (b - a) * t) / math.sqrt((1 - t) ** 2 + t ** 2)


def conv(x: torch.Tensor, w: torch.Tensor, prec: Precision) -> torch.Tensor:
    w = effective_weight(w)
    return F.conv2d(prec.op(x), prec.op(w), padding=w.shape[-1] // 2)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A weight-normed linear layer of the fp32 embedding paths."""
    return F.linear(x, effective_weight(w))


def with_ones(x: torch.Tensor) -> torch.Tensor:
    """``x`` with a channel of ones appended (the bias channel)."""
    return torch.cat([x, torch.ones_like(x[:, :1])], dim=1)


# --- the network

def embedding(P: dict, cfg: dict, sigma: torch.Tensor,
              labels: Optional[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """(Fourier features, the blocks' embedding)."""
    c_noise = torch.log(sigma) / 4
    fourier = torch.cos(torch.outer(c_noise, P["embedding.fourier_embed.freqs"])
                        + P["embedding.fourier_embed.phases"]) * math.sqrt(2)
    emb = linear(fourier, P["embedding.sigma_embed.weight"])
    if conditional(cfg):
        n = cfg["embedding"]["num_classes"]
        onehot = (labels.reshape(-1, 1) == torch.arange(n, device=labels.device)).float()
        emb = mp_sum(emb, linear(onehot * math.sqrt(n), P["embedding.class_embed.linear.weight"]), 0.5)
    return fourier, mp_silu(emb)


def attention(x: torch.Tensor, P: dict, p: str, heads: int, prec: Precision) -> torch.Tensor:
    """Cosine self-attention over the H*W tokens: q, k and v pixel-normed
    per head, softmax of ``q k^T / sqrt(hd)``, the residual mixed in at 0.5."""
    b, c, h, w = x.shape
    n, hd = h * w, c // heads
    tokens = x.flatten(2).transpose(1, 2).reshape(b * n, c)
    w_qkv = effective_weight(P[p + "attention.qkv_conv.weight"])[:, :, 0, 0]
    qkv = F.linear(prec.op(tokens), prec.op(w_qkv)).reshape(b, n, 3, heads, hd)
    q, k, v = (t.transpose(1, 2) for t in pixel_norm(qkv, (4,)).unbind(2))  # (b, heads, n, hd)
    logits = torch.matmul(prec.op(q), prec.op(k).transpose(-1, -2)) / math.sqrt(hd)
    y = torch.matmul(prec.op(torch.softmax(logits, dim=-1)), prec.op(v))
    y = y.transpose(1, 2).reshape(b * n, c)
    w_out = effective_weight(P[p + "attention.out_conv.weight"])[:, :, 0, 0]
    y = F.linear(prec.op(y), prec.op(w_out)).reshape(b, n, c).transpose(1, 2).reshape(b, c, h, w)
    return mp_sum(x, y, 0.5)


def dropout_threshold(rate: float) -> int:
    """Keep a value where its 16-bit random number is below this."""
    return int(round((1.0 - rate) * 65536.0))


def residual(x: torch.Tensor, emb: torch.Tensor, P: dict, p: str, bits: Optional[torch.Tensor],
             rate: float, prec: Precision) -> torch.Tensor:
    r = conv(mp_silu(x), P[p + "conv_3x3_1.weight"], prec)
    scale = linear(emb, P[p + "embed.weight"]) * P[p + "gain"] + 1
    r = mp_silu(r * scale[:, :, None, None])
    if bits is not None:
        r = torch.where(bits < dropout_threshold(rate), r * (1.0 / (1.0 - rate)), torch.zeros_like(r))
    return conv(r, P[p + "conv_3x3_2.weight"], prec)


def skip_gain(skip: torch.Tensor, P: dict, p: str, prec: Precision) -> torch.Tensor:
    """The learned gain of a skip: a squeeze-and-excitation on its mean."""
    pooled = with_ones(skip).mean(dim=(2, 3), keepdim=True)
    h = mp_silu(conv(pooled, P[p + "cat_factor.conv_0.weight"], prec))
    return torch.sigmoid(conv(h, P[p + "cat_factor.conv_1.weight"], prec))


def block(b: Block, x: torch.Tensor, emb: torch.Tensor, skip: Optional[torch.Tensor], P: dict,
          bits: Optional[torch.Tensor], d: dict, prec: Precision) -> torch.Tensor:
    p, rate = b.prefix, d["dropout_rate"]
    if b.decoder:
        if skip is not None:
            x = torch.cat([x, skip * skip_gain(skip, P, p, prec)], dim=1)
        if b.resample:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        res = x
        if b.cat_channels != b.out_channels:
            x = conv(x, P[p + "conv_1x1.weight"], prec)
        t = d.get("decoder_add_factor", 0.3)
    else:
        if b.resample:
            x = F.avg_pool2d(x, 2)
        if b.in_channels != b.out_channels:
            x = conv(x, P[p + "conv_1x1.weight"], prec)
        x = pixel_norm(x, (1,))
        res = x
        t = d.get("encoder_add_factor", 0.3)
    out = mp_sum(x, residual(res, emb, P, p, bits, rate, prec), t)
    return attention(out, P, p, d.get("num_heads", HEADS), prec) if b.attention else out


def precond(sigma: torch.Tensor, sigma_data: float):
    """(c_skip, c_out, c_in), shaped (B, 1, 1, 1)."""
    s2, sd2 = sigma ** 2, sigma_data ** 2
    c = (sd2 / (s2 + sd2), sigma * sigma_data / torch.sqrt(s2 + sd2), 1 / torch.sqrt(sd2 + s2))
    return tuple(v.reshape(-1, 1, 1, 1) for v in c)


def denoise(P: dict, cfg: dict, noisy: torch.Tensor, sigma: torch.Tensor,
            labels: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
            prec: Precision = FP32) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """D(x; sigma) = c_skip x + c_out gain_out F(c_in x), and the uncertainty
    head's output (or None). With a ``generator`` (training) each block
    draws its dropout bits from it, in forward order, before it runs."""
    d = cfg["denoiser"]
    fourier, emb = embedding(P, cfg, sigma, labels)
    c_skip, c_out, c_in = precond(sigma, d["sigma_data"])
    x = conv(with_ones(c_in * noisy), P["denoiser.conv_in.weight"], prec)
    skips = [x]
    keep_all = dropout_threshold(d["dropout_rate"]) >= 65536
    for b in topology(cfg):
        skip = skips.pop() if b.decoder and b.skip_channels else None
        bits = None
        if generator is not None and not keep_all:
            n, _, h, w = x.shape
            h, w = ((2 * h, 2 * w) if b.decoder else (h // 2, w // 2)) if b.resample else (h, w)
            bits = torch.randint(0, 65536, (n, b.out_channels, h, w), generator=generator,
                                 device=x.device, dtype=torch.int32)
        x = block(b, x, emb, skip, P, bits, d, prec)
        if not b.decoder:
            skips.append(x)
    out = conv(x, P["denoiser.conv_out.weight"], prec) * P["denoiser.gain_out"]
    u = None
    if cfg.get("use_uncertainty"):
        h = mp_silu(linear(with_ones(fourier), P["u.linear.weight"]))
        u = (P["u.gain"] * linear(h, P["u.linear_out.weight"])).reshape(-1)
    return out * c_out + noisy * c_skip, u
