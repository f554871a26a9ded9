"""The plain reference of DiT (Peebles & Xie 2022, arXiv:2212.09748;
``facebookresearch/DiT`` ``models.py``) under EDM preconditioning, and of its
training step, in fp32 PyTorch.

Written from the paper's code and the configuration file
(``edmbench/configs/dit_xl2_512.json``); it imports nothing of the program.
The weights are a dict by the names the program's modules give them
(``param_shapes``), drawn on the card from the seed (``draw_weights``) and
handed to both sides. Every product's operands pass through ``prec.op``
(``reference/precision.py``): fp32 for the reference, fp8 for the control.
TF32 is off (``no_tf32``): an fp32 product here is an fp32 product.

The model: patchify (``Conv2d(in, C, p, stride p)`` with bias), plus the
fixed 2-D sin-cos position table; ``c = t_embedder(c_noise) +
y_embedder(label)``, the timestep embedder 256 frequencies ``[cos, sin]`` of
``c_noise = ln(sigma) / 4`` then ``Linear-SiLU-Linear``, the label table's
last row the null class (label -1); ``depth`` adaLN-Zero blocks ``x += gate
* branch(LN(x) (1 + scale) + shift)`` (LayerNorm without affine, eps 1e-6;
softmax attention at ``1/sqrt(hd)`` with a qkv bias; an MLP with the tanh
GELU); the final adaLN layer and linear, unpatchify; EDM's ``c_skip x +
c_out F(c_in x)``. Departures from the published DiT, as in the program:
EDM's preconditioning and loss replace DDPM's epsilon target and learned
sigma (4 output channels, not 8); the timestep embedder reads ``c_noise``,
not a step index; one power-function EMA replaces the 0.9999 decay; Adam
at weight decay 0 stands for AdamW at weight decay 0.

Training (``train``): each step draws, from the generator seeded as the
program's, per microbatch the label dropout (one uniform a label), then the
sigmas and the noise, as the program's train step does; the microbatch's
loss is the mean over its samples of ``lambda(sigma) mean((D - x)^2)``,
computed ``chunk`` samples at a time so that it fits (the gradients of the
chunks summed); then Adam and the EMA profiles. Nothing is weight-normed.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from edmbench.reference.heun import sigma_steps
from edmbench.reference.precision import FP32, Precision
from edmbench.reference.train import Readings, ema_decay, ema_gamma

LN_EPS = 1e-6
MAX_PERIOD = 10000
CHUNK = 4  # samples a forward and backward in training: each block keeps about 1.2 GB of them at 1024 tokens


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def conditional(cfg: dict) -> bool:
    return cfg["embedding"].get("num_classes") not in (None, -1)


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every weight, bias, table and the position table by name, with its shape."""
    e, d = cfg["embedding"], cfg["denoiser"]
    c, f, p = d["hidden_size"], e["frequency_dim"], d["patch_size"]
    n = (d["input_size"] // p) ** 2
    hidden = int(c * d["mlp_ratio"])
    shapes = {}

    def linear(name: str, fan_in: int, fan_out: int) -> None:
        shapes[name + ".weight"] = (fan_out, fan_in)
        shapes[name + ".bias"] = (fan_out,)

    linear("embedding.t_embedder.mlp.0", f, c)
    linear("embedding.t_embedder.mlp.2", c, c)
    if conditional(cfg):
        shapes["embedding.y_embedder.embedding_table"] = (e["num_classes"] + 1, c)
    net = "denoiser.net."
    shapes[net + "x_embedder.proj.weight"] = (c, d["in_channels"], p, p)
    shapes[net + "x_embedder.proj.bias"] = (c,)
    shapes[net + "pos_embed"] = (1, n, c)
    for i in range(d["depth"]):
        b = f"{net}blocks.{i}."
        linear(b + "attn.qkv", c, 3 * c)
        linear(b + "attn.proj", c, c)
        linear(b + "mlp.fc1", c, hidden)
        linear(b + "mlp.fc2", hidden, c)
        linear(b + "adaLN_modulation.1", c, 6 * c)
    linear(net + "final_layer.linear", c, p * p * d["out_channels"])
    linear(net + "final_layer.adaLN_modulation.1", c, 2 * c)
    return shapes


def is_constant(name: str) -> bool:
    """The position table: fixed, not trained."""
    return name.endswith("pos_embed")


def sincos_pos_embed(dim: int, grid: int) -> np.ndarray:
    """DiT's ``get_2d_sincos_pos_embed``, fp64: (grid^2, dim); the first half
    ``[sin, cos]`` of ``pos omega``, ``omega_i = 10000^(-i / (dim/4))``, at
    a token's column index (``np.meshgrid``'s first grid), the second half
    at its row index."""

    def one_d(d: int, pos: np.ndarray) -> np.ndarray:
        omega = np.arange(d // 2, dtype=np.float64)
        omega /= d / 2.0
        omega = 1.0 / MAX_PERIOD ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    g = np.meshgrid(np.arange(grid, dtype=np.float32), np.arange(grid, dtype=np.float32))
    return np.concatenate([one_d(dim // 2, g[0]), one_d(dim // 2, g[1])], axis=1)


@torch.no_grad()
def draw_weights(cfg: dict, seed: int, device: torch.device | str) -> dict[str, torch.Tensor]:
    """The weights of ``cfg`` from ``seed``, on ``device``, in three draws:
    every weight xavier-uniform over its (out, in) view (DiT's initialization
    of its linears and of the patch embed), the modulations and the final
    linear included, which DiT zeroes and which would make every block the
    identity; every bias, from one normal draw, N(0, 0.02^2); the label
    table N(0, 1), so that the class moves the modulation as the noise
    level does. The position table is DiT's sin-cos table."""
    shapes = param_shapes(cfg)
    g = torch.Generator(device=device).manual_seed(seed)
    weights = [k for k in shapes if k.endswith(".weight")]
    biases = [k for k in shapes if k.endswith(".bias")]
    tables = [k for k in shapes if k.endswith("embedding_table")]
    flat_w = torch.rand(sum(math.prod(shapes[k]) for k in weights), generator=g, device=device)
    flat_b = torch.randn(sum(math.prod(shapes[k]) for k in biases), generator=g, device=device)
    out, at = {}, 0
    for k in weights:
        s = shapes[k]
        size = math.prod(s)
        bound = math.sqrt(6.0 / (s[0] + size // s[0]))
        out[k] = ((flat_w[at:at + size] * 2.0 - 1.0) * bound).view(s)
        at += size
    at = 0
    for k in biases:
        size = math.prod(shapes[k])
        out[k] = flat_b[at:at + size] * 0.02
        at += size
    for k in tables:
        out[k] = torch.randn(shapes[k], generator=g, device=device)
    d = cfg["denoiser"]
    table = sincos_pos_embed(d["hidden_size"], d["input_size"] // d["patch_size"])
    out["denoiser.net.pos_embed"] = torch.from_numpy(table).float().to(device)[None]
    return {k: out[k] for k in shapes}


# --- the network

def linear(x: torch.Tensor, P: dict, name: str, prec: Precision) -> torch.Tensor:
    w = P[name + ".weight"]
    return F.linear(prec.op(x), prec.op(w.reshape(w.shape[0], -1)), P[name + ".bias"])


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(MAX_PERIOD) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def embed(P: dict, cfg: dict, sigma: torch.Tensor, labels: Optional[torch.Tensor], prec: Precision) -> torch.Tensor:
    """c = t_embedder(ln(sigma) / 4) + y_embedder(labels), (B, C)."""
    e = cfg["embedding"]
    freqs = timestep_embedding(torch.log(sigma) / 4, e["frequency_dim"])
    c = linear(F.silu(linear(freqs, P, "embedding.t_embedder.mlp.0", prec)), P, "embedding.t_embedder.mlp.2", prec)
    if conditional(cfg):
        rows = torch.where(labels < 0, torch.full_like(labels, e["num_classes"]), labels).long()
        c = c + P["embedding.y_embedder.embedding_table"][rows]
    return c


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), eps=LN_EPS) * (1 + scale[:, None]) + shift[:, None]


def attention(x: torch.Tensor, P: dict, p: str, heads: int, prec: Precision) -> torch.Tensor:
    b, n, c = x.shape
    hd = c // heads
    qkv = linear(x, P, p + "attn.qkv", prec).reshape(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv.unbind(0)  # (b, heads, n, hd)
    logits = torch.matmul(prec.op(q), prec.op(k).transpose(-1, -2)) / math.sqrt(hd)
    y = torch.matmul(prec.op(torch.softmax(logits, dim=-1)), prec.op(v))
    return linear(y.transpose(1, 2).reshape(b, n, c), P, p + "attn.proj", prec)


def block(x: torch.Tensor, c: torch.Tensor, P: dict, p: str, heads: int, prec: Precision) -> torch.Tensor:
    mod = linear(F.silu(c), P, p + "adaLN_modulation.1", prec).chunk(6, dim=1)
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod
    x = x + gate_msa[:, None] * attention(modulate(x, shift_msa, scale_msa), P, p, heads, prec)
    h = modulate(x, shift_mlp, scale_mlp)
    h = linear(F.gelu(linear(h, P, p + "mlp.fc1", prec), approximate="tanh"), P, p + "mlp.fc2", prec)
    return x + gate_mlp[:, None] * h


def net(P: dict, cfg: dict, x: torch.Tensor, c: torch.Tensor, prec: Precision) -> torch.Tensor:
    """F(c_in x; c): (B, in, H, W) -> (B, out, H, W)."""
    d = cfg["denoiser"]
    b, ch, side, _ = x.shape
    p, g, out_ch = d["patch_size"], side // d["patch_size"], d["out_channels"]
    pre = "denoiser.net."
    patches = x.reshape(b, ch, g, p, g, p).permute(0, 2, 4, 1, 3, 5).reshape(b, g * g, ch * p * p)
    h = linear(patches, P, pre + "x_embedder.proj", prec) + P[pre + "pos_embed"]
    for i in range(d["depth"]):
        h = block(h, c, P, f"{pre}blocks.{i}.", d["num_heads"], prec)
    shift, scale = linear(F.silu(c), P, pre + "final_layer.adaLN_modulation.1", prec).chunk(2, dim=1)
    h = linear(modulate(h, shift, scale), P, pre + "final_layer.linear", prec)
    return h.reshape(b, g, g, p, p, out_ch).permute(0, 5, 1, 3, 2, 4).reshape(b, out_ch, side, side)


def denoise(P: dict, cfg: dict, noisy: torch.Tensor, sigma: torch.Tensor,
            labels: Optional[torch.Tensor] = None, prec: Precision = FP32) -> torch.Tensor:
    """D(x; sigma) = c_skip x + c_out F(c_in x; c)."""
    sd = cfg["denoiser"]["sigma_data"]
    s = sigma.reshape(-1, 1, 1, 1)
    c_skip = sd ** 2 / (s ** 2 + sd ** 2)
    c_out = s * sd / torch.sqrt(s ** 2 + sd ** 2)
    c_in = 1 / torch.sqrt(sd ** 2 + s ** 2)
    f = net(P, cfg, c_in * noisy, embed(P, cfg, sigma, labels, prec), prec)
    return c_skip * noisy + c_out * f


@torch.no_grad()
def heun(P: dict, cfg: dict, noise: torch.Tensor, labels: Optional[torch.Tensor], num_steps: int,
         prec: Precision = FP32) -> torch.Tensor:
    """EDM's Algorithm 1 (``reference/heun.py``'s steps) on this denoiser."""
    no_tf32()
    t = [float(np.float32(v)) for v in sigma_steps(num_steps)]
    b = noise.shape[0]
    x = noise.float() * t[0]

    def slope(x: torch.Tensor, sigma: float) -> torch.Tensor:
        s = torch.full((b,), sigma, dtype=torch.float32, device=x.device)
        return (x - denoise(P, cfg, x, s, labels, prec)) / sigma

    for i in range(num_steps):
        h = t[i + 1] - t[i]
        d = slope(x, t[i])
        x_next = x + h * d
        if t[i + 1] > 0:
            x_next = x + h * 0.5 * (d + slope(x_next, t[i + 1]))
        x = x_next
    return x


# --- training

def train(cfg: dict, weights: dict[str, torch.Tensor], batches: list, gen_seeds: list[int], steps: int,
          prec: Precision = FP32, half_batch: bool = False, chunk: int = CHUNK) -> Readings:
    """``steps`` training steps from ``weights`` on ``batches`` ((latents
    NCHW, labels or None) on the card), step ``i`` drawing from a generator
    seeded with ``gen_seeds[i]``. ``half_batch`` leaves the second half of
    each microbatch out of its loss (the control's fault)."""
    no_tf32()
    t = cfg["training"]
    device = batches[0][0].device
    P = {k: v.detach().float().clone() for k, v in weights.items()}
    names = [k for k in P if not is_constant(k)]
    p0 = {k: P[k].clone() for k in names}
    mu = {k: torch.zeros_like(P[k]) for k in names}
    nu = {k: torch.zeros_like(P[k]) for k in names}
    gammas = [ema_gamma(s) for s in t["ema_lengths"]]
    emas = [{k: P[k].clone() for k in names} for _ in gammas]
    b1, b2 = t["betas"]
    lr = float(np.float32(t["lr"]))
    accum, dropout = t["accum_steps"], t.get("label_dropout", 0.0)
    sd = cfg["denoiser"]["sigma_data"]
    losses, first_grads = [], None
    for step in range(steps):
        images, labels = batches[step]
        gen = torch.Generator(device=device).manual_seed(gen_seeds[step])
        m = images.shape[0] // accum
        keep = m // 2 if half_batch else m
        grads = {k: torch.zeros_like(P[k]) for k in names}
        total = 0.0
        for i in range(accum):
            rows = slice(i * m, (i + 1) * m)
            x0 = images[rows].float()
            y = None if labels is None else labels[rows]
            if y is not None and dropout > 0:
                drop = torch.rand(y.shape, generator=gen, device=device) < dropout
                y = torch.where(drop, torch.full_like(y, -1), y)
            eps = torch.randn((m,), generator=gen, device=device)
            noise = torch.randn(x0.shape, generator=gen, device=device)
            sigma = torch.exp(t["diffuser"]["P_mean"] + eps * t["diffuser"]["P_std"])
            noisy = x0 + noise * sigma.reshape(-1, 1, 1, 1)
            weight = (sigma ** 2 + sd ** 2) / (sigma * sd) ** 2
            for s0 in range(0, keep, chunk):
                r = slice(s0, min(s0 + chunk, keep))
                leaves = {k: P[k].requires_grad_(True) for k in names}
                d = denoise(P, cfg, noisy[r], sigma[r], None if y is None else y[r], prec)
                n = d.shape[0]
                per_sample = (weight[r].reshape(n, 1) * (d - x0[r]).reshape(n, -1) ** 2).mean(dim=1)
                g = torch.autograd.grad(per_sample.sum() / keep, [leaves[k] for k in names])
                for k, gk in zip(names, g):
                    grads[k] += gk
                total += per_sample.sum().item()
                for k in names:
                    P[k] = P[k].detach()
        losses.append(total)
        with torch.no_grad():
            count = step + 1
            bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
            bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
            for k in names:
                g = grads[k] / accum
                mu[k] = b1 * mu[k] + (1 - b1) * g
                nu[k] = b2 * nu[k] + (1 - b2) * g * g
                P[k] = P[k] - lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + t["eps"])
            if first_grads is None:
                first_grads = {k: float(torch.linalg.vector_norm(grads[k] / accum)) for k in names}
            for ema, gamma in zip(emas, gammas):
                decay = ema_decay(step, gamma)
                for k in names:
                    ema[k] = ema[k] * decay + P[k] * float(np.float32(1) - np.float32(decay))
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(P[k] - p0[k])) for k in names}
        ema_change = [{k: float(torch.linalg.vector_norm(e[k] - p0[k])) for k in names} for e in emas]
    return Readings(losses, first_grads, change, ema_change)
