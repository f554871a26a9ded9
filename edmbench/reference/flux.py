"""The plain reference of FLUX.1 (``black-forest-labs/flux``: ``src/flux/
model.py``, ``modules/layers.py``, ``math.py``; the ``flux-dev`` entry of
``util.py``'s configs) under EDM preconditioning, and of its training step,
in fp32 PyTorch.

Written from the published code's equations and the configuration file
(``edmbench/configs/flux_dev_1024.json``); it imports nothing of the program.
The weights are a dict by the names the program's modules give them
(``param_shapes``), drawn on the card from the seed (``draw_weights``) and
handed to both sides. Every product's operands pass through ``prec.op``
(``reference/precision.py``): fp32 for the reference, fp8 for the control.
TF32 is off (``no_tf32``).

The conditioning is a triple ``(txt, y, guidance)``: the text encoder's
tokens (B, L, context_dim), the pooled text vector (B, vec_dim), the
guidance value (B,).

The model: ``vec = time_in(emb(1000 c_noise)) + guidance_in(emb(1000 g)) +
vector_in(y)``, ``emb`` 256 frequencies ``[cos, sin]`` at periods up to
10000 and each ``*_in`` ``Linear-SiLU-Linear``; the latents packed 2 x 2
through ``img_in``, the tokens through ``txt_in``; the rotary table of the
position ids (text (0, 0, 0), image (0, row, col)) as FLUX's ``EmbedND``
builds it, the 2 x 2 rotation ``[[cos, -sin], [sin, cos]]`` of each channel
pair; ``depth`` double-stream blocks, ``depth_single_blocks`` single-stream
blocks, the last layer, unpacked; EDM's ``c_skip x + c_out F(c_in x)``. In
a block q and k are normalized per head by FLUX's ``RMSNorm`` (``x
rsqrt(mean(x^2) + 1e-6) scale``), rotated, and attend over all tokens at
``1/sqrt(hd)``. Departures from the published model, as in the program:
EDM's preconditioning and loss replace rectified flow's target; ``time_in``
reads ``1000 c_noise``, ``c_noise = ln(sigma) / 4``; caption dropout zeroes
the tokens and the pooled vector; one power-function EMA; Adam at weight
decay 0 stands for AdamW at weight decay 0.

Training (``train``): each step draws, from the generator seeded as the
program's, per microbatch the caption dropout (one uniform a sample), then
the sigmas and the noise, as the program's train step does; the loss is the
mean over the microbatch of ``lambda(sigma) mean((D - x)^2)``, a ``chunk``
of samples at a time; each block is recomputed in its backward
(``torch.utils.checkpoint``, non-reentrant), so that one block's fp32
attention weights live at a time. Then Adam and the EMA profiles.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from edmbench.reference.heun import sigma_steps
from edmbench.reference.precision import FP32, Precision
from edmbench.reference.train import Readings, ema_decay, ema_gamma

LN_EPS = 1e-6
RMS_EPS = 1e-6
MAX_PERIOD = 10000
TIME_FACTOR = 1000.0
CHUNK = 1  # samples a forward and backward in training: one 1024^2 image a card


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every weight, bias and RMSNorm scale by name, with its shape."""
    e, d = cfg["embedding"], cfg["denoiser"]
    c, f = d["hidden_size"], e["frequency_dim"]
    hd = c // d["num_heads"]
    mlp = int(c * d["mlp_ratio"])
    shapes = {}

    def linear(name: str, fan_in: int, fan_out: int) -> None:
        shapes[name + ".weight"] = (fan_out, fan_in)
        shapes[name + ".bias"] = (fan_out,)

    def embedder(name: str, fan_in: int) -> None:
        linear(name + ".in_layer", fan_in, c)
        linear(name + ".out_layer", c, c)

    def qk_norm(name: str) -> None:
        shapes[name + ".query_norm.scale"] = (hd,)
        shapes[name + ".key_norm.scale"] = (hd,)

    embedder("embedding.time_in", f)
    if e["guidance_embed"]:
        embedder("embedding.guidance_in", f)
    embedder("embedding.vector_in", e["vec_in_dim"])
    net = "denoiser.net."
    linear(net + "img_in", d["in_channels"], c)
    linear(net + "txt_in", d["context_in_dim"], c)
    for i in range(d["depth"]):
        for s in ("img", "txt"):
            b = f"{net}double_blocks.{i}.{s}_"
            linear(b + "mod.lin", c, 6 * c)
            linear(b + "attn.qkv", c, 3 * c)
            qk_norm(b + "attn.norm")
            linear(b + "attn.proj", c, c)
            linear(b + "mlp.0", c, mlp)
            linear(b + "mlp.2", mlp, c)
    for i in range(d["depth_single_blocks"]):
        b = f"{net}single_blocks.{i}."
        linear(b + "linear1", c, 3 * c + mlp)
        linear(b + "linear2", c + mlp, c)
        qk_norm(b + "norm")
        linear(b + "modulation.lin", c, 3 * c)
    linear(net + "final_layer.linear", c, d["out_channels"])
    linear(net + "final_layer.adaLN_modulation.1", c, 2 * c)
    return shapes


@torch.no_grad()
def draw_weights(cfg: dict, seed: int, device: torch.device | str) -> dict[str, torch.Tensor]:
    """The weights of ``cfg`` from ``seed``, on ``device``, in three draws:
    every weight xavier-uniform over its (out, in) view, the modulations and
    the last layer included (zeroed, each block would start as the
    identity); every bias N(0, 0.02^2); every RMSNorm scale U(0.5, 1.5), so
    that the scales' gradients and the norm's are both tested."""
    shapes = param_shapes(cfg)
    g = torch.Generator(device=device).manual_seed(seed)
    weights = [k for k in shapes if k.endswith(".weight")]
    biases = [k for k in shapes if k.endswith(".bias")]
    scales = [k for k in shapes if k.endswith(".scale")]
    out = {}
    for k in weights:  # one draw a tensor: the largest are 264 MB, the sum GBs
        s = shapes[k]
        bound = math.sqrt(6.0 / (s[0] + s[1]))
        out[k] = (torch.rand(s, generator=g, device=device) * 2.0 - 1.0) * bound
    flat_b = torch.randn(sum(math.prod(shapes[k]) for k in biases), generator=g, device=device)
    at = 0
    for k in biases:
        size = math.prod(shapes[k])
        out[k] = flat_b[at:at + size] * 0.02
        at += size
    for k in scales:
        out[k] = torch.rand(shapes[k], generator=g, device=device) + 0.5
    return {k: out[k] for k in shapes}


# --- the network

def linear(x: torch.Tensor, P: dict, name: str, prec: Precision) -> torch.Tensor:
    return F.linear(prec.op(x), prec.op(P[name + ".weight"]), P[name + ".bias"])


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """FLUX's ``timestep_embedding``: ``[cos, sin]`` of ``1000 t f``, ``f_i =
    10000^(-i / (dim/2))``."""
    t = TIME_FACTOR * t
    half = dim // 2
    freqs = torch.exp(-math.log(MAX_PERIOD) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def mlp_embedder(x: torch.Tensor, P: dict, name: str, prec: Precision) -> torch.Tensor:
    return linear(F.silu(linear(x, P, name + ".in_layer", prec)), P, name + ".out_layer", prec)


def embed(P: dict, cfg: dict, sigma: torch.Tensor, cond, prec: Precision) -> torch.Tensor:
    """vec (B, C) of the noise level and the conditioning."""
    e = cfg["embedding"]
    _, y, guidance = cond
    vec = mlp_embedder(timestep_embedding(torch.log(sigma) / 4, e["frequency_dim"]), P, "embedding.time_in", prec)
    if e["guidance_embed"]:
        vec = vec + mlp_embedder(timestep_embedding(guidance, e["frequency_dim"]), P, "embedding.guidance_in", prec)
    return vec + mlp_embedder(y, P, "embedding.vector_in", prec)


def rope(pos: torch.Tensor, dim: int, theta: float) -> torch.Tensor:
    """FLUX's ``rope``: (n,) positions -> (n, dim/2, 2, 2) rotations, fp64
    angles cast to fp32."""
    scale = torch.arange(0, dim, 2, dtype=torch.float64, device=pos.device) / dim
    omega = 1.0 / (theta ** scale)
    out = pos.double()[:, None] * omega[None]
    out = torch.stack([torch.cos(out), -torch.sin(out), torch.sin(out), torch.cos(out)], dim=-1)
    return out.reshape(*out.shape[:-1], 2, 2).float()


def position_table(cfg: dict, txt_len: int, h: int, w: int, device) -> torch.Tensor:
    """``EmbedND`` of the text tokens' ids (0, 0, 0) then the image grid's
    (0, row, col): (n, hd/2, 2, 2)."""
    d = cfg["denoiser"]
    img_ids = torch.zeros(h, w, 3, device=device)
    img_ids[..., 1] = img_ids[..., 1] + torch.arange(h, device=device)[:, None]
    img_ids[..., 2] = img_ids[..., 2] + torch.arange(w, device=device)[None, :]
    ids = torch.cat([torch.zeros(txt_len, 3, device=device), img_ids.reshape(h * w, 3)])
    return torch.cat([rope(ids[:, i], dim, d["theta"]) for i, dim in enumerate(d["axes_dim"])], dim=-3)


def apply_rope(x: torch.Tensor, pe: torch.Tensor) -> torch.Tensor:
    """x (b, heads, n, hd) rotated pair by pair by pe (n, hd/2, 2, 2)."""
    x_ = x.float().reshape(*x.shape[:-1], -1, 1, 2)
    out = pe[..., 0] * x_[..., 0] + pe[..., 1] * x_[..., 1]
    return out.reshape(*x.shape)


def rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x ** 2, dim=-1, keepdim=True) + RMS_EPS) * scale


def layer_norm(x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), eps=LN_EPS)


def split_heads(qkv: torch.Tensor, heads: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """'B L (K H D) -> K B H L D'."""
    b, n, c3 = qkv.shape
    return qkv.reshape(b, n, 3, heads, c3 // (3 * heads)).permute(2, 0, 3, 1, 4).unbind(0)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pe: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Softmax attention of the rotated q, k over v, (b, heads, n, hd) -> (b, n, heads hd)."""
    q, k = apply_rope(q, pe), apply_rope(k, pe)
    b, h, n, hd = q.shape
    logits = torch.matmul(prec.op(q), prec.op(k).transpose(-1, -2)) / math.sqrt(hd)
    y = torch.matmul(prec.op(torch.softmax(logits, dim=-1)), prec.op(v))
    return y.transpose(1, 2).reshape(b, n, h * hd)


def modulation(vec: torch.Tensor, P: dict, name: str, n: int, prec: Precision) -> list[torch.Tensor]:
    return [m[:, None, :] for m in linear(F.silu(vec), P, name + ".lin", prec).chunk(n, dim=-1)]


def double_block(img: torch.Tensor, txt: torch.Tensor, vec: torch.Tensor, pe: torch.Tensor, P: dict, p: str,
                 heads: int, prec: Precision) -> tuple[torch.Tensor, torch.Tensor]:
    streams = {"img": img, "txt": txt}
    mods, qkv = {}, {}
    for s, x in streams.items():
        mods[s] = modulation(vec, P, f"{p}{s}_mod", 6, prec)
        shift, scale = mods[s][0], mods[s][1]
        q, k, v = split_heads(linear((1 + scale) * layer_norm(x) + shift, P, f"{p}{s}_attn.qkv", prec), heads)
        norm = f"{p}{s}_attn.norm"
        qkv[s] = (rms_norm(q, P[norm + ".query_norm.scale"]), rms_norm(k, P[norm + ".key_norm.scale"]), v)
    q, k, v = (torch.cat((qkv["txt"][i], qkv["img"][i]), dim=2) for i in range(3))
    attn = attention(q, k, v, pe, prec)
    n_txt = txt.shape[1]
    parts = {"txt": attn[:, :n_txt], "img": attn[:, n_txt:]}
    out = []
    for s in ("img", "txt"):
        x = streams[s]
        _, _, gate1, shift2, scale2, gate2 = mods[s]
        x = x + gate1 * linear(parts[s], P, f"{p}{s}_attn.proj", prec)
        h = linear((1 + scale2) * layer_norm(x) + shift2, P, f"{p}{s}_mlp.0", prec)
        x = x + gate2 * linear(F.gelu(h, approximate="tanh"), P, f"{p}{s}_mlp.2", prec)
        out.append(x)
    return out[0], out[1]


def single_block(x: torch.Tensor, vec: torch.Tensor, pe: torch.Tensor, P: dict, p: str, heads: int,
                 prec: Precision) -> torch.Tensor:
    shift, scale, gate = modulation(vec, P, p + "modulation", 3, prec)
    c = x.shape[-1]
    h = linear((1 + scale) * layer_norm(x) + shift, P, p + "linear1", prec)
    qkv, mlp = h[..., :3 * c], h[..., 3 * c:]
    q, k, v = split_heads(qkv, heads)
    q, k = rms_norm(q, P[p + "norm.query_norm.scale"]), rms_norm(k, P[p + "norm.key_norm.scale"])
    attn = attention(q, k, v, pe, prec)
    return x + gate * linear(torch.cat((attn, F.gelu(mlp, approximate="tanh")), dim=2), P, p + "linear2", prec)


def _run(fn, remat: bool, *args):
    return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)


def net(P: dict, cfg: dict, x: torch.Tensor, vec: torch.Tensor, txt: torch.Tensor, prec: Precision,
        remat: bool = False) -> torch.Tensor:
    """F(c_in x; vec, txt): (B, in/4, H, W) -> (B, out/4, H, W); ``remat``
    recomputes each block in the backward."""
    d = cfg["denoiser"]
    b, ch, side_h, side_w = x.shape
    h, w = side_h // 2, side_w // 2
    pre = "denoiser.net."
    heads = d["num_heads"]
    img = linear(x.reshape(b, ch, h, 2, w, 2).permute(0, 2, 4, 1, 3, 5).reshape(b, h * w, ch * 4), P,
                 pre + "img_in", prec)
    txt = linear(txt, P, pre + "txt_in", prec)
    pe = position_table(cfg, txt.shape[1], h, w, x.device)
    for i in range(d["depth"]):
        img, txt = _run(lambda a, t, i=i: double_block(a, t, vec, pe, P, f"{pre}double_blocks.{i}.", heads, prec),
                        remat, img, txt)
    joint = torch.cat((txt, img), dim=1)
    for i in range(d["depth_single_blocks"]):
        joint = _run(lambda a, i=i: single_block(a, vec, pe, P, f"{pre}single_blocks.{i}.", heads, prec), remat, joint)
    img = joint[:, txt.shape[1]:]
    shift, scale = linear(F.silu(vec), P, pre + "final_layer.adaLN_modulation.1", prec).chunk(2, dim=1)
    out = linear((1 + scale[:, None]) * layer_norm(img) + shift[:, None], P, pre + "final_layer.linear", prec)
    c = d["out_channels"] // 4
    return out.reshape(b, h, w, c, 2, 2).permute(0, 3, 1, 4, 2, 5).reshape(b, c, side_h, side_w)


def denoise(P: dict, cfg: dict, noisy: torch.Tensor, sigma: torch.Tensor, cond, prec: Precision = FP32,
            remat: bool = False) -> torch.Tensor:
    """D(x; sigma) = c_skip x + c_out F(c_in x; cond)."""
    sd = cfg["denoiser"]["sigma_data"]
    s = sigma.reshape(-1, 1, 1, 1)
    c_skip = sd ** 2 / (s ** 2 + sd ** 2)
    c_out = s * sd / torch.sqrt(s ** 2 + sd ** 2)
    c_in = 1 / torch.sqrt(sd ** 2 + s ** 2)
    f = net(P, cfg, c_in * noisy, embed(P, cfg, sigma, cond, prec), cond[0], prec, remat)
    return c_skip * noisy + c_out * f


@torch.no_grad()
def heun(P: dict, cfg: dict, noise: torch.Tensor, cond, num_steps: int, prec: Precision = FP32) -> torch.Tensor:
    """EDM's Algorithm 1 (``reference/heun.py``'s steps) on this denoiser."""
    no_tf32()
    t = [float(np.float32(v)) for v in sigma_steps(num_steps)]
    b = noise.shape[0]
    x = noise.float() * t[0]

    def slope(x: torch.Tensor, sigma: float) -> torch.Tensor:
        s = torch.full((b,), sigma, dtype=torch.float32, device=x.device)
        return (x - denoise(P, cfg, x, s, cond, prec)) / sigma

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
    NCHW, (txt, y, guidance)) on the card), step ``i`` drawing from a
    generator seeded with ``gen_seeds[i]``. ``half_batch`` leaves the second
    half of each microbatch out of its loss (the control's fault: at one
    sample a microbatch, all of it). ``weights`` are read, not changed: the
    changes are taken against them."""
    no_tf32()
    t = cfg["training"]
    device = batches[0][0].device
    names = list(weights)
    P = {k: weights[k].detach().float().clone() for k in names}
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
        images, (txt, y, guidance) = batches[step]
        gen = torch.Generator(device=device).manual_seed(gen_seeds[step])
        m = images.shape[0] // accum
        keep = m // 2 if half_batch else m
        grads = None
        total = 0.0
        for i in range(accum):
            rows = slice(i * m, (i + 1) * m)
            x0 = images[rows].float()
            ct, cy, cg = txt[rows].float(), y[rows].float(), guidance[rows].float()
            if dropout > 0:
                drop = torch.rand((m,), generator=gen, device=device) < dropout
                ct = torch.where(drop[:, None, None], torch.zeros_like(ct), ct)
                cy = torch.where(drop[:, None], torch.zeros_like(cy), cy)
            eps = torch.randn((m,), generator=gen, device=device)
            noise = torch.randn(x0.shape, generator=gen, device=device)
            sigma = torch.exp(t["diffuser"]["P_mean"] + eps * t["diffuser"]["P_std"])
            noisy = x0 + noise * sigma.reshape(-1, 1, 1, 1)
            weight = (sigma ** 2 + sd ** 2) / (sigma * sd) ** 2
            for s0 in range(0, keep, chunk):
                r = slice(s0, min(s0 + chunk, keep))
                leaves = [P[k].requires_grad_(True) for k in names]
                d = denoise(P, cfg, noisy[r], sigma[r], (ct[r], cy[r], cg[r]), prec, remat=True)
                n = d.shape[0]
                per_sample = (weight[r].reshape(n, 1) * (d - x0[r]).reshape(n, -1) ** 2).mean(dim=1)
                g = torch.autograd.grad(per_sample.sum() / keep, leaves)
                del d, leaves
                if grads is None:
                    grads = dict(zip(names, g))
                else:
                    for k, gk in zip(names, g):
                        grads[k] += gk
                del g
                total += per_sample.sum().item()
                for k in names:
                    P[k] = P[k].detach()
        if grads is None:  # nothing kept
            grads = {k: torch.zeros_like(P[k]) for k in names}
        losses.append(total)
        with torch.no_grad():
            count = step + 1
            bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
            bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
            if first_grads is None:
                first_grads = {k: float(torch.linalg.vector_norm(grads[k] / accum)) for k in names}
            for k in names:
                g = grads.pop(k) / accum
                mu[k].mul_(b1).add_((1 - b1) * g)
                nu[k].mul_(b2).add_((1 - b2) * g * g)
                P[k] = P[k] - lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + t["eps"])
            for ema, gamma in zip(emas, gammas):
                decay = ema_decay(step, gamma)
                for k in names:
                    ema[k] = ema[k] * decay + P[k] * float(np.float32(1) - np.float32(decay))
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(P[k] - weights[k].float())) for k in names}
        ema_change = [{k: float(torch.linalg.vector_norm(e[k] - weights[k].float())) for k in names} for e in emas]
    return Readings(losses, first_grads, change, ema_change)
