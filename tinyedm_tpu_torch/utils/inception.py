"""InceptionV3 pool3 features for FID, and the proxy features.

Counterpart of ``tinyedm_tpu/utils/inception.py``: torchvision's
``inception_v3`` up to its 2048-d global average pool, every BatchNorm
folded into its conv at conversion (eps 1e-3), so the graph is conv + bias
+ ReLU throughout, in NCHW with OIHW kernels. ``tf_avgpool`` picks the
branch pools' border semantic: False divides by 9 everywhere (torchvision,
``count_include_pad=True``), True by the valid count (TF and keras, the
lineage of the canonical FID graph).

Weight files are the JAX package's ``.npz`` format, so a file converted by
either package loads in both: keys are ``jax.tree_util.keystr`` paths such
as ``['Conv2d_1a_3x3']['conv']['kernel']`` with HWIO kernels, beside the
``__tf_avgpool__`` and ``__pretrained__`` stamps; ``load_converted`` turns
HWIO into OIHW. A file without ``pretrained=True`` is a rehearsal
conversion of random weights and is refused unless ``allow_unverified`` is
asked for (``UnverifiedInceptionWeights``). Nothing downloads weights, and
there is no torchvision branch.

``preprocess_uint8`` and ``proxy_feature_fn`` resize as
``jax.image.resize(..., "bilinear")`` does: a triangle kernel with half-pixel
centres, widened by the scale when downsampling (antialiased), plain
bilinear when upsampling. ``proxy_feature_fn`` draws its projections from
``np.random.default_rng(seed)``, the JAX function's draws.
``convert_keras_inception`` reads a keras ``applications.InceptionV3`` by
duck typing, as the JAX function does: no keras import.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tinyedm_tpu_torch.utils.cuda import resolve_device

BN_EPS = 1e-3  # torchvision BasicConv2d's BatchNorm eps


class FoldedConv(nn.Module):
    """Conv + bias + ReLU; the bias and scale come from a folded BatchNorm."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=(0, 0)):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=True)

    def forward(self, x):
        return F.relu(self.conv(x))


def _avgpool3(x, tf_avgpool: bool):
    """3x3 stride-1 pad-1 average pool; ``tf_avgpool`` divides border
    windows by the valid count, else by 9."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=not tf_avgpool)


def _maxpool(x):
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, tf_avgpool: bool):
        super().__init__()
        self.tf_avgpool = tf_avgpool
        self.branch1x1 = FoldedConv(cin, 64, 1)
        self.branch5x5_1 = FoldedConv(cin, 48, 1)
        self.branch5x5_2 = FoldedConv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = FoldedConv(cin, 64, 1)
        self.branch3x3dbl_2 = FoldedConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = FoldedConv(96, 96, 3, padding=1)
        self.branch_pool = FoldedConv(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avgpool3(x, self.tf_avgpool))
        return torch.cat([self.branch1x1(x), b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = FoldedConv(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = FoldedConv(cin, 64, 1)
        self.branch3x3dbl_2 = FoldedConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = FoldedConv(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _maxpool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, tf_avgpool: bool):
        super().__init__()
        self.tf_avgpool = tf_avgpool
        self.branch1x1 = FoldedConv(cin, 192, 1)
        self.branch7x7_1 = FoldedConv(cin, c7, 1)
        self.branch7x7_2 = FoldedConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = FoldedConv(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = FoldedConv(cin, c7, 1)
        self.branch7x7dbl_2 = FoldedConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = FoldedConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = FoldedConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = FoldedConv(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = FoldedConv(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = conv(bd)
        bp = self.branch_pool(_avgpool3(x, self.tf_avgpool))
        return torch.cat([self.branch1x1(x), b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = FoldedConv(cin, 192, 1)
        self.branch3x3_2 = FoldedConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = FoldedConv(cin, 192, 1)
        self.branch7x7x3_2 = FoldedConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = FoldedConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = FoldedConv(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for conv in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = conv(b7)
        return torch.cat([b3, b7, _maxpool(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, tf_avgpool: bool):
        super().__init__()
        self.tf_avgpool = tf_avgpool
        self.branch1x1 = FoldedConv(cin, 320, 1)
        self.branch3x3_1 = FoldedConv(cin, 384, 1)
        self.branch3x3_2a = FoldedConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = FoldedConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = FoldedConv(cin, 448, 1)
        self.branch3x3dbl_2 = FoldedConv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = FoldedConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = FoldedConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = FoldedConv(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        bp = self.branch_pool(_avgpool3(x, self.tf_avgpool))
        return torch.cat([self.branch1x1(x), b3, bd, bp], dim=1)


class InceptionV3Pool3(nn.Module):
    """InceptionV3 up to the 2048-d global average pool (no aux head, no
    fc): (B, 3, 299, 299) in [-1, 1] -> (B, 2048). Its state_dict names are
    torchvision's with ``.bn`` folded away (``Mixed_5b.branch1x1.conv.weight``)."""

    def __init__(self, tf_avgpool: bool = False):
        super().__init__()
        tf = tf_avgpool
        self.Conv2d_1a_3x3 = FoldedConv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = FoldedConv(32, 32, 3)
        self.Conv2d_2b_3x3 = FoldedConv(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = FoldedConv(64, 80, 1)
        self.Conv2d_4a_3x3 = FoldedConv(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, tf)
        self.Mixed_5c = InceptionA(256, 64, tf)
        self.Mixed_5d = InceptionA(288, 64, tf)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, tf)
        self.Mixed_6c = InceptionC(768, 160, tf)
        self.Mixed_6d = InceptionC(768, 160, tf)
        self.Mixed_6e = InceptionC(768, 192, tf)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, tf)
        self.Mixed_7c = InceptionE(2048, tf)

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _maxpool(x)
        x = _maxpool(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


def _fold_bn(sd: dict, prefix: str) -> tuple[np.ndarray, np.ndarray]:
    """Eval-mode BatchNorm folded into the conv before it:
    w' = w * gamma / sqrt(var + eps), b' = beta - mean * gamma / sqrt(var + eps)."""
    w = np.asarray(sd[f"{prefix}.conv.weight"], np.float32)  # OIHW
    gamma = np.asarray(sd[f"{prefix}.bn.weight"], np.float32)
    beta = np.asarray(sd[f"{prefix}.bn.bias"], np.float32)
    mean = np.asarray(sd[f"{prefix}.bn.running_mean"], np.float32)
    var = np.asarray(sd[f"{prefix}.bn.running_var"], np.float32)
    scale = gamma / np.sqrt(var + BN_EPS)
    return w * scale[:, None, None, None], beta - mean * scale


def _conv_prefixes() -> list[str]:
    """Every FoldedConv's name in the module (stems first, then the blocks
    in order): the keys of a converted state dict without ``.conv.*``."""
    return [name for name, m in InceptionV3Pool3().named_modules() if isinstance(m, FoldedConv)]


def convert_torch_inception(state_dict: dict) -> dict[str, np.ndarray]:
    """A torchvision ``inception_v3`` state dict (IMAGENET1K_V1) as the
    state dict of ``InceptionV3Pool3`` (OIHW kernels, BatchNorms folded)."""
    out = {}
    for prefix in _conv_prefixes():
        w, b = _fold_bn(state_dict, prefix)
        out[f"{prefix}.conv.weight"], out[f"{prefix}.conv.bias"] = w, b
    return out


def convert_keras_inception(model) -> dict[str, np.ndarray]:
    """A keras (keras 2 or 3, or tf_keras) ``applications.InceptionV3`` as
    the state dict of ``InceptionV3Pool3`` (OIHW kernels, BatchNorms
    folded); load it with ``tf_avgpool=True``, keras's pool semantic.

    Keras makes one Conv2D and one BatchNormalization per conv, named by a
    global creation counter (``conv2d``, ``conv2d_1``, ...), in the order of
    this module's convs (``_conv_prefixes``); ``model.layers`` is sorted
    topologically and interleaves branches, so the layers are sorted by
    that counter instead. Read by duck typing: ``model.layers``, each
    layer's ``name`` and class name, a Conv2D's ``kernel`` (HWIO),
    ``bias`` and ``use_bias``, a BatchNormalization's ``gamma``, ``beta``,
    ``moving_mean``, ``moving_variance``, ``epsilon``, ``scale`` and
    ``center``."""
    import re

    def creation_index(layer) -> int:
        m = re.fullmatch(r"[a-z_\d]*?(?:_(\d+))?", layer.name)
        if m is None:
            raise ValueError(f"layer {layer.name!r} is not default-named; convert_keras_inception needs a freshly "
                             "built applications.InceptionV3 (default layer names)")
        return int(m.group(1) or 0)

    def of_class(name: str) -> list:
        return sorted((layer for layer in model.layers if layer.__class__.__name__ == name), key=creation_index)

    convs, bns, prefixes = of_class("Conv2D"), of_class("BatchNormalization"), _conv_prefixes()
    if not len(convs) == len(bns) == len(prefixes):
        raise ValueError(f"expected {len(prefixes)} conv/bn pairs, got {len(convs)} convs / {len(bns)} bns - not an "
                         "InceptionV3 trunk")
    out = {}
    for prefix, conv, bn in zip(prefixes, convs, bns):
        w = np.asarray(conv.kernel, np.float32)  # HWIO
        n_out = w.shape[-1]
        gamma = np.asarray(bn.gamma, np.float32) if bn.scale else np.ones(n_out, np.float32)
        beta = np.asarray(bn.beta, np.float32) if bn.center else np.zeros(n_out, np.float32)
        mean = np.asarray(bn.moving_mean, np.float32)
        var = np.asarray(bn.moving_variance, np.float32)
        scale = gamma / np.sqrt(var + bn.epsilon)
        bias = np.asarray(conv.bias, np.float32) if conv.use_bias else 0.0
        out[f"{prefix}.conv.weight"] = np.ascontiguousarray((w * scale).transpose(3, 2, 0, 1))
        out[f"{prefix}.conv.bias"] = beta + (bias - mean) * scale
    return out


def random_torch_state_dict(seed: int = 0) -> dict[str, np.ndarray]:
    """A torchvision-layout ``inception_v3`` trunk state dict of seeded
    random weights, for rehearsals and tests: He-scaled kernels (std
    sqrt(2 / fan_in), so 48 ReLU layers keep the features' scale) and
    non-trivial BatchNorm statistics (gamma in [0.5, 1.5], beta and the
    running mean N(0, 0.1), the running variance in [0.5, 2])."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, m in InceptionV3Pool3().named_modules():
        if isinstance(m, FoldedConv):
            o, i, kh, kw = m.conv.weight.shape
            sd[f"{name}.conv.weight"] = (rng.standard_normal((o, i, kh, kw)) * np.sqrt(2.0 / (i * kh * kw))).astype(
                np.float32)
            sd[f"{name}.bn.weight"] = rng.uniform(0.5, 1.5, o).astype(np.float32)
            sd[f"{name}.bn.bias"] = (0.1 * rng.standard_normal(o)).astype(np.float32)
            sd[f"{name}.bn.running_mean"] = (0.1 * rng.standard_normal(o)).astype(np.float32)
            sd[f"{name}.bn.running_var"] = rng.uniform(0.5, 2.0, o).astype(np.float32)
    return sd


DEFAULT_WEIGHTS = Path("datasets/inception_v3_pool3.npz")
_VARIANT_KEY = "__tf_avgpool__"
_PRETRAINED_KEY = "__pretrained__"


class UnverifiedInceptionWeights(RuntimeError):
    """A converted weight file without the ``pretrained=True`` stamp: a
    rehearsal conversion of a random model, whose scores are not Inception
    FIDs."""


def _npz_key(name: str) -> str:
    """``Mixed_5b.branch1x1.conv.weight`` -> ``['Mixed_5b']['branch1x1']['conv']['kernel']``."""
    parts = name.split(".")
    parts[-1] = {"weight": "kernel", "bias": "bias"}[parts[-1]]
    return "".join(f"['{p}']" for p in parts)


def save_converted(params: dict, path: str | Path = DEFAULT_WEIGHTS, tf_avgpool: bool = False,
                   pretrained: bool = False) -> None:
    """Write a converted state dict in the JAX package's ``.npz`` format
    (HWIO kernels). ``tf_avgpool``: the pool semantic the weights were
    trained under; ``pretrained``: set it only for real ImageNet weights."""
    arrays = {}
    for name, value in params.items():
        value = np.asarray(value.detach().cpu() if isinstance(value, torch.Tensor) else value, np.float32)
        arrays[_npz_key(name)] = value.transpose(2, 3, 1, 0) if value.ndim == 4 else value
    arrays[_VARIANT_KEY] = np.asarray(bool(tf_avgpool))
    arrays[_PRETRAINED_KEY] = np.asarray(bool(pretrained))
    np.savez(path, **arrays)


def load_converted(path: str | Path = DEFAULT_WEIGHTS) -> tuple[dict[str, np.ndarray], bool, bool]:
    """(state dict with OIHW kernels, tf_avgpool, pretrained) of a weight
    file of either package; a missing stamp reads as False."""
    data = np.load(path)
    params, tf_avgpool, pretrained = {}, False, False
    for key in data.files:
        if key == _VARIANT_KEY:
            tf_avgpool = bool(data[key])
        elif key == _PRETRAINED_KEY:
            pretrained = bool(data[key])
        else:
            parts = [p.strip("'") for p in key.replace("]", "").split("[") if p]
            value = data[key]
            if parts[-1] == "kernel":
                parts[-1], value = "weight", value.transpose(3, 2, 0, 1)
            params[".".join(parts)] = np.ascontiguousarray(value)
    return params, tf_avgpool, pretrained


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) fp32 weights of ``jax.image.resize``'s bilinear method:
    a triangle kernel at half-pixel centres, widened by the scale when
    downsampling, each column normalized to sum 1."""
    inv_scale = torch.tensor(1.0 / (n_out / n_in), dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, torch.ones_like(total)), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0).to(device)


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """NHWC fp32 images at ``size`` x ``size``, as ``jax.image.resize(x,
    (N, size, size, C), "bilinear")`` gives them."""
    n, h, w, c = x.shape
    if h != size:
        x = torch.einsum("nhwc,hk->nkwc", x, _resize_weights(h, size, x.device))
    if w != size:
        x = torch.einsum("nhwc,wk->nhkc", x, _resize_weights(w, size, x.device))
    return x


def _rgb_float(images, device) -> torch.Tensor:
    """uint8 NHWC (or NHW) images as fp32 NHWC with 3 channels on ``device``."""
    x = torch.as_tensor(np.asarray(images)).to(device=device, dtype=torch.float32)
    if x.ndim == 3:
        x = x[..., None]
    if x.shape[-1] == 1:
        x = x.repeat(1, 1, 1, 3)
    return x


def preprocess_uint8(images, device: str | torch.device = "cpu") -> torch.Tensor:
    """uint8 NHWC images of any size -> (B, 3, 299, 299) fp32 in [-1, 1]."""
    x = resize_bilinear(_rgb_float(images, device) / 255.0, 299)
    return ((x - 0.5) / 0.5).permute(0, 3, 1, 2).contiguous()


def inception_feature_fn(
    weights_path: str | Path = DEFAULT_WEIGHTS,
    batch: int = 64,
    allow_unverified: bool = False,
    device: Optional[str | torch.device] = None,
):
    """uint8 NHWC -> (N, 2048) fp32 pool3 features from a converted weight
    file, in sub-batches of ``batch`` on ``device`` (the card unless
    ``"cpu"``; fp32 without TF32). The function also carries the
    ``dispatch`` (launch, device tensors) / ``gather`` (to host) pair that
    ``utils.fid`` pipelines with."""
    path = Path(weights_path)
    if not path.exists():
        raise FileNotFoundError(
            f"no converted InceptionV3 weights at {path}; run convert_torch_inception on a torchvision state "
            "dict and save_converted first"
        )
    params, tf_avgpool, pretrained = load_converted(path)
    if not pretrained and not allow_unverified:
        raise UnverifiedInceptionWeights(
            f"{path} is not stamped pretrained=True (it is a rehearsal conversion of a randomized model, not "
            "real InceptionV3). Scores computed with it are NOT Inception FIDs. Pass --features "
            "inception-unverified (CLI) / allow_unverified=True (API) to use it for pipeline rehearsal anyway."
        )
    dev = resolve_device(device)
    model = InceptionV3Pool3(tf_avgpool=tf_avgpool)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    model = model.to(dev).eval()

    @torch.inference_mode()
    def dispatch(images) -> list[torch.Tensor]:
        return [model(preprocess_uint8(images[s : s + batch], dev)) for s in range(0, len(images), batch)]

    def gather(handles) -> np.ndarray:
        return np.concatenate([h.cpu().numpy() for h in handles])

    def fn(images) -> np.ndarray:
        return gather(dispatch(images))

    fn.dispatch, fn.gather = dispatch, gather
    return fn


def proxy_feature_fn(dim: int = 256, seed: int = 0, image_size: int = 32,
                     device: Optional[str | torch.device] = None):
    """Fixed random-feature extractor: resize to ``image_size``, scale to
    [-1, 1], then [P1 x, relu(P2 x)] with Gaussian projections drawn from
    ``np.random.default_rng(seed)``. For relative tracking and pipeline
    checks only: NOT comparable to Inception FID."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    d_in = image_size * image_size * 3
    half = dim // 2
    # the JAX function's draws and arithmetic, in fp32 where it reaches the card
    p1, p2 = (torch.from_numpy((rng.standard_normal((d_in, k)).astype(np.float32) / np.sqrt(d_in)).astype(np.float32))
              .to(dev) for k in (half, dim - half))

    @torch.inference_mode()
    def dispatch(images) -> list[torch.Tensor]:
        x = _rgb_float(images, dev) / 127.5 - 1.0
        x = resize_bilinear(x, image_size) if x.shape[1:3] != (image_size, image_size) else x
        flat = x.reshape(x.shape[0], -1)
        return [torch.cat([flat @ p1, torch.relu(flat @ p2)], dim=-1)]

    def gather(handles) -> np.ndarray:
        return np.concatenate([h.cpu().numpy() for h in handles])

    def fn(images) -> np.ndarray:
        return gather(dispatch(images))

    fn.dispatch, fn.gather = dispatch, gather
    return fn
