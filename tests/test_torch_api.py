"""The port's reference API surface against the JAX package's: the Protocols,
``DenoiserWrapper``, ``mp_cat``, ``mp_dropout`` and the top-level exports.

Tolerances: ``DenoiserWrapper`` in fp32 within rtol 1e-5, atol 1e-6 (the
reference parity test's); ``mp_cat`` fp32 within 1e-6 and bf16 within one
ulp (both sides scale by the same rounded weights, so they are measured
equal); ``mp_dropout`` by its statistics, as ``tests/test_dropout.py`` checks
the JAX one.
"""

from __future__ import annotations

import flax.linen as jnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tinyedm_tpu
import tinyedm_tpu_torch
from tinyedm_tpu.diffusion import protocols as jax_protocols
from tinyedm_tpu.diffusion.diffuser import Diffuser as JaxDiffuser
from tinyedm_tpu.diffusion.solver import DeterministicSolver as JaxDeterministic
from tinyedm_tpu.diffusion.solver import MultistepSolver as JaxMultistep
from tinyedm_tpu.diffusion.solver import StochasticSolver as JaxStochastic
from tinyedm_tpu.models.edm import EDM as JaxEDM
from tinyedm_tpu.models.layers import Embedding as JaxEmbedding
from tinyedm_tpu.models.unet import Denoiser as JaxDenoiser
from tinyedm_tpu.models.unet import DenoiserWrapper as JaxDenoiserWrapper
from tinyedm_tpu.ops.mp import mp_cat as jax_mp_cat
from tinyedm_tpu_torch.config.registry import deinstantiate, instantiate, resolve_target
from tinyedm_tpu_torch.diffusion import protocols
from tinyedm_tpu_torch.diffusion.diffuser import Diffuser
from tinyedm_tpu_torch.diffusion.solver import DeterministicSolver, MultistepSolver, StochasticSolver
from tinyedm_tpu_torch.models.edm import EDM, init_weights
from tinyedm_tpu_torch.models.layers import Embedding, WNConv, WNLinear
from tinyedm_tpu_torch.models.unet import Denoiser, DenoiserWrapper
from tinyedm_tpu_torch.ops.dropout import mp_dropout
from tinyedm_tpu_torch.ops.mp import in_dtype, mp_cat
from tinyedm_tpu_torch.utils.interop import from_jax_variables

torch.set_num_threads(1)

SMALL_DENOISER = dict(in_channels=1, out_channels=1, embedding_dim=16, num_heads=2,
                      encoder_block_types=("Enc", "EncA"), decoder_block_types=("DecA", "Dec", "Dec"),
                      encoder_out_channels=(16, 16), decoder_out_channels=(16, 16, 16),
                      skip_connections=(True, True, True))

# ---------------------------------------------------------------------------
# Protocols
# ---------------------------------------------------------------------------

# (protocol name, the port's object, the JAX package's counterpart)
PROTOCOL_CASES = [
    ("EDMEmbedding", lambda: Embedding(fourier_dim=8, embedding_dim=24, num_classes=3),
     lambda: JaxEmbedding(fourier_dim=8, embedding_dim=24, num_classes=3)),
    ("EDMDiffuser", Diffuser, JaxDiffuser),
    ("EDMDenoiser", lambda: Denoiser(**SMALL_DENOISER), lambda: JaxDenoiser(**SMALL_DENOISER)),
    ("EDMDenoiser", lambda: DenoiserWrapper(torch.nn.Identity(), 0.7),
     lambda: JaxDenoiserWrapper(net=None, sigma_data=0.7)),
    ("EDMSolver", DeterministicSolver, JaxDeterministic),
    ("EDMSolver", MultistepSolver, JaxMultistep),
    ("EDMSolver", StochasticSolver, JaxStochastic),
]


@pytest.mark.parametrize("name,port,jax_obj", PROTOCOL_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(PROTOCOL_CASES)])
def test_port_objects_satisfy_their_protocols(name, port, jax_obj):
    assert isinstance(jax_obj(), getattr(jax_protocols, name))  # as the JAX objects do theirs
    assert isinstance(port(), getattr(protocols, name))


@pytest.mark.parametrize("name", ["EDMDiffuser", "EDMEmbedding", "EDMDenoiser", "EDMSolver"])
def test_objects_without_the_members_do_not(name):
    class Partial:  # two of the embedding's three members, no sigma_data, no solve, not callable
        fourier_dim = 8
        num_classes = None

    assert not isinstance(object(), getattr(protocols, name))
    assert not isinstance(Partial(), getattr(protocols, name))


def test_embedding_keeps_its_dims():
    emb = Embedding(fourier_dim=8, embedding_dim=24, num_classes=None)
    assert (emb.fourier_dim, emb.embedding_dim, emb.num_classes) == (8, 24, None)
    assert emb.sigma_embed.weight.shape == (24, 8)  # the same width it was built with
    del emb.embedding_dim
    assert not isinstance(emb, protocols.EDMEmbedding)


def test_protocols_export_from_the_top():
    for name in ("EDMDiffuser", "EDMEmbedding", "EDMDenoiser", "EDMSolver"):
        assert getattr(tinyedm_tpu_torch, name) is getattr(protocols, name)


# ---------------------------------------------------------------------------
# DenoiserWrapper
# ---------------------------------------------------------------------------


def f(cx, c_noise, emb):
    """tests/test_reference_parity.py's parameter-free net: all three inputs,
    nonlinearly, elementwise (so NHWC and NCHW agree)."""
    return cx * (1.0 + c_noise.reshape(-1, 1, 1, 1)) + 0.25 * (cx**2) * emb.mean(-1).reshape(-1, 1, 1, 1)


class FlaxNet(jnn.Module):
    def __call__(self, cx, c_noise, emb):
        return f(cx, c_noise, emb)


class TorchNet(torch.nn.Module):
    def forward(self, cx, c_noise, emb):
        return f(cx, c_noise, emb)


def _wrapper_inputs(seed=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 6, 6, 3)).astype(np.float32)
    sigma = np.exp(rng.normal(-1.2, 1.2, size=(4,))).astype(np.float32)
    emb = rng.standard_normal((4, 16)).astype(np.float32)
    return x, sigma, emb


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("sigma_data", [0.5, 0.7])
def test_denoiser_wrapper_matches_jax(sigma_data):
    x, sigma, emb = _wrapper_inputs()
    ref = np.asarray(JaxDenoiserWrapper(net=FlaxNet(), sigma_data=sigma_data).apply(
        {"params": {}}, jnp.asarray(x), jnp.asarray(sigma), jnp.asarray(emb)))
    port = DenoiserWrapper(TorchNet(), sigma_data)
    assert port.sigma_data == sigma_data and not list(port.parameters())
    out = port(_nchw(x), torch.from_numpy(sigma), torch.from_numpy(emb))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), ref, rtol=1e-5, atol=1e-6)


def test_denoiser_wrapper_runs_the_net_on_fp32_and_upcasts_its_output():
    class Bf16Net(torch.nn.Module):
        def forward(self, cx, c_noise, emb):
            assert cx.dtype == torch.float32 and c_noise.shape == (cx.shape[0],)
            return TorchNet()(cx, c_noise, emb).to(torch.bfloat16)

    x, sigma, emb = _wrapper_inputs(3)
    out = DenoiserWrapper(Bf16Net())(_nchw(x), torch.from_numpy(sigma), torch.from_numpy(emb))
    ref = DenoiserWrapper(TorchNet())(_nchw(x), torch.from_numpy(sigma), torch.from_numpy(emb))
    assert out.dtype == torch.float32
    assert not torch.equal(out, ref)  # F was rounded to bf16, the combine was not
    torch.testing.assert_close(out, ref, rtol=2e-2, atol=2e-2)


class TrainAwareNet(torch.nn.Module):
    def forward(self, x, c_noise, emb=None, train=False):
        return x * (2.0 if train else 1.0)


class BareNet(torch.nn.Module):
    def forward(self, x, c_noise, emb=None):
        return x


class DropoutNet(torch.nn.Module):
    """Takes ``train`` and ``generator``, as the port's ``Denoiser`` does."""

    def forward(self, x, c_noise, emb=None, train=False, generator=None):
        return mp_dropout(x, 0.5, generator) if train else x


class JaxTrainAwareNet(jnn.Module):
    @jnn.compact
    def __call__(self, x, c_noise, emb=None, *, train=False):
        return x * (2.0 if train else 1.0)


class JaxBareNet(jnn.Module):
    @jnn.compact
    def __call__(self, x, c_noise, emb=None):
        return x


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("nets", [(TrainAwareNet, JaxTrainAwareNet), (BareNet, JaxBareNet)], ids=["aware", "bare"])
def test_denoiser_wrapper_forwards_the_train_flag(nets, train):
    """tests/test_unet.py's case: ``train`` reaches a net that takes it; a
    bare net keeps the three-argument call (no TypeError) in both packages."""
    port_net, jax_net = nets
    x = np.ones((2, 4, 4, 3), np.float32)
    sigma = np.full((2,), 0.7, np.float32)
    w = JaxDenoiserWrapper(net=jax_net())
    v = w.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), jnp.asarray(sigma))
    ref = np.asarray(w.apply(v, jnp.asarray(x), jnp.asarray(sigma), train=train))
    out = DenoiserWrapper(port_net())(_nchw(x), torch.from_numpy(sigma), None, train)
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), ref, rtol=1e-6, atol=1e-6)
    evaluated = DenoiserWrapper(port_net())(_nchw(x), torch.from_numpy(sigma), None, False)
    assert torch.equal(out, evaluated) == (not train or port_net is BareNet)


def test_denoiser_wrapper_passes_the_generator():
    x = torch.ones((2, 3, 8, 8))
    sigma = torch.full((2,), 0.7)
    w = DenoiserWrapper(DropoutNet())
    a = w(x, sigma, None, True, torch.Generator().manual_seed(1))
    b = w(x, sigma, None, True, torch.Generator().manual_seed(1))
    c = w(x, sigma, None, True, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(w(x, sigma, None, False, torch.Generator().manual_seed(1)), w(x, sigma))


def test_denoiser_wrapper_inside_edm_matches_jax():
    """An EDM holding a DenoiserWrapper, port against JAX, the embedding's
    weights carried over by from_jax_variables."""

    class EmbNet(jnn.Module):
        def __call__(self, cx, c_noise, emb):
            return f(cx, c_noise, emb)

    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 5, 5, 2)).astype(np.float32)
    sigma = np.exp(rng.normal(-1.2, 1.2, size=(3,))).astype(np.float32)
    labels = np.asarray([0, 2, 1], np.int32)
    jmodel = JaxEDM(embedding=JaxEmbedding(fourier_dim=8, embedding_dim=12, num_classes=3),
                    denoiser=JaxDenoiserWrapper(net=EmbNet(), sigma_data=0.6))
    args = (jnp.asarray(x), jnp.asarray(sigma), jnp.asarray(labels))
    variables = jmodel.init({"params": jax.random.PRNGKey(0)}, *args)
    ref = np.asarray(jmodel.apply(variables, *args))
    port = EDM(Embedding(fourier_dim=8, embedding_dim=12, num_classes=3), DenoiserWrapper(TorchNet(), 0.6))
    port.load_state_dict(from_jax_variables(jax.tree_util.tree_map(np.asarray, variables), port))
    assert port.sigma_data == 0.6 and port.conditional
    with torch.no_grad():
        out = port(_nchw(x), torch.from_numpy(sigma), torch.from_numpy(labels))
        aux, uncertainty = port.denoise_with_aux(_nchw(x), torch.from_numpy(sigma), torch.from_numpy(labels))
    assert uncertainty is None and torch.equal(out, aux)
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), ref, rtol=1e-5, atol=1e-6)


def test_denoiser_wrapper_resolves_through_the_registry():
    assert resolve_target("tinyedm.DenoiserWrapper") is DenoiserWrapper
    assert resolve_target("tinyedm_tpu.models.unet.DenoiserWrapper") is DenoiserWrapper
    spec = instantiate({"_target_": "tinyedm.DenoiserWrapper", "sigma_data": 0.7})
    assert spec.cls is DenoiserWrapper and spec.sigma_data == 0.7
    wrapper = spec.build(net=TorchNet())
    assert isinstance(wrapper, DenoiserWrapper) and wrapper.sigma_data == 0.7
    assert deinstantiate(spec) == {"_target_": "tinyedm_tpu.models.unet.DenoiserWrapper", "sigma_data": 0.7}


def test_denoiser_wrapper_around_a_denoiser_trains():
    """A wrapped net with weights: gradients reach them through the wrapper,
    and dropout bits come from the generator."""

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = WNConv(1, 1, 3)

        def forward(self, x, c_noise, emb=None, train=False, generator=None):
            y = self.conv(x)
            return mp_dropout(y, 0.2, generator) if train else y

    net = Net()
    init_weights(net, torch.Generator().manual_seed(0))
    w = DenoiserWrapper(net)
    x = torch.randn((2, 1, 6, 6), generator=torch.Generator().manual_seed(1))
    loss = w(x, torch.full((2,), 1.3), None, True, torch.Generator().manual_seed(2)).square().mean()
    (g,) = torch.autograd.grad(loss, [net.conv.weight])
    assert torch.isfinite(g).all() and float(g.abs().sum()) > 0


# ---------------------------------------------------------------------------
# mp_cat
# ---------------------------------------------------------------------------

MP_CAT_CASES = [  # (shape of a, shape of b, axis)
    ((2, 4, 4, 3), (2, 4, 4, 5), -1),  # NHWC channels, the JAX package's default axis
    ((2, 3, 4, 4), (2, 5, 4, 4), 1),  # NCHW channels, the port's images
    ((3, 7), (3, 7), -1),  # equal widths
    ((2, 6, 3), (2, 1, 3), 1),  # one-wide b
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [0.3, 0.5])
@pytest.mark.parametrize("shapes", MP_CAT_CASES, ids=[f"{len(c[0])}d-axis{c[2]}-{c[0][c[2]]}+{c[1][c[2]]}"
                                                       for c in MP_CAT_CASES])
def test_mp_cat_matches_jax(shapes, t, dtype):
    sa, sb, axis = shapes
    rng = np.random.default_rng(len(sa) + sa[axis] + sb[axis])
    a = rng.standard_normal(sa).astype(np.float32)
    b = rng.standard_normal(sb).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax_mp_cat(jnp.asarray(a, jdt), jnp.asarray(b, jdt), axis=axis, t=t)
    out = mp_cat(torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt), dim=axis, t=t)
    assert out.dtype == tdt and tuple(out.shape) == ref.shape
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
    else:  # one bf16 ulp: 2**-7 of the magnitude
        np.testing.assert_array_less(np.abs(out.float().numpy() - ref), 2.0**-7 * np.abs(ref) + 1e-30)


def test_mp_cat_keeps_unit_magnitude():
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn((4096, 48), generator=g), torch.randn((4096, 80), generator=g)
    for t in (0.3, 0.5):
        out = mp_cat(a, b, t=t)
        assert abs(float(out.square().mean()) - 1.0) < 2e-2
        # the weights' ratio is (1 - t) / t per unit of width
        ra = float(out[:, :48].square().mean() / out[:, 48:].square().mean())
        assert abs(ra - ((1 - t) ** 2 * 80) / (t**2 * 48)) < 0.1 * ra


# ---------------------------------------------------------------------------
# mp_dropout
# ---------------------------------------------------------------------------


def test_mp_dropout_keep_fraction_and_exact_scale():
    x = torch.ones((1024, 512))
    y = mp_dropout(x, 0.13, torch.Generator().manual_seed(0))
    keep = float((y != 0).float().mean())
    assert abs(keep - 0.87) < 5e-3
    assert abs(float(y.mean()) - 1.0) < 5e-3
    survivors = y[y != 0]
    assert torch.all(survivors == in_dtype(1.0 / 0.87, torch.float32))
    np.testing.assert_allclose(survivors.numpy(), 1.0 / 0.87, rtol=1e-6)  # the JAX package's survivors


def test_mp_dropout_identity_at_rate_zero_and_same_mask_from_same_generator():
    x = torch.randn((64, 64), generator=torch.Generator().manual_seed(7))
    assert mp_dropout(x, 0.0, torch.Generator().manual_seed(1)) is x
    y1 = mp_dropout(x, 0.5, torch.Generator().manual_seed(1))
    y2 = mp_dropout(x, 0.5, torch.Generator().manual_seed(1))
    y3 = mp_dropout(x, 0.5, torch.Generator().manual_seed(2))
    assert torch.equal(y1, y2) and not torch.equal(y1, y3)


def test_mp_dropout_dtype_and_gradients():
    x = torch.randn((32, 32), generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    assert mp_dropout(x, 0.25, torch.Generator().manual_seed(1)).dtype == torch.bfloat16
    w = torch.ones((8, 8), requires_grad=True)
    (g,) = torch.autograd.grad(mp_dropout(w, 0.25, torch.Generator().manual_seed(1)).sum(), [w])
    nz = g[g != 0]
    assert nz.numel() > 0 and torch.all(nz == in_dtype(1.0 / 0.75, torch.float32))


# ---------------------------------------------------------------------------
# The top-level exports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(tinyedm_tpu.__all__))
def test_every_reference_name_imports_from_the_port(name):
    assert name in tinyedm_tpu_torch.__all__
    obj = getattr(tinyedm_tpu_torch, name)
    assert obj.__module__.split(".")[0] == "tinyedm_tpu_torch"
    assert obj.__name__ == getattr(tinyedm_tpu, name).__name__


def test_aliases_all_and_version():
    assert tinyedm_tpu_torch.Linear is WNLinear and tinyedm_tpu_torch.Conv2d is WNConv
    assert tinyedm_tpu_torch.DenoiserWrapper is DenoiserWrapper
    assert tinyedm_tpu_torch.PreditionWriter.__name__ == "PreditionWriter"  # the reference's spelling
    assert len(set(tinyedm_tpu_torch.__all__)) == len(tinyedm_tpu_torch.__all__)
    assert all(hasattr(tinyedm_tpu_torch, n) for n in tinyedm_tpu_torch.__all__)
    assert tinyedm_tpu_torch.__version__ == tinyedm_tpu.__version__


# ROADMAP.md section 1's table: public names of tinyedm_tpu/ whose module in
# the port has no definition of the same name, by JAX module
JAX_ONLY = {
    "utils/tpu.py": {"tune_for_tpu", "enable_compilation_cache", "enable_fast_rng"},
    "parallel/mesh.py": {"make_mesh", "DATA_AXIS", "MODEL_AXIS", "ShardingPlan", "batch_sharding", "replicated",
                         "constrain", "constrain_kernel", "constraint_mesh", "place_state", "place_variables",
                         "replicate_state", "state_shardings", "variables_shardings", "tp_param_spec", "zero1_spec"},
    "parallel/audit.py": {"COLLECTIVE_KINDS", "group_shape", "while_body_computations"},
    "generate.py": {"local_rows", "assemble_local_batch"},
    "training/train_step.py": {"make_adam"},
    "data/vae.py": {"JaxVAE", "convert_torch_vae", "Dtype"},
    "data/extract_latents.py": {"IMG_EXTENSIONS", "center_crop_arr", "list_image_folder"},
    "ops/attention.py": {"MIN_PALLAS_TOKENS"},
    "utils/interop.py": {"denoiser_params_to_torch", "denoiser_params_from_torch", "embedding_to_torch",
                         "embedding_from_torch", "migrate_params_to_scanned"},
    "models/blocks.py": {"Dtype"},
    "models/layers.py": {"Dtype"},
    "models/unet.py": {"Dtype"},
    "utils/profiling.py": {"StepTimer", "device_memory_stats"},
}


def _public_names(path):
    import ast

    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def test_every_public_jax_name_has_a_counterpart():
    from pathlib import Path

    jax_root = Path(tinyedm_tpu.__file__).parent
    port_root = Path(tinyedm_tpu_torch.__file__).parent
    missing = {}
    for path in sorted(jax_root.rglob("*.py")):
        rel = path.relative_to(jax_root).as_posix()
        port = port_root / rel
        lacking = _public_names(path) - (_public_names(port) if port.exists() else set())
        if lacking:
            missing[rel] = lacking
    assert missing == JAX_ONLY
