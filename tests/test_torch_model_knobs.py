"""The model knobs of the JAX Denoiser in the port: ``remat``/``remat_policy``,
``scan_blocks``, ``mod_fp32=False`` and ``CosineAttention(fused="on")``.

- remat: ``"full"`` and ``"convs"`` against no remat on the smoke model with
  dropout on, fp32 and bf16: loss and every gradient bit for bit on the CPU
  (the dropout bits are drawn before the recomputed region; the recompute
  repeats the same ops on the same inputs). ``"convs"`` keeps the attention
  forward's output (one forward per layer and step), ``"full"`` recomputes
  it (two).
- ``mod_fp32=False`` (the bf16 island) against the JAX package's at bf16:
  the EDM forward within 2e-2 relative L2 (the bf16 forward's bound of
  ``test_torch_unet.py``) and three train steps within the bf16 step bounds of
  ``test_torch_train_step.py`` (params and EMA 1e-2, Adam moments 1e-1,
  metrics 1e-2 relative), three steps as that file runs them: one step's
  gradient of a block gain differs by up to 16% between the packages in
  bf16, with either island, each side about as far from the fp32 gradient.
- ``fused="on"``: the layer at n 1024 (past MAX_FUSED_TOKENS) and at the odd
  n 25 against the JAX layer with ``fused="on"`` (its Pallas kernel in
  interpret mode, as ``tests/test_fused_attention.py`` runs it), forward and
  input and weight gradients within fp32 1e-5.
- ``scan_blocks``: the flag builds the same per-block modules.
- Each knob, set by a YAML override, builds and trains one step through the
  port's training CLI.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import (
    IMAGE,
    SMOKE_DENOISER,
    SMOKE_EMBEDDING,
    _jax_variables,
    nhwc_to_torch,
    rel_l2,
    torch_to_nhwc,
)
from tests.test_torch_train_step import (
    OPT,
    SCHED_COUNT,
    SIGMA_RELS,
    _batches,
    _compare_trees,
    _Injected,
    _JaxInjected,
)
from tinyedm_tpu.models.edm import EDM as JaxEDM
from tinyedm_tpu.models.layers import CosineAttention as JaxCosineAttention
from tinyedm_tpu.models.layers import Embedding as JaxEmbedding
from tinyedm_tpu.models.unet import Denoiser as JaxDenoiser
from tinyedm_tpu.training import train_step as jts
from tinyedm_tpu.training.ema import EMAConfig as JaxEMAConfig
from tinyedm_tpu_torch import train as port_train
from tinyedm_tpu_torch.data.datamodules import SyntheticDataModule, to_device
from tinyedm_tpu_torch.diffusion.diffuser import Diffuser
from tinyedm_tpu_torch.models.edm import EDM, init_weights
from tinyedm_tpu_torch.models.layers import CosineAttention, Embedding
from tinyedm_tpu_torch.models.unet import Denoiser
from tinyedm_tpu_torch.ops import fused_attention as fa
from tinyedm_tpu_torch.training.ema import EMAConfig
from tinyedm_tpu_torch.training.train_step import (
    OptimizerConfig,
    init_train_state,
    make_grad_fn,
    make_train_step,
)
from tinyedm_tpu_torch.utils.interop import from_jax_variables, train_state_from_jax


def _smoke(dtype, seed=0, **knobs):
    model = EDM(Embedding(**SMOKE_EMBEDDING, num_classes=10),
                Denoiser(**{**SMOKE_DENOISER, "dropout_rate": 0.1}, dtype=dtype, **knobs))
    init_weights(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.denoiser.gain_out.fill_(1.0)
    return model


@pytest.mark.parametrize("policy", ["full", "convs"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_is_bit_equal_to_no_remat(dtype, policy, monkeypatch):
    images, labels = next(SyntheticDataModule(4, image_size=16, num_samples=4).train_batches(0))
    batch = to_device(images, labels, "cpu")
    forwards = []
    plain = fa.cosine_attention_qkv_plain
    monkeypatch.setattr(fa, "cosine_attention_qkv_plain", lambda *a: (forwards.append(1), plain(*a))[1])
    results = []
    for knobs in ({}, dict(remat=True, remat_policy=policy)):
        forwards.clear()
        model = _smoke(dtype, **knobs)
        state = init_train_state(model, OptimizerConfig())
        loss, _, grads = make_grad_fn(model, Diffuser(), OptimizerConfig())(
            state, *batch, torch.Generator().manual_seed(7))
        results.append((loss, grads, len(forwards)))
    (loss0, grads0, fwd0), (loss1, grads1, fwd1) = results
    assert torch.equal(loss0, loss1)
    assert len(grads0) == len(grads1) and all(torch.equal(a, b) for a, b in zip(grads0, grads1))
    assert fwd0 == 2 and fwd1 == (4 if policy == "full" else 2)  # 2 attention layers


def test_remat_options():
    with pytest.raises(ValueError, match="remat_policy"):
        Denoiser(**SMOKE_DENOISER, remat=True, remat_policy="everything")
    scanned = Denoiser(**SMOKE_DENOISER, scan_blocks=True)
    unrolled = Denoiser(**SMOKE_DENOISER)
    assert {k: v.shape for k, v in scanned.state_dict().items()} == \
        {k: v.shape for k, v in unrolled.state_dict().items()}


def _jax_model(mod_fp32: bool):
    return JaxEDM(embedding=JaxEmbedding(**SMOKE_EMBEDDING, num_classes=10),
                  denoiser=JaxDenoiser(**SMOKE_DENOISER, dtype=jnp.bfloat16, mod_fp32=mod_fp32))


def _port_model(mod_fp32: bool):
    return EDM(Embedding(**SMOKE_EMBEDDING, num_classes=10),
               Denoiser(**SMOKE_DENOISER, dtype=torch.bfloat16, mod_fp32=mod_fp32))


def test_bf16_island_forward_matches_jax():
    variables = _jax_variables(0)
    rng = np.random.default_rng(0)
    sigma = np.asarray([0.3, 5.0], np.float32)
    x = (rng.standard_normal(IMAGE) * sigma[:, None, None, None]).astype(np.float32)
    labels = np.asarray([3, 7], np.int32)
    outs = {}
    for mod_fp32 in (True, False):
        port = _port_model(mod_fp32)
        port.load_state_dict(from_jax_variables(variables, port))
        ref = np.asarray(jax.jit(_jax_model(mod_fp32).apply)(
            jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(x), jnp.asarray(sigma),
            jnp.asarray(labels)))
        with torch.no_grad():
            out = torch_to_nhwc(port.eval()(nhwc_to_torch(x), torch.from_numpy(sigma),
                                            torch.from_numpy(labels)))
        assert rel_l2(out, ref) <= 2e-2
        outs[mod_fp32] = out
    assert not np.array_equal(outs[True], outs[False])  # the island's dtype is used


def test_bf16_island_train_step_matches_jax():
    jmodel = _jax_model(False)
    state = jts.init_train_state(jax.random.PRNGKey(0), jmodel, jnp.zeros(IMAGE), jts.OptimizerConfig(**OPT),
                                 JaxEMAConfig(SIGMA_RELS), jnp.zeros((IMAGE[0],), jnp.int32))
    params = {**state.params, "denoiser": {**state.params["denoiser"], "gain_out": jnp.float32(1.0)}}
    start = jax.tree_util.tree_map(np.asarray, state.replace(params=params, ema=(params, params)))
    jstep = jax.jit(jts.make_train_step(jmodel, _JaxInjected(), jts.OptimizerConfig(**OPT),
                                        JaxEMAConfig(SIGMA_RELS)))
    jstate = jax.tree_util.tree_map(jnp.asarray, start)
    model = _port_model(False)
    pstate = train_state_from_jax(start, model)
    step = make_train_step(model, _Injected(), OptimizerConfig(**OPT), EMAConfig(SIGMA_RELS))
    for images, labels in _batches():  # test_torch_train_step.py's protocol: three steps
        jstate, jm = jstep(jstate, (jnp.asarray(images), jnp.asarray(labels)), jax.random.PRNGKey(1),
                           SCHED_COUNT)
        pstate, m = step(pstate, to_device(images, labels, "cpu"), None, SCHED_COUNT)
        for k, v in m.items():
            assert abs(float(v) - float(jm[k])) <= 1e-2 * abs(float(jm[k])) + 1e-7, k
    ref = train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate))
    assert pstate.step == ref.step == 3
    _compare_trees(pstate.params, ref.params, 1e-2, "params")
    _compare_trees(pstate.mu, ref.mu, 1e-1, "mu")
    _compare_trees(pstate.nu, ref.nu, 1e-1, "nu")
    for tree, rtree in zip(pstate.ema, ref.ema):
        _compare_trees(tree, rtree, 1e-2, "ema")


@pytest.mark.parametrize("side", [5, 32], ids=["n25", "n1024"])
def test_fused_on_matches_jax_interpret(side):
    channels, heads = 32, 2
    rng = np.random.default_rng(side)
    x = rng.standard_normal((2, side, side, channels)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jlayer = JaxCosineAttention(num_heads=heads, fused="on")
    variables = jlayer.init(jax.random.PRNGKey(side), jnp.asarray(x))

    def jax_out(params, xx):
        return jlayer.apply({"params": params}, xx)

    ref, vjp = jax.vjp(jax_out, variables["params"], jnp.asarray(x))
    dparams, dx = vjp(jnp.asarray(g))
    dref = from_jax_variables({"params": jax.tree_util.tree_map(np.asarray, dparams)})

    layer = CosineAttention(channels, heads, fused="on")
    layer.load_state_dict(from_jax_variables({"params": jax.tree_util.tree_map(np.asarray, variables["params"])}))
    xt = nhwc_to_torch(x).requires_grad_(True)
    before = fa.cosine_attention_qkv_plain
    calls = []
    fa.cosine_attention_qkv_plain = lambda *a: (calls.append(a[0].shape[1]), before(*a))[1]
    try:
        out = layer(xt)
        out.backward(nhwc_to_torch(g))
    finally:
        fa.cosine_attention_qkv_plain = before
    assert calls == [side * side]  # the fused route at this n
    np.testing.assert_allclose(torch_to_nhwc(out.detach()), np.asarray(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(torch_to_nhwc(xt.grad), np.asarray(dx), atol=1e-5, rtol=1e-5)
    for name, p in layer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), dref[name].numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("knob", [
    "model.denoiser.remat=true", "model.denoiser.remat_policy=convs", "model.denoiser.scan_blocks=true",
    "model.denoiser.mod_fp32=false", "model.denoiser.fused=on",
])
def test_knob_builds_through_the_cli(tmp_path, knob):
    overrides = [knob] + (["model.denoiser.remat=true"] if "remat_policy" in knob else [])
    trainer = port_train.main(["--config-name=smoke", "--device", "cpu", f"trainer.out_dir={tmp_path}",
                               "trainer.max_epochs=1", "datamodule.num_samples=16", *overrides])
    assert trainer.global_step == 1
    key, value = knob.split("=")
    attr = key.rsplit(".", 1)[1]
    den = trainer.model.denoiser
    if attr == "fused":
        assert all(m.fused == "on" for m in den.modules() if isinstance(m, CosineAttention))
    elif attr == "mod_fp32":
        assert not den.encoder_blocks[0].mod_fp32
    else:
        assert getattr(den, attr) == {"true": True, "convs": "convs"}[value]
