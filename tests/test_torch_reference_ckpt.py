"""The port's reference-checkpoint interop and orbax converter against the
JAX package's, at smoke width.

- Export: one JAX state (seeded weights, Adam moments and EMA trees) goes
  through the JAX package's orbax save and ``export_torch_checkpoint``, and
  through ``train_state_from_jax``, the port's save and its
  ``export_torch_checkpoint``; the two ``.ckpt`` files are compared key by
  key after ``torch.load``, bit for bit (tensors with their dtype and
  shape): ``state_dict``, ``hyper_parameters``, the flat EMA tuple and the
  Adam state dict; with and without EMA, two profiles with the uncertainty
  head, and both ``use_ema`` inconsistency branches. ``hyper_parameters``
  also for each of the five recipes' specs.
- Import: one ``.ckpt`` imported by both packages gives bit-equal states
  (the port's against ``train_state_from_jax`` of the JAX import), also
  into a ``scan_blocks: true`` config, and forwards within fp32 1e-4
  (measured about 1e-7: the frameworks sum in other orders).
- The orbax converter: a JAX save of a scanned model with two EMA trees,
  then ``experiments/orbax_to_torch_state.py``, then the port's
  ``load_checkpoint``: bit-equal to the JAX state; one port train step from
  it within the fp32 2e-5 of ``test_torch_train_step.py`` of one JAX step.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from tests._torch_parity import rel_l2
from tinyedm_tpu.config import registry as jreg
from tinyedm_tpu.models.edm import EDM as JaxEDM
from tinyedm_tpu.training import train_step as jts
from tinyedm_tpu.training.checkpoint import load_checkpoint as jax_load_checkpoint
from tinyedm_tpu.training.checkpoint import load_edm_from_checkpoint as jax_load_edm
from tinyedm_tpu.training.checkpoint import save_checkpoint as jax_save_checkpoint
from tinyedm_tpu.training.ema import EMAConfig as JaxEMAConfig
from tinyedm_tpu.training.state import TrainState as JaxTrainState
from tinyedm_tpu.utils import interop as jinterop
from tinyedm_tpu_torch.config import registry as preg
from tinyedm_tpu_torch.training.checkpoint import load_checkpoint, load_edm_from_checkpoint
from tinyedm_tpu_torch.training.checkpoint import save_checkpoint
from tinyedm_tpu_torch.utils import interop

ROOT = Path(__file__).resolve().parent.parent
CONF = ROOT / "experiments" / "conf"
IMAGE = (2, 16, 16, 3)
FP32 = ["model.denoiser.dtype=float32", "model.denoiser.dropout_rate=0.0"]


def _model_cfg(overrides=(), name="smoke.yaml") -> dict:
    cfg = jreg.load_config(CONF / name, resolve=False)
    return jreg.apply_overrides(cfg, list(overrides))["model"]


def _specs(overrides=()):
    cfg = _model_cfg(overrides)
    return jreg.instantiate(cfg), preg.instantiate(cfg)


def _yaml_lines(node: dict, indent: str = "") -> list[str]:
    """Block mappings with flow lists: what both packages' readers read."""
    lines = []
    for key, value in node.items():
        if isinstance(value, dict):
            lines += [f"{indent}{key}:", *_yaml_lines(value, indent + "    ")]
        else:
            lines.append(f"{indent}{key}: {yaml.safe_dump(value, default_flow_style=True).strip()}"
                         .removesuffix("\n..."))
    return lines


def _write_yaml(path: Path, model_cfg: dict) -> Path:
    path.write_text("\n".join(_yaml_lines({"model": model_cfg})) + "\n")
    assert yaml.safe_load(path.read_text()) == {"model": model_cfg}
    return path


def _jax_state(jspec, n_ema: int, step: int = 777, seed: int = 0) -> JaxTrainState:
    """Seeded params (gain_out and the uncertainty gain non-zero), non-zero
    Adam moments at count 5, and ``n_ema`` EMA trees that differ from the
    params; numpy leaves."""
    model = jspec.build_model()
    labels = jnp.zeros((IMAGE[0],), jnp.int32)
    variables = jax.jit(lambda k: model.init(
        {"params": k}, jnp.zeros(IMAGE), jnp.ones((IMAGE[0],)), labels,
        method=JaxEDM.denoise_with_aux))(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.standard_normal(np.shape(a)).astype(np.float32) * 0.5,
        variables["params"])
    mu = jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    nu = jax.tree_util.tree_map(lambda a: np.abs(rng.standard_normal(a.shape)).astype(np.float32),
                                params)
    ema = tuple(jax.tree_util.tree_map(lambda a, i=i: a * np.float32(0.9 - 0.1 * i), params)
                for i in range(n_ema))
    return JaxTrainState(
        step=np.int32(step), params=params,
        constants=jax.tree_util.tree_map(np.asarray, variables["constants"]),
        opt_state=optax.ScaleByAdamState(count=np.int32(5), mu=mu, nu=nu), ema=ema,
    )


def _assert_same(a, b, where="ckpt"):
    """Bit-equal nested containers: tensors by dtype, shape and value."""
    if isinstance(b, torch.Tensor):
        assert isinstance(a, torch.Tensor), where
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype, a.shape, b.shape)
        assert torch.equal(a, b), where
    elif isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), (where, sorted(set(a) ^ set(b)))
        for k in b:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


# (spec overrides, EMA trees in the state, exported profile)
EXPORT_CASES = {
    "ema": (["model.use_ema=true", "model.ema_length=0.13"], 1, 0),
    "no-ema": (["model.use_ema=false"], 0, 0),
    "two-profiles-uncertainty": (["model.use_ema=true", "model.ema_lengths=[0.05,0.13]",
                                  "model.use_uncertainty=true"], 2, 1),
    "use-ema-without-trees": (["model.use_ema=true", "model.ema_length=0.13"], 0, 0),
    "trees-without-use-ema": (["model.use_ema=false"], 1, 0),
}


@pytest.mark.parametrize("case", list(EXPORT_CASES))
def test_export_matches_jax(tmp_path, case, capsys):
    overrides, n_ema, ema_index = EXPORT_CASES[case]
    jspec, pspec = _specs(overrides)
    jstate = _jax_state(jspec, n_ema)
    jax_save_checkpoint(tmp_path / "orbax", jstate, config={"model": jreg.deinstantiate(jspec)})
    jinterop.export_torch_checkpoint(str(tmp_path / "orbax"), str(tmp_path / "jax.ckpt"),
                                     ema_index=ema_index)
    jax_said = capsys.readouterr().out.replace(str(tmp_path / "jax.ckpt"), "OUT")

    save_checkpoint(tmp_path / "port", interop.train_state_from_jax(jstate),
                    config={"model": preg.deinstantiate(pspec)})
    interop.main(["export", "--ckpt_dir", str(tmp_path / "port"), "--out", str(tmp_path / "port.ckpt"),
                  "--ema_index", str(ema_index)])
    port_said = capsys.readouterr().out.replace(str(tmp_path / "port.ckpt"), "OUT")
    assert port_said.replace(str(tmp_path / "port"), "IN") == jax_said.replace(str(tmp_path / "orbax"), "IN")

    ours = torch.load(tmp_path / "port.ckpt", map_location="cpu", weights_only=True)
    theirs = torch.load(tmp_path / "jax.ckpt", map_location="cpu", weights_only=False)
    _assert_same(ours, theirs)
    opt0 = ours["optimizer_states"][0]
    if case in ("ema", "two-profiles-uncertainty"):
        assert set(opt0) == {"opt", "ema", "current_step", "gamma", "every_n_steps"}
        assert len(opt0["ema"]) == len(interop.reference_parameter_order(ours["state_dict"]))
    else:
        assert set(opt0) == {"state", "param_groups"}
    assert ours["hyper_parameters"]["use_ema"] == (case in ("ema", "two-profiles-uncertainty"))


@pytest.mark.parametrize("name", ["smoke", "cifar10", "mnist", "imagenet", "imagenet512"])
def test_hyper_parameters_match_jax(name):
    cfg = _model_cfg(name=f"{name}.yaml")
    jspec, pspec = jreg.instantiate(cfg), preg.instantiate(cfg)
    profiles = len(pspec.ema_lengths or (pspec.ema_length,)) if pspec.use_ema else 1
    for index in range(profiles):
        _assert_same(interop.reference_hyper_parameters(pspec, index),
                     jinterop.reference_hyper_parameters(jspec, index))
    # the knobs with no reference counterpart are dropped, as JAX drops them
    knobs = ["model.denoiser.remat=true", "model.denoiser.remat_policy=convs",
             "model.denoiser.scan_blocks=true", "model.denoiser.mod_fp32=false",
             "model.denoiser.use_pallas_attention=true", "model.grad_clip_norm=1.0"]
    pspec2 = preg.instantiate(_model_cfg(knobs, name=f"{name}.yaml"))
    _assert_same(interop.reference_hyper_parameters(pspec2), jinterop.reference_hyper_parameters(jspec))


def test_qkv_permutation_matches_jax():
    """The port's OIHW permutation equals the JAX package's HWIO one, and
    the two directions are inverse: applied twice or not at all, the test
    sees it."""
    rng = np.random.default_rng(0)
    for heads, c in ((2, 64), (4, 256), (1, 8)):
        hwio = rng.standard_normal((1, 1, c, 3 * c)).astype(np.float32)
        oihw = torch.from_numpy(hwio.transpose(3, 2, 0, 1).copy())
        ref = interop.qkv_perm_to_torch(oihw, heads)
        assert torch.equal(ref, torch.from_numpy(jinterop.qkv_perm_to_torch(hwio, heads)))
        assert not torch.equal(ref, oihw)
        assert torch.equal(interop.qkv_perm_from_torch(ref, heads), oihw)
        assert np.array_equal(jinterop.qkv_perm_from_torch(ref.numpy(), heads), hwio)


def _reference_ckpt(tmp_path, overrides, n_ema=1):
    """A reference .ckpt written by the JAX package's export."""
    jspec, _ = _specs(overrides)
    jstate = _jax_state(jspec, n_ema, step=321, seed=3)
    jax_save_checkpoint(tmp_path / "src", jstate, config={"model": jreg.deinstantiate(jspec)})
    jinterop.export_torch_checkpoint(str(tmp_path / "src"), str(tmp_path / "ref.ckpt"))
    return tmp_path / "ref.ckpt", jstate


def _assert_states_equal(a, b):
    assert (a.step, a.count, len(a.ema)) == (b.step, b.count, len(b.ema))
    for x, y in [(a.params, b.params), (a.constants, b.constants), (a.mu, b.mu), (a.nu, b.nu),
                 *zip(a.ema, b.ema)]:
        _assert_same(dict(x), dict(y), "state")


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scan_blocks"])
@pytest.mark.parametrize("load_ema", [False, True], ids=["weights", "load_ema"])
def test_import_matches_jax(tmp_path, scan, load_ema):
    base = FP32 + ["model.use_ema=true", "model.ema_length=0.13", "model.use_uncertainty=true"]
    ckpt, _ = _reference_ckpt(tmp_path, base)
    target = base + (["model.denoiser.scan_blocks=true"] if scan else [])
    config = _write_yaml(tmp_path / "target.yaml", _model_cfg(target))

    jinterop.import_torch_checkpoint(str(ckpt), str(config), str(tmp_path / "jax_in"), load_ema)
    jstate, _ = jax_load_checkpoint(tmp_path / "jax_in")
    if scan:
        assert any(k.startswith("decoder_scan_") for k in jstate.params["denoiser"])
    args = ["--torch_ckpt", str(ckpt), "--config", str(config), "--out_dir", str(tmp_path / "port_in")]
    interop.main(["import", *args] if scan else args + (["--load_ema"] if load_ema else []))
    if scan and load_ema:
        # the import subcommand and the bare form write the same files
        interop.main(args + ["--load_ema"] + ["--out_dir", str(tmp_path / "port_in2")])
    port_dir = tmp_path / ("port_in2" if scan and load_ema else "port_in")
    pstate, pconfig = load_checkpoint(port_dir)
    _assert_states_equal(pstate, interop.train_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate)))
    assert pstate.step == 321 and pstate.count == 0 and len(pstate.ema) == int(load_ema)
    assert pconfig["model"]["denoiser"].get("scan_blocks", False) == scan

    # the forward of the imported weights (EMA where imported) against JAX's
    _, model, _, _ = load_edm_from_checkpoint(port_dir, load_ema=load_ema, device="cpu")
    _, jmodel, jvars, _ = jax_load_edm(tmp_path / "jax_in", load_ema=load_ema)
    rng = np.random.default_rng(9)
    x = rng.standard_normal(IMAGE).astype(np.float32)
    sigma = np.asarray([0.4, 3.0], np.float32)
    labels = np.asarray([1, 7], np.int32)
    ref = np.asarray(jmodel.apply(jvars, jnp.asarray(x), jnp.asarray(sigma), jnp.asarray(labels)))
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(sigma),
                    torch.from_numpy(labels).long()).permute(0, 2, 3, 1).numpy()
    assert rel_l2(out, ref) <= 1e-4


def test_hand_built_reference_layout_forward(tmp_path):
    """A reference .ckpt assembled here from a port model's state_dict, with
    the renames and the (heads, hd, 3) qkv order made by an independent
    reshape: its import computes the port model's forward (fp32 1e-4)."""
    from tinyedm_tpu_torch.models.edm import init_weights

    overrides = FP32 + ["model.use_uncertainty=true"]
    _, pspec = _specs(overrides)
    model = init_weights(pspec.build_model(), torch.Generator().manual_seed(4)).eval()
    with torch.no_grad():
        model.denoiser.gain_out.fill_(1.0)
    heads = pspec.denoiser.num_heads
    ref_sd = {}
    for key, value in model.state_dict().items():
        key = key.replace("cat_factor.conv_0.", "cat_factor.layer1.").replace(
            "cat_factor.conv_1.", "cat_factor.layer2.")
        key = {"u.linear.weight": "u.linear1.weight", "u.linear_out.weight": "u.linear2.weight"}.get(key, key)
        if key.endswith("qkv_conv.weight"):
            c3 = value.shape[0]
            v = value.numpy().reshape(3, heads, c3 // 3 // heads, *value.shape[1:])
            value = torch.from_numpy(np.ascontiguousarray(np.moveaxis(v, 0, 2)).reshape(value.shape))
        ref_sd[key] = value.clone()
    torch.save({"state_dict": ref_sd, "global_step": 5}, tmp_path / "hand.ckpt")
    config = _write_yaml(tmp_path / "c.yaml", _model_cfg(overrides))
    interop.import_torch_checkpoint(tmp_path / "hand.ckpt", config, tmp_path / "imp")
    _, imported, _, _ = load_edm_from_checkpoint(tmp_path / "imp", device="cpu")
    x = torch.randn((2, 3, 16, 16), generator=torch.Generator().manual_seed(5))
    sigma, labels = torch.tensor([0.3, 2.0]), torch.tensor([2, 9])
    with torch.no_grad():
        assert rel_l2(imported(x, sigma, labels).numpy(), model(x, sigma, labels).numpy()) <= 1e-4
    # a raw state_dict .pt imports too, at step 0
    torch.save(ref_sd, tmp_path / "raw.pt")
    assert interop.import_torch_checkpoint(tmp_path / "raw.pt", config, tmp_path / "raw").step == 0


class Unlisted:  # a class no checkpoint reader may unpickle
    pass


def test_torch_load_policy(tmp_path, monkeypatch):
    """Lightning's AttributeDict loads as a dict; any other class raises
    ValueError naming it; a missing EMA raises as the JAX import does."""
    ckpt, _ = _reference_ckpt(tmp_path, [])
    blob = torch.load(ckpt, weights_only=False)
    fake = types.ModuleType("lightning.fabric.utilities.data")

    class AttributeDict(dict):
        pass

    AttributeDict.__module__, AttributeDict.__qualname__ = fake.__name__, "AttributeDict"
    fake.AttributeDict = AttributeDict
    for name in ("lightning", "lightning.fabric", "lightning.fabric.utilities"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.setitem(sys.modules, fake.__name__, fake)
    blob["hyper_parameters"] = AttributeDict(blob["hyper_parameters"])
    torch.save(blob, tmp_path / "lightning.ckpt")
    loaded = interop.load_reference_checkpoint(tmp_path / "lightning.ckpt")
    assert type(loaded["hyper_parameters"]) is dict
    assert loaded["hyper_parameters"] == dict(blob["hyper_parameters"])

    blob["callbacks"] = {"x": Unlisted()}
    torch.save(blob, tmp_path / "bad.ckpt")
    with pytest.raises(ValueError, match="test_torch_reference_ckpt.Unlisted"):
        interop.load_reference_checkpoint(tmp_path / "bad.ckpt")
    config = _write_yaml(tmp_path / "c.yaml", _model_cfg())
    torch.save({"state_dict": blob["state_dict"]}, tmp_path / "noema.ckpt")
    with pytest.raises(ValueError, match="EMA weights not found"):
        interop.import_torch_checkpoint(tmp_path / "noema.ckpt", config, tmp_path / "o", load_ema=True)


def _converter():
    path = ROOT / "experiments" / "orbax_to_torch_state.py"
    spec = importlib.util.spec_from_file_location("orbax_to_torch_state", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_orbax_converter_round_trip_and_step(tmp_path):
    from tests.test_torch_train_step import SCHED_COUNT, _batches, _compare_trees, _Injected, _JaxInjected
    from tinyedm_tpu_torch.data.datamodules import to_device
    from tinyedm_tpu_torch.training.ema import EMAConfig
    from tinyedm_tpu_torch.training.train_step import make_train_step

    overrides = FP32 + ["model.denoiser.scan_blocks=true", "model.use_ema=true",
                        "model.ema_lengths=[0.13,0.05]", "model.lr=0.01", "model.rampup_steps=2",
                        "model.steady_steps=2"]
    jspec, _ = _specs(overrides)
    jstate = _jax_state(jspec, 2, step=40, seed=1)
    assert any(k.startswith("decoder_scan_") for k in jstate.params["denoiser"])
    jax_save_checkpoint(tmp_path / "orbax", jstate, config={"model": jreg.deinstantiate(jspec)})
    _converter().main(["--ckpt_dir", str(tmp_path / "orbax"), "--out_dir", str(tmp_path / "port")])
    pstate, config = load_checkpoint(tmp_path / "port")
    _assert_states_equal(pstate, interop.train_state_from_jax(jstate))
    assert len(pstate.ema) == 2 and pstate.step == 40 and pstate.count == 5

    # one train step on each side from the same state
    images, labels = _batches()[0]
    opt = jspec.build_optimizer_config()
    jmodel = jspec.build_model()
    jstep = jax.jit(jts.make_train_step(jmodel, _JaxInjected(), opt, JaxEMAConfig((0.13, 0.05))))
    jnext, _ = jstep(jax.tree_util.tree_map(jnp.asarray, jstate),
                     (jnp.asarray(images), jnp.asarray(labels)), jax.random.PRNGKey(1), SCHED_COUNT)
    ref = interop.train_state_from_jax(jax.tree_util.tree_map(np.asarray, jnext))

    pspec = preg.instantiate(config["model"])
    model = pspec.build_model().to_empty(device="cpu")
    model.load_state_dict({**pstate.params, **pstate.constants})
    state = dataclasses.replace(pstate, params=dict(model.named_parameters()),
                                constants=dict(model.named_buffers()))
    step = make_train_step(model, _Injected(), pspec.build_optimizer_config(), EMAConfig((0.13, 0.05)))
    state, _ = step(state, to_device(images, labels, "cpu"), None, SCHED_COUNT)
    assert (state.step, state.count) == (ref.step, ref.count) == (41, 6)
    _compare_trees(state.params, ref.params, 2e-5, "params")
    _compare_trees(state.mu, ref.mu, 2e-5, "mu")
    _compare_trees(state.nu, ref.nu, 2e-5, "nu")
    for tree, rtree in zip(state.ema, ref.ema):
        _compare_trees(tree, rtree, 2e-5, "ema")
