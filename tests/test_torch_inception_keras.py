"""The port's ``convert_keras_inception`` against the JAX package's, on stub
keras models (no keras on either machine: both converters read a model by
duck typing, ``tinyedm_tpu/utils/inception.py:291-348``).

The stubs carry an InceptionV3 trunk's 94 Conv2D and 94 BatchNormalization
layers with default names (``conv2d``, ``conv2d_1``, ...; the creation
counter), seeded numpy weights, ``use_bias``, ``scale`` and ``center`` drawn
both ways, the layers shuffled among layers of other classes as a
topological order interleaves branches. Held to:

- the same folded kernels (the port's OIHW against JAX's HWIO) and biases
  within 1e-6 (relative to each tensor's largest magnitude);
- the pool3 features of ``InceptionV3Pool3(tf_avgpool=True)`` in both
  packages, on one seeded 299x299 batch of 2, within 1e-4 relative L2, also
  after ``save_converted(..., tf_avgpool=True)`` and ``load_converted``;
- the same ``ValueError``s: a layer without a default name, and a model
  that is not an InceptionV3 trunk (``expected N conv/bn pairs``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyedm_tpu.utils import inception as jinc
from tinyedm_tpu_torch.utils import inception as pinc


class Conv2D:
    """A keras Conv2D as the converters read it: kernel HWIO."""

    def __init__(self, name, kernel, bias, use_bias):
        self.name, self.kernel, self.bias, self.use_bias = name, kernel, bias, use_bias


class BatchNormalization:
    def __init__(self, name, rng, n, scale, center):
        self.name, self.scale, self.center, self.epsilon = name, scale, center, 1e-3
        self.gamma = rng.uniform(0.5, 1.5, n).astype(np.float32)
        self.beta = (0.1 * rng.standard_normal(n)).astype(np.float32)
        self.moving_mean = (0.1 * rng.standard_normal(n)).astype(np.float32)
        self.moving_variance = rng.uniform(0.5, 2.0, n).astype(np.float32)


class Activation:
    def __init__(self, name):
        self.name = name


class StubModel:
    def __init__(self, layers):
        self.layers = layers


def _suffix(i: int) -> str:
    return "" if i == 0 else f"_{i}"


def stub_inception(seed: int = 0) -> StubModel:
    """A keras-like InceptionV3 trunk of seeded weights: He-scaled HWIO
    kernels, biases and BatchNorm flags drawn per layer, the layers in a
    shuffled order with an activation after each BatchNorm."""
    rng = np.random.default_rng(seed)
    layers = []
    for i, (_, m) in enumerate((n, m) for n, m in pinc.InceptionV3Pool3().named_modules()
                               if isinstance(m, pinc.FoldedConv)):
        o, c, kh, kw = m.conv.weight.shape
        kernel = (rng.standard_normal((kh, kw, c, o)) * np.sqrt(2.0 / (c * kh * kw))).astype(np.float32)
        use_bias = bool(rng.integers(2))
        bias = (0.1 * rng.standard_normal(o)).astype(np.float32) if use_bias else None
        layers.append(Conv2D(f"conv2d{_suffix(i)}", kernel, bias, use_bias))
        layers.append(BatchNormalization(f"batch_normalization{_suffix(i)}", rng, o, scale=bool(rng.integers(2)),
                                         center=bool(rng.integers(2))))
        layers.append(Activation(f"activation{_suffix(i)}"))
    order = rng.permutation(len(layers))
    return StubModel([layers[j] for j in order])


@pytest.fixture(scope="module")
def converted():
    model = stub_inception(0)
    return jinc.convert_keras_inception(model), pinc.convert_keras_inception(model)


def test_flags_drawn_both_ways():
    layers = stub_inception(0).layers
    convs = [x for x in layers if isinstance(x, Conv2D)]
    bns = [x for x in layers if isinstance(x, BatchNormalization)]
    assert len(convs) == len(bns) == 94
    for values in ([c.use_bias for c in convs], [b.scale for b in bns], [b.center for b in bns]):
        assert set(values) == {False, True}
    assert [x.name for x in layers[:3]] != ["conv2d", "batch_normalization", "activation"]  # shuffled


def test_kernels_and_biases_equal_jax(converted):
    jparams, pparams = converted
    jflat = {".".join(str(k.key) for k in path): np.asarray(leaf)
             for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert len(pparams) == len(jflat) == 2 * 94
    for name, value in pparams.items():
        key = name.removesuffix(".weight") + ".kernel" if name.endswith(".weight") else name
        ref = jflat[key]
        if value.ndim == 4:
            ref = ref.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        assert value.dtype == np.float32 and value.shape == ref.shape, name
        assert np.abs(value - ref).max() <= 1e-6 * max(1.0, np.abs(ref).max()), name


def _features(jparams, pparams):
    x = np.random.default_rng(1).uniform(-1.0, 1.0, (2, 299, 299, 3)).astype(np.float32)
    theirs = np.asarray(jax.jit(lambda v: jinc.InceptionV3Pool3(tf_avgpool=True).apply({"params": jparams}, v))(
        jnp.asarray(x)))
    model = pinc.InceptionV3Pool3(tf_avgpool=True)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in pparams.items()})
    with torch.inference_mode():
        ours = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()).numpy()
    return ours, theirs


def test_pool3_features_equal_jax_through_a_weight_file(converted, tmp_path):
    jparams, pparams = converted
    pinc.save_converted(pparams, tmp_path / "keras.npz", tf_avgpool=True, pretrained=False)
    loaded, tf_avgpool, pretrained = pinc.load_converted(tmp_path / "keras.npz")
    assert (tf_avgpool, pretrained) == (True, False) and loaded.keys() == pparams.keys()
    for k, v in pparams.items():
        assert np.array_equal(loaded[k], v), k
    ours, theirs = _features(jparams, loaded)
    assert ours.shape == theirs.shape == (2, 2048)
    assert np.sqrt(np.mean(theirs**2)) > 0.1  # features of scale, not vanished
    assert np.linalg.norm(ours - theirs) / np.linalg.norm(theirs) <= 1e-4


@pytest.mark.parametrize("convert", [jinc.convert_keras_inception, pinc.convert_keras_inception],
                         ids=["jax", "port"])
def test_the_same_errors(convert):
    model = stub_inception(0)
    renamed = next(x for x in model.layers if isinstance(x, Conv2D))
    renamed.name = "MyConv"
    with pytest.raises(ValueError, match="is not default-named"):
        convert(model)
    model = stub_inception(0)
    model.layers = [x for x in model.layers if not (isinstance(x, BatchNormalization) and x.name.endswith("_93"))]
    with pytest.raises(ValueError, match="expected 94 conv/bn pairs, got 94 convs / 93 bns"):
        convert(model)
