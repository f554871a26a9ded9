"""The null label: the port's ``ClassEmbedding`` and conditional model
against the JAX package's on labels outside ``[0, num_classes)``.

Guidance feeds the null label -1 to the unconditional half of a batch and
label dropout replaces dropped labels with it
(``tinyedm_tpu/diffusion/guidance.py``). ``jax.nn.one_hot`` maps -1, and any
label >= num_classes, to a zero row; the port must give the same row, never
raise (``F.one_hot`` raises on -1, and on the card asserts on the device).

Tolerances: the embedding alone within 1e-5 (one fp32 product of a
weight-normed matrix); the small model within 1e-4 max abs, as
``tests/test_torch_unet.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_parity import IMAGE, nhwc_to_torch, small_models, torch_to_nhwc
from tinyedm_tpu.models.layers import ClassEmbedding as JaxClassEmbedding
from tinyedm_tpu_torch.models.layers import ClassEmbedding


@pytest.mark.parametrize("labels", [[2, -1, 4], [-1, -1, -1], [0, 3, 1]],
                         ids=["mixed", "all_null", "in_range"])
def test_class_embedding_matches_jax(labels):
    num_classes, dim = 4, 8
    labels = np.asarray(labels, np.int32)
    jmod = JaxClassEmbedding(num_classes=num_classes, embedding_dim=dim)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(labels))
    ref = np.asarray(jmod.apply(variables, jnp.asarray(labels)))
    port = ClassEmbedding(num_classes, dim)
    w = np.array(variables["params"]["WNLinear_0"]["w"], np.float32)
    port.load_state_dict({"linear.weight": torch.from_numpy(w)})
    with torch.no_grad():
        out = port(torch.from_numpy(labels)).numpy()
    assert out.shape == ref.shape == (3, dim)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_out_of_range_labels_give_the_null_embedding():
    """-1 and num_classes both embed the zero row: the same output."""
    port = ClassEmbedding(4, 8)
    port.linear.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = port(torch.tensor([-1, 4, 7]))
        zero = port.linear(torch.zeros(1, 4))
    torch.testing.assert_close(out, zero.expand(3, -1), rtol=0, atol=0)


@pytest.mark.parametrize("labels", [[3, -1], [-1, -1]], ids=["mixed", "all_null"])
def test_conditional_model_with_null_labels_matches_jax(labels):
    jmodel, variables, port = small_models(10, torch.float32)
    rng = np.random.default_rng(5)
    sigma = np.asarray([0.3, 5.0], np.float32)
    x = (rng.standard_normal(IMAGE) * sigma[:, None, None, None]).astype(np.float32)
    labels = np.asarray(labels, np.int32)
    ref = np.asarray(jax.jit(jmodel.apply)(
        jax.tree_util.tree_map(jnp.asarray, variables),
        jnp.asarray(x), jnp.asarray(sigma), jnp.asarray(labels),
    ))
    with torch.no_grad():
        out = port(nhwc_to_torch(x), torch.from_numpy(sigma), torch.from_numpy(labels))
    out = torch_to_nhwc(out)
    assert out.shape == ref.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)
