"""The DiT configuration's file against the port's recipe, beside
``test_edmbench_harness.py::test_configs_are_the_ports_recipes``."""

from __future__ import annotations

from edmbench.harness import Layout


def test_dit_config_is_the_ports_recipe():
    """The file holds the port's model constants; its training block is one
    rank's microbatch of the recipe at the recipe's lr, law and dropout."""
    from tinyedm_tpu_torch.configs import CONFIGS, TRAINING

    cfg, port, recipe = Layout().config("dit_xl2_512"), CONFIGS["dit_xl2_512"], TRAINING["dit_xl2_512"]
    assert cfg["embedding"] == port["embedding"] and cfg["denoiser"] == port["denoiser"]
    t = cfg["training"]
    assert t["batch_size"] // t["accum_steps"] == recipe["batch_size"] // recipe["accumulate_grad_batches"]
    assert t["lr"] == recipe["lr"] and t["diffuser"] == recipe["diffuser"]
    assert t["label_dropout"] == recipe["label_dropout"] and t["ema_lengths"] == [recipe["ema_length"]]
    assert (t["rampup_steps"], t["steady_steps"]) == (recipe["rampup_steps"], recipe["steady_steps"])
    assert cfg["use_uncertainty"] == recipe["use_uncertainty"] is False
    assert cfg["published"]["batch_size"] == recipe["batch_size"]
