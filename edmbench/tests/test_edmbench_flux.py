"""The FLUX cell's pieces on the CPU: ``work_flux.py``'s operations against
PyTorch's count of the reference's products and a count by hand, the
configuration's file against the port's recipe, and the ``flux_train`` kind
set up and stepped at a tiny size through ``run.main``, with a state left
unchanged coming out not correct."""

from __future__ import annotations

import contextlib
import io
import json
import shutil

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from edmbench import run, work_flux
from edmbench.harness import ROOT, Layout
from edmbench.reference.flux import denoise, param_shapes

CELL = "flux_dev_1024.train.b1"


def test_forward_flops_match_flop_counter_and_a_count_by_hand():
    """On meta tensors: PyTorch counts the shapes without computing."""
    cfg = Layout().config("flux_dev_1024")
    d = cfg["denoiser"]
    weights = {k: torch.empty(s, device="meta") for k, s in param_shapes(cfg).items()}
    side = cfg["image_size"]
    x = torch.empty((1, cfg["latent_channels"], side, side), device="meta")
    cond = (torch.empty((1, cfg["txt_len"], d["context_in_dim"]), device="meta"),
            torch.empty((1, cfg["embedding"]["vec_in_dim"]), device="meta"), torch.empty((1,), device="meta"))
    with FlopCounterMode(display=False) as counter:
        denoise(weights, cfg, x, torch.empty((1,), device="meta"), cond)
    assert work_flux.forward_flops(cfg) == sum(counter.get_flop_counts()["Global"].values())
    # by hand, per image: a double block's linears at 4096 image and 512 text
    # tokens, a single block's at 4608, and 4 n^2 C of attention a block
    c, n_img, n_txt = 3072, 4096, 512
    n = n_img + n_txt
    stream = [2 * 3 * c * c, 2 * c * c, 2 * 2 * c * 4 * c]  # qkv, proj, the MLP's two
    double = sum(v * n_img + v * n_txt for v in stream) + 2 * 2 * c * 6 * c
    single = 2 * n * c * 7 * c + 2 * n * 5 * c * c + 2 * c * 3 * c
    attention = 4 * n * n * c
    assert round(double / 1e12, 2) == 1.04 and round(single / 1e12, 2) == 1.04 and round(attention / 1e11, 2) == 2.61
    rest = 2 * (n_img * 64 * c + n_txt * 4096 * c + 3 * c * c + 2 * 256 * c + 768 * c + c * 2 * c + n_img * c * 64)
    blocks = d["depth"] * double + d["depth_single_blocks"] * single
    assert work_flux.forward_flops(cfg) == blocks + (d["depth"] + d["depth_single_blocks"]) * attention + rest
    assert round(work_flux.forward_flops(cfg) / 1e13, 2) == {12: 1.57, 9: 1.18}[d["depth"] + d["depth_single_blocks"]]


def test_flux_config_is_the_ports_recipe():
    from tinyedm_tpu_torch.configs import CONFIGS, TRAINING

    cfg, port, recipe = Layout().config("flux_dev_1024"), CONFIGS["flux_dev_1024"], TRAINING["flux_dev_1024"]
    assert cfg["embedding"] == port["embedding"] and cfg["denoiser"] == port["denoiser"]
    t = cfg["training"]
    assert t["batch_size"] == recipe["batch_size"] and t["accum_steps"] == recipe["accumulate_grad_batches"]
    assert t["lr"] == recipe["lr"] and t["diffuser"] == recipe["diffuser"]
    assert t["label_dropout"] == recipe["label_dropout"] and t["ema_lengths"] == [recipe["ema_length"]]
    assert cfg["use_uncertainty"] == recipe["use_uncertainty"] is False
    assert cfg["image_size"] // 2 * cfg["image_size"] // 2 + cfg["txt_len"] == 4608


TINY = {"embedding": {"hidden_size": 64, "vec_in_dim": 16, "frequency_dim": 256, "guidance_embed": True},
        "denoiser": {"in_channels": 64, "out_channels": 64, "context_in_dim": 32, "hidden_size": 64,
                     "mlp_ratio": 4.0, "num_heads": 2, "depth": 1, "depth_single_blocks": 2,
                     "axes_dim": [8, 12, 12], "theta": 10000.0, "sigma_data": 1.0, "dtype": "bfloat16"},
        "image_size": 8, "txt_len": 8}


@pytest.fixture(scope="module")
def tiny_layout(tmp_path_factory) -> Layout:
    """A copy of the benchmark with a tiny FLUX configuration and a
    ``flux_train`` cell added as new files and entries."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "edmbench", root / "edmbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = {**Layout().config("flux_dev_1024"), **TINY, "name": "flux_tiny"}
    cfg["training"] = {**cfg["training"], "label_dropout": 0.5}
    (root / "edmbench" / "configs" / "flux_tiny.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "flux_tiny", "source": cfg["source"], "file": "edmbench/configs/flux_tiny.json",
                             "reduced": sorted(cfg["reduced"]), "why": "test size"})
    real = Layout().cell(CELL)
    cell = {**real, "config": "flux_tiny", "traffic": "train.b2",
            "params": {"batch": 2, "pool": 2, "check_steps": 2, "trace_units": 2}}
    (root / "edmbench" / "workloads" / "flux_tiny.train.b2.json").write_text(json.dumps(cell))
    bench["workloads"].append({"name": "flux_tiny.train.b2", "config": "flux_tiny", "traffic": "train.b2",
                               "chips": 1, "why": "test size"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("flux_tiny.train.b2")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return Layout(root)


def _run(layout: Layout, seed: int, trace: int = 0) -> tuple[dict, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert run.main(["--workload", "flux_tiny.train.b2", "--seed", str(seed), "--seconds", "0.5",
                         "--trace", str(trace)], layout, device="cpu") == 0
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


@pytest.mark.parametrize("trace", [0, 1])
def test_the_flux_kind_runs_and_prints_the_result_line(tiny_layout, trace):
    result, err = _run(tiny_layout, 2**31 + 17, trace)
    assert result["correct"] is True and result["attempted"] > 0 and result["failed"] == 0, result["checks"]
    assert set(result["checks"]) == {"loss_gap", "grad_gap", "change_gap", "ema_gap"}
    assert "qk_norm_rope calls a step: qk_norm_rope n=24: 3, qk_norm_rope_bwd n=24: 3" in err
    if trace:
        assert "mfu.train" in result["metrics"]  # the device's readers find nothing on the CPU
    else:
        assert set(result["metrics"]) == {"train_samples_per_s", "peak_mem_gib", "setup_s"}


def test_a_state_left_unchanged_comes_out_not_correct(tiny_layout, monkeypatch):
    import tinyedm_tpu_torch.training.train_step as ts

    real = ts.make_train_step

    def make_train_step(*args, **kwargs):
        step = real(*args, **kwargs)

        def unchanged(state, batch, gen, count, interrupt=False):
            saved = [{k: v.clone() for k, v in d.items()} for d in (state.params, *state.ema)]
            out = step(state, batch, gen, count)
            with torch.no_grad():
                for d, s in zip((state.params, *state.ema), saved):
                    for k in d:
                        d[k].copy_(s[k])
            return out

        return unchanged

    monkeypatch.setattr(ts, "make_train_step", make_train_step)
    result, _ = _run(tiny_layout, 2**32 + 5)
    assert result["correct"] is False and result["checks"]["change_gap"]["value"] == pytest.approx(1.0)
