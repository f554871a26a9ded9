"""EDMSpec: the experiment description that a config's ``model`` block names.

Counterpart of ``tinyedm_tpu/training/experiment.py``, with the same fields,
defaults and checks. A recipe lives in one place, its YAML file in
``experiments/conf/``; the training CLI instantiates its ``model`` block into
an ``EDMSpec``, and ``configs.py`` reads the same files. The config's
``embedding`` and ``denoiser`` arrive as ``ModuleSpec``s (the registry does
not build a module, which would own its weights); ``build_edm`` builds them
into the port's ``EDM``, parameters allocated but not drawn, for both
``EDMSpec.build_model`` and ``configs.model_from_config``.
``build_optimizer_config`` and ``build_ema_config`` give the port's
``OptimizerConfig`` and ``EMAConfig``, for the CLI and
``configs.build_training`` alike.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Optional

import torch

from tinyedm_tpu_torch.config.registry import ModuleSpec
from tinyedm_tpu_torch.diffusion.diffuser import Diffuser
from tinyedm_tpu_torch.diffusion.protocols import is_conditional
from tinyedm_tpu_torch.models.edm import EDM
from tinyedm_tpu_torch.training.ema import EMAConfig
from tinyedm_tpu_torch.training.train_step import OptimizerConfig


def build_edm(embedding: ModuleSpec, denoiser: ModuleSpec, *, use_uncertainty: bool = False,
              fused: Optional[str] = None, dtype: Optional[torch.dtype] = None,
              knobs: Optional[dict] = None, name: str = "recipe's") -> EDM:
    """The EDM of an embedding and a denoiser spec, parameters allocated but
    not drawn. ``fused`` picks the denoiser's attention route and ``dtype``
    its compute dtype (None: the spec's own); ``knobs`` adds Denoiser
    keywords (``remat``, ``remat_policy``, ``mod_fp32``, ``scan_blocks``).
    A denoiser without a ``fused`` parameter, the DiT's or FLUX's, has one attention
    route and no U-Net knobs: it takes no ``fused``, and knobs raise, naming
    the recipe ``name``."""
    overrides = {} if dtype is None else {"dtype": dtype}
    if "fused" in inspect.signature(denoiser.cls).parameters:
        overrides.update(knobs or {})
        if fused is not None:
            overrides["fused"] = fused
    elif knobs:
        raise ValueError(f"the {name} transformer takes no U-Net knobs, got {sorted(knobs)}")
    return EDM(embedding.build(), denoiser.build(**overrides), use_uncertainty=use_uncertainty)


@dataclasses.dataclass
class EDMSpec:
    diffuser: Diffuser
    embedding: ModuleSpec  # of models.layers.Embedding (models.dit.DiTEmbedding, models.flux.FluxEmbedding)
    denoiser: ModuleSpec  # of models.unet.Denoiser (models.dit.DiTDenoiser, models.flux.FluxDenoiser)
    use_ema: bool = False
    use_uncertainty: bool = False
    steady_steps: int = 1
    rampup_steps: int = 0
    scheduler_interval: str = "epoch"
    sigma_data: Optional[float] = None
    lr: float = 1e-4
    betas: tuple[float, float] = (0.9, 0.999)
    ema_length: Optional[float] = None
    # several tracked EMA profiles (post-hoc reconstruction); defaults to
    # (ema_length,)
    ema_lengths: Optional[tuple[float, ...]] = None
    validate_original_weights: bool = False
    every_n_steps: int = 1
    # accepted for config parity; the EMA update runs on the card in the step
    cpu_offload: bool = False
    accum_steps: int = 1
    log_norms: bool = False  # global grad/param norms as step metrics
    log_norms_per_layer: bool = False  # and per depth-2 group
    grad_clip_norm: Optional[float] = None  # None = off
    label_dropout: float = 0.0  # CFG training: null-label probability
    val_ema_index: int = 0  # the EMA profile that validation evaluates

    def __post_init__(self) -> None:
        if self.use_ema and self.ema_length is None and not self.ema_lengths:
            raise ValueError("ema_length must be specified when use_ema is True.")
        if self.use_ema:
            n_profiles = len(self.ema_lengths or (self.ema_length,))
            if not 0 <= self.val_ema_index < n_profiles:
                raise ValueError(
                    f"val_ema_index={self.val_ema_index} out of range for {n_profiles} tracked EMA profile(s)"
                )
        if not 0.0 <= self.label_dropout < 1.0:
            raise ValueError(f"label_dropout must be in [0, 1), got {self.label_dropout}")
        if self.label_dropout > 0.0 and not self.conditional:
            raise ValueError("label_dropout needs a conditional model (num_classes set, or text-conditioned)")
        if self.sigma_data is not None and self.sigma_data != self.denoiser.sigma_data:
            # one source of truth, as the JAX spec keeps it
            self.denoiser = self.denoiser.replace(sigma_data=self.sigma_data)

    @property
    def conditional(self) -> bool:
        return is_conditional(self.embedding)

    def build_model(self, inference_fast: bool = False, *, fused: Optional[str] = None) -> EDM:
        """The spec's EDM, parameters allocated but not drawn; ``fused``
        overrides the denoiser's attention route (None: the spec's own,
        ``"auto"`` unless the config sets it; a denoiser without routes, the
        DiT's, takes none). ``inference_fast`` selects
        nothing in the port: the JAX package uses it to put sampling on its
        Pallas attention kernel, and the port's fused CUDA kernels are
        already the default route (``fused="auto"``)."""
        del inference_fast
        return build_edm(self.embedding, self.denoiser, use_uncertainty=self.use_uncertainty, fused=fused)

    def build_optimizer_config(self) -> OptimizerConfig:
        return OptimizerConfig(
            lr=self.lr,
            betas=tuple(self.betas),
            rampup_steps=self.rampup_steps,
            steady_steps=self.steady_steps,
            scheduler_interval=self.scheduler_interval,
            accum_steps=self.accum_steps,
            log_norms=self.log_norms,
            log_norms_per_layer=self.log_norms_per_layer,
            grad_clip_norm=self.grad_clip_norm,
            label_dropout=self.label_dropout,
        )

    def build_ema_config(self) -> Optional[EMAConfig]:
        if not self.use_ema:
            return None
        sigma_rels = self.ema_lengths or (self.ema_length,)
        return EMAConfig(sigma_rels=tuple(sigma_rels), every_n_steps=self.every_n_steps)
