"""The training recipe that the measurement tools and chip_smoke.py run: the
stage configs (configs/stage_2.yaml's and stage_3.yaml's training values,
written out because the card's machine has no yaml parser), a seeded batch
of the dataset's shapes, and one stage's train step built on seeded random
weights with `build_train_step`."""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict

import torch

from ..io.loaders import init_pipeline_random_
from ..models import UNetConfig
from ..pipelines.pipeline import PipelineModels, VExpressPipeline
from .train_step import (TrainConfig, TrainOptimizer, build_train_step, make_optimizer,
                         stage_zero_init)

_SOLVER = {"gradient_accumulation_steps": 1, "reference_net_gradient_checkpointing": False,
           "denoising_unet_gradient_checkpointing": True, "max_train_steps": 300000,
           "max_grad_norm": 1.0, "learning_rate": 1.0e-6, "lr_warmup_steps": 1,
           "lr_scheduler": "constant", "adam_beta1": 0.9, "adam_beta2": 0.999,
           "adam_weight_decay": 1.0e-2, "adam_epsilon": 1.0e-8, "use_8bit_adam": True}
STAGE_CONFIGS: Dict[str, Dict[str, Any]] = {
    "stage_2": {
        "train_stage": "stage_2",
        "data": {"train_bs": 1, "train_width": 512, "train_height": 512, "num_frames": 20,
                 "lip_loss_weight": 1, "reference_drop_rate": 0, "kps_drop_rate": 0},
        "module_training": {"denoising_unet": False, "reference_net": False,
                            "v_kps_guider": False, "audio_projection": True,
                            "motion_module": True},
        "solver": dict(_SOLVER),
        "uncond_ratio": 0.1, "noise_offset": 0.05, "snr_gamma": 5.0, "enable_zero_snr": True,
    },
    "stage_3": {
        "train_stage": "stage_3",
        "data": {"train_bs": 1, "train_width": 512, "train_height": 512, "num_frames": 8,
                 "lip_loss_weight": 1, "reference_drop_rate": 0, "kps_drop_rate": 0},
        "module_training": {"denoising_unet": True, "reference_net": True,
                            "v_kps_guider": True, "audio_projection": True,
                            "motion_module": True},
        "solver": dict(_SOLVER, denoising_unet_gradient_checkpointing=False,
                       max_train_steps=100000),
        "uncond_ratio": 0.1, "noise_offset": 0.05, "snr_gamma": 5.0, "enable_zero_snr": True,
    },
}


def stage_config(stage: str) -> Dict[str, Any]:
    """A fresh copy of one stage's config dict."""
    return copy.deepcopy(STAGE_CONFIGS[stage])


def synthetic_train_batch(size: int, frames: int, audio_dim: int, seed: int, device,
                          batch: int = 1) -> Dict[str, torch.Tensor]:
    """A seeded batch of the dataset's shapes: target frames and reference
    image in [-1, 1], kps frames in [0, 1], wav2vec2 window embeddings
    (F, 10, audio_dim), lip masks at latent resolution."""
    g = torch.Generator().manual_seed(seed)
    lat, b = size // 8, batch
    out = dict(target_images=torch.rand((b, frames, size, size, 3), generator=g) * 2 - 1,
               reference_image=torch.rand((b, size, size, 3), generator=g) * 2 - 1,
               kps_images=torch.rand((b, frames, size, size, 3), generator=g),
               audio_frame_embeddings=torch.randn((b, frames, 10, audio_dim), generator=g),
               lip_masks=torch.rand((b, frames, lat, lat), generator=g))
    return {k: v.to(device) for k, v in out.items()}


@dataclasses.dataclass
class StageStep:
    config: TrainConfig
    unet_config: UNetConfig  # with the stage's gradient checkpointing
    models: Dict[str, torch.nn.Module]  # after stage_zero_init
    optimizer: TrainOptimizer
    mask: Dict[str, Dict[str, bool]]
    step_fn: Callable
    batch: Dict[str, torch.Tensor]

    @property
    def trainable_params(self) -> int:
        return sum(p.numel() for m, mod in self.models.items()
                   for n, p in mod.named_parameters() if self.mask[m][n])


def build_stage_step(models: PipelineModels, stage: str, frames: int, size: int,
                     device) -> StageStep:
    """One stage's train step at `frames` frames of `size`² (batch 1): the
    stage config routed as the training CLI routes it, the denoising UNet
    checkpointed where the config asks, seeded random weights,
    stage_zero_init, the config's optimizer, and a seeded batch."""
    from ..cli.train import train_config
    from .config import validate_config

    cfg = stage_config(stage)
    cfg["data"]["num_frames"] = frames
    validate_config(cfg)
    tcfg = train_config(cfg)
    ckpt = cfg["solver"]["denoising_unet_gradient_checkpointing"]
    unet_config = dataclasses.replace(models.unet_config, gradient_checkpointing=ckpt)
    models = dataclasses.replace(models, unet_config=unet_config)
    pipe = init_pipeline_random_(VExpressPipeline(models, device=device), seed=0)
    comps = stage_zero_init(pipe.components(), tcfg.train_stage)
    optimizer, mask = make_optimizer(comps, tcfg)
    step_fn, _ = build_train_step(pipe, tcfg, optimizer)
    audio_dim = models.audio_projection_kwargs.get("embedding_dim", 768)
    batch = synthetic_train_batch(size, frames, audio_dim, seed=3, device=device)
    return StageStep(tcfg, unet_config, comps, optimizer, mask, step_fn, batch)
