"""The system under test, built at a configuration's sizes: the port's
pipeline with the benchmark's seeded weights. The program is imported
here, inside the functions, once the run has set its environment."""

from __future__ import annotations

import gc
from typing import Dict

import torch

from . import weights
from .reference.pipeline import build_models

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def tuples(d: Dict) -> Dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def pipeline(cfg: Dict, seed: int, device):
    """VExpressPipeline at the configuration's sizes and dtype, its
    parameters the seeded values of `benchmark.weights`."""
    from vexpress_torch.diffusion.ddim import DDIMScheduler, SchedulerConfig
    from vexpress_torch.models import UNetConfig, VAEConfig, Wav2Vec2Config
    from vexpress_torch.pipelines.pipeline import PipelineModels, VExpressPipeline

    dtype = DTYPES[cfg["dtype"]]
    models = PipelineModels(
        unet_config=UNetConfig(**tuples(cfg["unet"])), vae_config=VAEConfig(**tuples(cfg["vae"])),
        wav2vec2_config=Wav2Vec2Config(**tuples(cfg["wav2vec2"])),
        audio_projection_kwargs=tuples(cfg["audio_projection"]),
        guider_kwargs=tuples(cfg["guider"]), dtype=dtype)
    pipe = VExpressPipeline(models, device=device,
                            scheduler=DDIMScheduler(SchedulerConfig(**cfg["scheduler"])))
    weights.fill(pipe.components(), weights.table(build_models(cfg, "meta")), seed)
    return pipe


def reference(cfg: Dict, seed: int, device) -> Dict[str, torch.nn.Module]:
    """The reference modules in fp32 with the same seeded values: drawn in
    the configuration's dtype, as the program's are, and widened."""
    mods = build_models(cfg, device)
    weights.fill(mods, weights.table(mods), seed, dtype=DTYPES[cfg["dtype"]])
    return mods


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device: torch.device) -> None:
    """Return the memory of what is no longer referenced to the device."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
