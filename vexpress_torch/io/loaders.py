"""Weights for the port's modules: released checkpoints, JAX param trees and
seeded random init.

`load_pipeline` builds the pipeline from the released torch checkpoints, as
vexpress_tpu/io/loaders.py does (inference.py:77-136 of the reference), with
random init where a checkpoint is absent. `load_jax_params` carries a flax
param tree (numpy arrays, e.g. from `jax.device_get(module.init(...))`) into
the matching torch module through the key and layout mapping of
`torch_export`, with a strict load. `init_random_` fills a module the way
vexpress_tpu/io/loaders.py:_host_fill does: small Gaussian values for every
weight of rank >= 2 (zero-initialised output projections included, so no
branch is inert), ones for norm scales, zeros for biases.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..models.unet_3d import UNetConfig
from ..models.vae import VAEConfig
from ..models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Model, convert_wav2vec2_state_dict
from ..pipelines.pipeline import PipelineModels, VExpressPipeline
from .torch_export import export_to_torch_state_dict, wav2vec2_torch_key
from .torch_import import (is_ignorable_audio_unconsumed, is_ignorable_unconsumed,
                           load_native_state_dict, load_torch_checkpoint, remap_lineage)

AUDIO_PROJECTION_KWARGS = dict(  # the reference's inference.py:116-126
    dim=768, depth=4, dim_head=64, heads=12, num_queries=5,
    embedding_dim=768, output_dim=768, ff_mult=4, max_seq_len=10,
)


def default_pipeline_models(dtype: torch.dtype = torch.bfloat16) -> PipelineModels:
    """Full-size V-Express geometry: SD1.5 UNets, sd-vae-ft-mse, wav2vec2-base."""
    return PipelineModels(
        unet_config=UNetConfig(),
        vae_config=VAEConfig(),
        wav2vec2_config=Wav2Vec2Config(),
        audio_projection_kwargs=dict(AUDIO_PROJECTION_KWARGS),
        dtype=dtype,
    )


def apply_model_overrides(models: PipelineModels, overrides: Dict[str, Any]) -> PipelineModels:
    """Per-module size overrides: {unet: {...}, vae: {...}, wav2vec2: {...},
    audio_projection: {...}, guider: {...}}, each a dict of config-field (or
    kwargs-key) replacements; YAML lists become tuples. The CLI's
    --model_overrides_path."""

    def tup(d):
        return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}

    known = {"unet", "vae", "wav2vec2", "audio_projection", "guider"}
    unknown = set(overrides) - known
    if unknown:
        raise ValueError(f"unknown model_overrides sections {sorted(unknown)}; "
                         f"expected a subset of {sorted(known)}")
    for section, field, is_cfg in (("unet", "unet_config", True), ("vae", "vae_config", True),
                                   ("wav2vec2", "wav2vec2_config", True),
                                   ("audio_projection", "audio_projection_kwargs", False),
                                   ("guider", "guider_kwargs", False)):
        if section in overrides:
            cur = getattr(models, field)
            new = (dataclasses.replace(cur, **tup(overrides[section])) if is_cfg
                   else {**cur, **tup(overrides[section])})
            models = dataclasses.replace(models, **{field: new})
    return models


def _find_weights_file(directory: str) -> Optional[str]:
    d = pathlib.Path(directory)
    for name in ("diffusion_pytorch_model.safetensors", "diffusion_pytorch_model.bin",
                 "model.safetensors", "pytorch_model.bin"):
        if (d / name).exists():
            return str(d / name)
    return None


def load_pipeline(
    models: Optional[PipelineModels] = None,
    base_model_path: Optional[str] = None,
    vae_path: Optional[str] = None,
    audio_encoder_path: Optional[str] = None,
    reference_net_path: Optional[str] = None,
    denoising_unet_path: Optional[str] = None,
    motion_module_path: Optional[str] = None,
    v_kps_guider_path: Optional[str] = None,
    audio_projection_path: Optional[str] = None,
    denoising_unet_state_dict_type: str = "new_attn",
    scheduler=None,
    param_dtype: Optional[torch.dtype] = None,
    device=None,
) -> VExpressPipeline:
    """A pipeline on `device` (the CUDA device unless the caller names
    another) with its modules in `param_dtype` (default `models.dtype`),
    seeded random weights (`init_pipeline_random_`), and each checkpoint
    that exists loaded over them by its native keys. A path that does not
    exist leaves its module random and says so. Checkpoint tensors that find
    no place raise (the reference's strict=False load, inference.py:79,
    would drop a misspelled key silently), but the audio encoder's CTC head
    (`lm_head.*`), which is dropped. Keeps host copies of the modules
    save_memory releases. `base_model_path` (training's SD prior: a
    diffusers SD directory or UNet file) loads into both UNets before the
    stage checkpoints overlay them (train.py:290-299)."""
    models = models or default_pipeline_models()
    if param_dtype is not None:
        models = dataclasses.replace(models, dtype=param_dtype)
    pipe = init_pipeline_random_(VExpressPipeline(models, device=device, scheduler=scheduler))
    comps = pipe.components()

    def log(msg):
        print(f"[vexpress] {msg}")

    def load_into(name, sd):
        n = _load_strict(comps[name], name, sd, is_ignorable_unconsumed)
        log(f"loaded {n} tensors into {name}")

    def resolve(path):
        if not path:
            return None
        if os.path.isdir(path):
            return _find_weights_file(path)
        if os.path.isfile(path):
            return path
        log(f"checkpoint path {path} not found — using random init")
        return None

    if base_model_path:
        f = resolve(os.path.join(base_model_path, "unet")) or resolve(base_model_path)
        if f:
            sd = load_torch_checkpoint(f)
            load_into("reference_net", sd)
            load_into("denoising_unet", sd)
            log(f"base model prior init from {f}")
    f = resolve(vae_path)
    if f:
        load_into("vae", load_torch_checkpoint(f))
    f = resolve(audio_encoder_path)
    if f:
        log(f"loaded {load_wav2vec2_weights(comps['wav2vec2'], f)} tensors into wav2vec2")
    f = resolve(reference_net_path)
    if f:
        load_into("reference_net", load_torch_checkpoint(f))
    f = resolve(denoising_unet_path)
    if f:
        load_into("denoising_unet", remap_lineage(load_torch_checkpoint(f),
                                                  denoising_unet_state_dict_type))
    f = resolve(motion_module_path)
    if f:  # the motion modules overlay the denoising UNet (inference.py:93)
        load_into("denoising_unet", load_torch_checkpoint(f))
    f = resolve(v_kps_guider_path)
    if f:
        load_into("v_kps_guider", load_torch_checkpoint(f))
    f = resolve(audio_projection_path)
    if f:
        load_into("audio_projection", load_torch_checkpoint(f))
    pipe.keep_host_copies()
    return pipe


def _load_strict(module: nn.Module, name: str, sd, ignorable) -> int:
    """Load `sd` by native keys; tensors that find no place (bar the
    `ignorable` ones) raise. Returns the number of tensors loaded."""
    n, unconsumed = load_native_state_dict(module, sd)
    unconsumed = [k for k in unconsumed if not ignorable(k)]
    if unconsumed:
        raise ValueError(f"{len(unconsumed)} checkpoint tensors had no destination in "
                         f"{name} (first: {unconsumed[:8]})")
    return n


def load_wav2vec2_weights(model: Wav2Vec2Model, path: str) -> int:
    """Load an HF wav2vec2 checkpoint (`Wav2Vec2Model`, or `Wav2Vec2ForCTC`
    with its `wav2vec2.` prefix) into `model`; the CTC head (`lm_head.*`) is
    dropped, any other tensor that finds no place raises. Returns the number
    of tensors loaded."""
    sd = {k.removeprefix("wav2vec2."): v for k, v in load_torch_checkpoint(path).items()}
    return _load_strict(model, "wav2vec2", convert_wav2vec2_state_dict(sd),
                        is_ignorable_audio_unconsumed)


@torch.no_grad()
def load_jax_params(module: nn.Module, params: Dict[str, Any]) -> nn.Module:
    """Load a flax param tree into `module` (strict: every key must match)."""
    sd = export_to_torch_state_dict(params)
    if isinstance(module, Wav2Vec2Model):
        sd = {wav2vec2_torch_key(k): v for k, v in sd.items()}
    ref = module.state_dict()
    tensors = {}
    for k, v in sd.items():
        like = ref.get(k)
        t = torch.from_numpy(np.array(v, dtype=np.float32))
        tensors[k] = t if like is None else t.to(device=like.device, dtype=like.dtype)
    module.load_state_dict(tensors, strict=True)
    return module


def load_pipeline_jax_params(pipe: VExpressPipeline, params: Dict[str, Any]) -> VExpressPipeline:
    """Load the JAX pipeline's param dict ({"vae": ..., "reference_net": ...})."""
    comps = pipe.components()
    missing = set(comps) - set(params)
    if missing:
        raise KeyError(f"params lack {sorted(missing)}")
    for name, mod in comps.items():
        load_jax_params(mod, params[name])
    return pipe


@torch.no_grad()
def init_random_(module: nn.Module, seed: int = 0, std: float = 0.02) -> nn.Module:
    """Seeded random fill on the module's device (see the module docstring)."""
    params = list(module.named_parameters())
    if not params:
        return module
    dev = params[0][1].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, p in params:
        if p.dim() >= 2:
            p.copy_(torch.randn(p.shape, generator=gen, device=dev, dtype=torch.float32) * std)
        elif name.endswith("weight"):  # rank-1 weights are norm scales
            p.fill_(1.0)
        else:
            p.zero_()
    return module


def init_pipeline_random_(pipe: VExpressPipeline, seed: int = 0) -> VExpressPipeline:
    for i, mod in enumerate(pipe.components().values()):
        init_random_(mod, seed + i)
    return pipe
