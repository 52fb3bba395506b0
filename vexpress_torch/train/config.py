"""Training-YAML parsing: key registry, routing, and validation.

The port's own copy of vexpress_tpu/train/config.py (pure Python, no yaml or
numpy: the caller parses the YAML into a dict). A verbatim reference config
(training_configs/stage_*.yaml) must load and route correctly:
`solver.mixed_precision` and `weight_dtype` drive the compute dtype,
`solver.scale_lr` applies the reference's LR scaling rule (train.py:453-461),
`data.audio_embeddings_type` is validated (train.py:306-310), and every key
the trainer does not understand produces a warning instead of silent
acceptance.
"""

from __future__ import annotations

from typing import Dict, List

# Every key the reference's train.py + our extensions understand, per section.
# Keys present in a config but absent here are warned about — a typo like
# `use_8bit_adm` would otherwise silently train with 4x the optimizer memory.
KNOWN_KEYS: Dict[str, tuple] = {
    "": (
        "data", "module_training", "solver", "val", "noise_scheduler_kwargs",
        "train_stage", "save_all", "weight_dtype", "uncond_ratio",
        "noise_offset", "snr_gamma", "enable_zero_snr",
        "base_model_path", "vae_model_path", "audio_encoder_path",
        "reference_net_path", "denoising_unet_path",
        "denoising_unet_state_dict_type", "motion_module_path",
        "v_kps_guider_path", "audio_projection_path",
        "stage1_ckpt_dir", "stage1_ckpt_step",
        "seed", "resume_from_checkpoint", "checkpointing_steps", "output_dir",
        # extensions of the JAX package, accepted by both
        "model_overrides", "unet_config_path",
        # the training CLI's LoRA section (the JAX registry lacks it and warns
        # that it is ignored, though its CLI reads it)
        "lora",
    ),
    "data": (
        "train_bs", "train_width", "train_height", "meta_paths", "flip_rate",
        "sample_rate", "num_frames", "reference_margin",
        "num_padding_audio_frames", "lip_loss_weight",
        "audio_embeddings_type", "reference_drop_rate", "kps_drop_rate",
    ),
    "module_training": (
        "denoising_unet", "reference_net", "v_kps_guider",
        "audio_projection", "motion_module",
    ),
    "solver": (
        "gradient_accumulation_steps", "mixed_precision",
        "enable_xformers_memory_efficient_attention",  # the flash kernels are always on
        "reference_net_gradient_checkpointing",
        "denoising_unet_gradient_checkpointing",
        "max_train_steps", "max_grad_norm",
        "learning_rate", "scale_lr", "lr_warmup_steps", "lr_scheduler",
        "use_8bit_adam", "adam_beta1", "adam_beta2", "adam_weight_decay",
        "adam_epsilon",
    ),
    # the reference declares val.validation_steps but never reads it
    # (the reference's train.py has no other 'validation') — accepted, unused
    "val": ("validation_steps",),
    "noise_scheduler_kwargs": (
        "num_train_timesteps", "beta_start", "beta_end", "beta_schedule",
        "steps_offset", "clip_sample",
    ),
}

_DTYPES = ("fp16", "bf16", "fp32")


def check_config_keys(cfg: Dict) -> List[str]:
    """Return warning strings for keys the trainer does not understand."""
    warnings = []
    for key, value in cfg.items():
        if key not in KNOWN_KEYS[""]:
            warnings.append(f"unknown config key '{key}' — ignored")
            continue
        if key in KNOWN_KEYS and isinstance(value, dict):
            for sub in value:
                if sub not in KNOWN_KEYS[key]:
                    warnings.append(f"unknown config key '{key}.{sub}' — ignored")
    return warnings


def resolve_dtype(cfg: Dict, cli_dtype: str = "") -> str:
    """Compute dtype: CLI --dtype wins; else solver.mixed_precision, else the
    top-level weight_dtype (reference train.py:265-272). fp16 maps to bf16 —
    the mixed-precision format of both packages (same exponent range as fp32,
    no loss scaler needed)."""
    src = cli_dtype or ""
    if not src:
        src = (cfg.get("solver") or {}).get("mixed_precision") or ""
    if not src:
        src = cfg.get("weight_dtype") or ""
    if not src:
        return "fp32"
    if src not in _DTYPES:
        raise ValueError(f"unsupported dtype {src!r}; use one of {_DTYPES}")
    return "bf16" if src == "fp16" else src


def effective_learning_rate(cfg: Dict, num_processes: int = 1) -> float:
    """reference train.py:453-461: scale_lr multiplies by
    grad_accum * train_bs * num_processes."""
    solver = cfg["solver"]
    lr = float(solver["learning_rate"])
    if solver.get("scale_lr", False):
        lr *= (int(solver.get("gradient_accumulation_steps", 1))
               * int(cfg["data"]["train_bs"]) * int(num_processes))
    return lr


def validate_config(cfg: Dict) -> None:
    """Hard errors the reference also raises."""
    aet = (cfg.get("data") or {}).get("audio_embeddings_type", "global")
    if aet != "global":
        raise ValueError(
            f"Do not support audio_embeddings_type={aet!r}; only 'global' "
            "(reference train.py:306-310)")
    wd = cfg.get("weight_dtype")
    if wd is not None and wd not in _DTYPES:
        raise ValueError(f"Do not support weight dtype: {wd} during training")


def scheduler_kwargs(cfg: Dict, enable_zero_snr: bool) -> Dict:
    """Route noise_scheduler_kwargs into our SchedulerConfig fields
    (reference train.py builds DDIMScheduler(**sched_kwargs) the same way)."""
    ns = dict(cfg.get("noise_scheduler_kwargs") or {})
    kw = {k: ns[k] for k in ("num_train_timesteps", "beta_start", "beta_end",
                             "beta_schedule", "steps_offset", "clip_sample")
          if k in ns}
    kw["prediction_type"] = "v_prediction" if enable_zero_snr else "epsilon"
    kw["rescale_betas_zero_snr"] = bool(enable_zero_snr)
    return kw
