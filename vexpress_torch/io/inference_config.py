"""Load the reference's inference_v2.yaml as it is. The port's own copy of
vexpress_tpu/io/inference_config.py.

The reference hardcodes './inference_v2.yaml' (inference.py:178) and routes
`unet_additional_kwargs` into UNet3DConditionModel.from_config_2d
(inference.py:84-90) and `noise_scheduler_kwargs` into DDIMScheduler
(inference.py:132-136). This maps the same YAML onto UNetConfig fields and a
SchedulerConfig, so a user's tuned inference yaml carries over unchanged.
`yaml` is imported inside the function.
"""

from __future__ import annotations

from typing import Dict, Tuple


def _expect(cond: bool, key: str, why: str) -> None:
    if not cond:
        raise ValueError(f"inference config: unsupported {key} — {why}")


def load_inference_config(path: str) -> Tuple[Dict, "object", str]:
    """Returns (unet_config_overrides, DDIMScheduler, sampler_name).

    sampler_name is "ddim" for the reference's `sampler: DDIM`
    (inference_v2.yaml:35) or "dpmpp_2m" for DPMSolverMultistep[Scheduler];
    both run on the same noise_scheduler_kwargs tables.

    Raises for option values this build does not implement (each is also
    non-default in the reference): cross-frame attention, decoder-only or
    resolution-subset motion modules, non-Vanilla module type, unknown
    samplers.
    """
    import yaml

    from ..diffusion.ddim import DDIMScheduler

    with open(path) as f:
        cfg = yaml.safe_load(f) or {}

    overrides: Dict = {}
    ak = cfg.get("unet_additional_kwargs") or {}
    if ak:
        _expect(ak.get("use_inflated_groupnorm", True) is True,
                "use_inflated_groupnorm=false",
                "this build normalizes per frame (InflatedGroupNorm) always")
        _expect(not ak.get("unet_use_cross_frame_attention", False),
                "unet_use_cross_frame_attention=true",
                "cross-frame attention is not implemented (off in V-Express)")
        _expect(not ak.get("motion_module_decoder_only", False),
                "motion_module_decoder_only=true",
                "motion modules are built at every level (V-Express default)")
        _expect(ak.get("motion_module_type", "Vanilla") == "Vanilla",
                "motion_module_type", "only Vanilla exists in the reference")
        res = ak.get("motion_module_resolutions", [1, 2, 4, 8])
        _expect(sorted(res) == [1, 2, 4, 8], "motion_module_resolutions",
                "motion modules are built at all four levels")
        if "unet_use_temporal_attention" in ak:
            overrides["unet_use_temporal_attention"] = bool(ak["unet_use_temporal_attention"])
        if "use_motion_module" in ak:
            overrides["use_motion_module"] = bool(ak["use_motion_module"])
        if "motion_module_mid_block" in ak:
            overrides["motion_module_mid_block"] = bool(ak["motion_module_mid_block"])
        mk = ak.get("motion_module_kwargs") or {}
        abt = mk.get("attention_block_types", ["Temporal_Self", "Temporal_Self"])
        _expect(all(t == "Temporal_Self" for t in abt), "attention_block_types",
                "only Temporal_Self blocks exist in the reference")
        # the reference builds one temporal attention block per list entry;
        # this build has exactly the 2 that V-Express ships, so another count
        # is refused rather than misloaded
        _expect(len(abt) == 2, f"attention_block_types x{len(abt)}",
                "this build constructs exactly 2 temporal attention blocks "
                "per motion transformer block")
        _expect(mk.get("temporal_position_encoding", True) in (True, None),
                "temporal_position_encoding=false", "the motion module PE is always built")
        _expect(int(mk.get("temporal_attention_dim_div", 1)) == 1,
                "temporal_attention_dim_div", "only 1 is used by V-Express")
        if "num_attention_heads" in mk:
            overrides["motion_num_attention_heads"] = int(mk["num_attention_heads"])
        if "num_transformer_block" in mk:
            overrides["motion_num_transformer_block"] = int(mk["num_transformer_block"])
        if "temporal_position_encoding_max_len" in mk:
            overrides["motion_max_len"] = int(mk["temporal_position_encoding_max_len"])

    sampler_yaml = cfg.get("sampler", "DDIM")
    sampler = {"DDIM": "ddim",
               "DPMSolverMultistep": "dpmpp_2m",
               "DPMSolverMultistepScheduler": "dpmpp_2m"}.get(sampler_yaml)
    _expect(sampler is not None, f"sampler {sampler_yaml!r}",
            "DDIM (reference) and DPMSolverMultistep (DPM-Solver++ 2M) are supported")
    ns = dict(cfg.get("noise_scheduler_kwargs") or {})
    sched_keys = ("num_train_timesteps", "beta_start", "beta_end", "beta_schedule",
                  "clip_sample", "steps_offset", "prediction_type",
                  "rescale_betas_zero_snr", "timestep_spacing")
    unknown = [k for k in ns if k not in sched_keys]
    _expect(not unknown, f"noise_scheduler_kwargs {unknown}", "unknown scheduler keys")
    return overrides, DDIMScheduler(**ns), sampler
