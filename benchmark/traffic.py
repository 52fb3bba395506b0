"""The one traffic generator: a traffic file's parameters and a seed give
every request of a run. A clip request is the pipeline tools' seeded clip
(vexpress_torch/tools/common.py `clip_kwargs`, copied): a uniform reference
image, uniform uint8 keypoint frames, 0.1-scaled Gaussian audio at the
file's sample rate and frame rate, and unit Gaussian initial latents; every
clip of a run has the same sizes, and its contents come from (seed, index)."""

from __future__ import annotations

from typing import Dict

import numpy as np


def clip_inputs(traffic: Dict, cfg: Dict, seed: int, index: int) -> Dict[str, np.ndarray]:
    """The inputs of clip `index` of the run seeded `seed`."""
    rng = np.random.default_rng([seed, index])
    h, w, f = cfg["height"], cfg["width"], traffic["frames"]
    latent_c = cfg["unet"].get("in_channels", 4)
    return dict(
        reference_image=rng.uniform(0, 1, (h, w, 3)).astype(np.float32),
        kps_images=rng.integers(0, 256, (f, h, w, 3), dtype=np.uint8),
        audio_waveform=(traffic["audio_scale"] * rng.standard_normal(
            int(f / cfg["fps"] * cfg["sample_rate"]))).astype(np.float32),
        latents=rng.standard_normal((f, h // 8, w // 8, latent_c)).astype(np.float32),
    )


def clip_settings(traffic: Dict, cfg: Dict) -> Dict:
    """The call's settings, as the reference pipeline reads them."""
    return dict(frames=traffic["frames"], steps=traffic["steps"], sampler=traffic["sampler"],
                guidance_scale=cfg["guidance_scale"], context_frames=cfg["context_frames"],
                context_overlap=cfg["context_overlap"],
                reference_attention_weight=cfg["reference_attention_weight"],
                audio_attention_weight=cfg["audio_attention_weight"],
                num_pad_audio_frames=cfg["num_pad_audio_frames"],
                median_filter=cfg["median_filter"])
