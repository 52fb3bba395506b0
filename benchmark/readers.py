"""What the per-layer readers of clip cells share."""

from __future__ import annotations

from typing import Dict, List

# timings of the pipeline's that lie inside its "denoise" phase
INSIDE_DENOISE = ("fused warm-up step and capture",)


def measured_clips(facts: Dict) -> List:
    """The window's clips that ran without the profiler (all of them when
    every clip was profiled)."""
    clips = facts["clips"]
    return [c for c in clips if not c.traced] or list(clips)


def outside_denoise_s(clip) -> float:
    return sum(v for k, v in clip.timings.items() if k != "denoise" and k not in INSIDE_DENOISE)
