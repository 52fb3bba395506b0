"""The share of the chip's peak that the model's FLOPs of a clip make of
its time: `benchmark.flops.clip_flops` (reckoned from the configuration's
shapes) times the clips, over their seconds on the host clock and the
peak of the configuration's dtype, over the window's clips that ran
without the profiler."""

from benchmark.flops import clip_flops
from benchmark.peaks import PEAK_FLOPS
from benchmark.readers import measured_clips


def read(facts):
    clips = measured_clips(facts)
    if not clips:
        return None
    cell = facts["cell"]
    cfg, traffic = cell.config, cell.traffic
    flops = clip_flops(cfg, traffic["frames"], traffic["steps"]) * len(clips)
    return 100.0 * flops / (sum(c.seconds for c in clips) * PEAK_FLOPS[cfg["dtype"]])
