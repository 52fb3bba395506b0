"""Seconds of one denoise step: the pipeline's "denoise" phase summed over
the window's clips that ran without the profiler, over their steps."""

from benchmark.readers import measured_clips


def read(facts):
    clips = measured_clips(facts)
    steps = facts["cell"].traffic["steps"] * len(clips)
    if not steps:
        return None
    return sum(c.timings["denoise"] for c in clips) / steps
