"""Seconds of a clip outside the denoise loop: the pipeline's own phases
(`VExpressPipeline.timings`, each ended by a synchronize) other than
"denoise": the reference latent, the reference-net banks, the kps features,
the audio tokens and the decode tail, per clip, over the window's clips
that ran without the profiler."""

from benchmark.readers import measured_clips, outside_denoise_s


def read(facts):
    clips = measured_clips(facts)
    if not clips:
        return None
    return sum(outside_denoise_s(c) for c in clips) / len(clips)
