"""The reference's long workload: the port of tools/bench_long_sampler.py.

A 930-frame clip trimmed to whole windows (924 frames, 46 windows of 24 with
an overlap of 4), 512x512, `--save_gpu_memory` (save_memory), the median
filter and YUV420 planes, CFG 3.5, bf16, seeded random weights and inputs;
DPM-Solver++ 2M at 16 steps by default, or `--sampler ddim --steps 25` (the
reference's own sampler). One measured call. Reported: its seconds, frames/s,
the all-inclusive frames/s with the start-up (random init and, on the card,
the kernels' build) added, the whole call's peak device memory (allocated and
reserved) and each by stretch: conditioning, denoise and decode, as
`common.PeakSplit` splits it. Beside them the V100's published figures for
the reference's DDIM-25 run of the workload (2,617 s, 0.36 frames/s, 7,956
MiB; SURVEY.md section 6).

    python -m vexpress_torch.tools.bench_long_sampler                          # on the card
    python -m vexpress_torch.tools.bench_long_sampler --sampler ddim --steps 25
    python -m vexpress_torch.tools.bench_long_sampler --device cpu --tiny --frames 12 --window 8 --height 64 --steps 2
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import torch

from ..ops import flash
from ..pipelines.context import compute_context_windows, compute_video_length
from .common import (PeakSplit, add_clip_args, card_line, clip_kwargs, random_pipeline, sync,
                     timed_call, tool_device)

V100_PUBLISHED = {"e2e_s": 2617.0, "fps": 0.36, "peak_mib": 7956.0, "sampler": "ddim@25"}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_clip_args(p, frames=930, steps=16)
    p.add_argument("--sampler", type=str, default="dpmpp_2m", choices=("dpmpp_2m", "ddim"))
    return p.parse_args(argv)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    device = tool_device("bench_long_sampler", args.device)
    print(card_line(device), flush=True)
    size, win = args.height, args.window
    frames = compute_video_length(args.frames, win, 4)
    n_windows = len(compute_context_windows(frames, win, 4)[0])
    t0 = time.perf_counter()
    if device.type == "cuda":
        flash.build()
    pipe = random_pipeline(args.tiny, device)
    sync(device)
    startup_s = time.perf_counter() - t0
    print(json.dumps({"startup_s": startup_s, "frames": frames, "windows": n_windows}),
          flush=True)
    kwargs = dict(clip_kwargs(frames, size, args.steps, win), sampler=args.sampler,
                  save_memory=True)
    split = None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        split = PeakSplit(pipe)
    dt, video, bad = timed_call(pipe, kwargs)
    peaks = {k: v * 1024 for k, v in split.finish().items()} if split else None
    reserved = {k: v * 1024 for k, v in split.reserved.items()} if split else None
    rec = {"config": f"{args.sampler}@{args.steps}_save_memory_{frames}f",
           "e2e_s": dt, "e2e_fps": frames / dt, "startup_s": startup_s,
           "all_inclusive_fps": frames / (startup_s + dt),
           "s_per_window_step": dt / (n_windows * args.steps),
           "phases_s": dict(pipe.timings),
           "peak_alloc_mib": max(peaks.values()) if peaks else None,
           "peak_alloc_by_stretch_mib": peaks,
           "peak_reserved_mib": max(reserved.values()) if reserved else None,
           "peak_reserved_by_stretch_mib": reserved,
           "planes": [list(p.shape) for p in video], "nonfinite": bad,
           "v100_published": V100_PUBLISHED,
           "all_inclusive_vs_v100": frames / (startup_s + dt) / V100_PUBLISHED["fps"]}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
