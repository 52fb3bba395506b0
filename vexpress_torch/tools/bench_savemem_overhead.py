"""Where save_memory's time goes on a long clip: the port of
tools/bench_savemem_overhead.py.

The same 304-frame clip (25 DDIM steps, 512x512, bf16, seeded random
weights and inputs, median filter, YUV420 out), save_memory on and then off,
each warm (an unmeasured call first). The measured call's progress_callback
stamps (the pipeline synchronizes before each) split it into conditioning
before step 1 ends, the denoise loop from step 1's end to the last step's,
and the tail after it (decode, filter, planes to the host). The difference
of the two loops is save_memory's per-group guider work and uploads.

    python -m vexpress_torch.tools.bench_savemem_overhead [--frames 304]     # on the card
    python -m vexpress_torch.tools.bench_savemem_overhead --device cpu --tiny --frames 12 --window 8 --height 64 --steps 2
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List

from ..pipelines.context import compute_context_windows, compute_video_length
from .common import add_clip_args, card_line, clip_kwargs, random_pipeline, sync, timed_call, \
    tool_device


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_clip_args(p, frames=304, steps=25)
    return p.parse_args(argv)


def main(argv=None) -> List[dict]:
    args = parse_args(argv)
    device = tool_device("bench_savemem_overhead", args.device)
    print(card_line(device), flush=True)
    size, win, steps = args.height, args.window, args.steps
    frames = compute_video_length(args.frames, win, 4)
    n_windows = len(compute_context_windows(frames, win, 4)[0])
    t0 = time.perf_counter()
    pipe = random_pipeline(args.tiny, device)
    sync(device)
    print(json.dumps({"startup_s": time.perf_counter() - t0, "frames": frames,
                      "windows": n_windows}), flush=True)
    base = clip_kwargs(frames, size, steps, win)
    rows = []
    for save_memory in (True, False):
        tag = "savemem_on" if save_memory else "savemem_off"
        timed_call(pipe, dict(base, save_memory=save_memory))  # warm, unmeasured
        stamps = []
        t_start = time.perf_counter()
        dt, _, bad = timed_call(pipe, dict(base, save_memory=save_memory),
                                progress_callback=lambda i, t: stamps.append(time.perf_counter()))
        loop = stamps[-1] - stamps[0]
        row = {"config": tag, "e2e_s": dt, "s_per_window_step": dt / (n_windows * steps),
               "cond_before_first_step_s": stamps[0] - t_start, "denoise_loop_s": loop,
               "loop_s_per_window_step": loop / (n_windows * max(steps - 1, 1)),
               "decode_download_tail_s": t_start + dt - stamps[-1], "nonfinite": bad}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
