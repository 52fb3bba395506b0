"""The save_memory knobs on a long clip: the port of tools/bench_savemem.py.

  (a) the device cache of the raw kps windows on (VEXPRESS_SAVEMEM_DEV_CACHE_MB
      2048, the default) or off (0: each window group's raw frames uploaded at
      every step); the pipeline reads the variable at each call
  (b) window_group 1 against 2 under save_memory

on a 304-frame clip (16 windows), 25 DDIM steps, 512x512, bf16, seeded
random weights and inputs, median filter and YUV420 out. A warm-up call
first, then one row a configuration, and the first configuration again at
the end to show the drift between runs. Seconds are wall clock of the whole
call (its output is on the host when it returns).

    python -m vexpress_torch.tools.bench_savemem [--frames 304]     # on the card
    python -m vexpress_torch.tools.bench_savemem --device cpu --tiny --frames 12 --window 8 --height 64 --steps 2
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List

from ..pipelines.context import compute_context_windows, compute_video_length
from .common import add_clip_args, card_line, clip_kwargs, random_pipeline, sync, timed_call, \
    tool_device

CACHE_ENV = "VEXPRESS_SAVEMEM_DEV_CACHE_MB"
RUNS = (("warmup_cache_on_g1", 2048, 1), ("cache_on_g1", 2048, 1), ("cache_off_g1", 0, 1),
        ("cache_on_g2", 2048, 2), ("cache_on_g1_again", 2048, 1))  # the last: drift


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_clip_args(p, frames=304, steps=25)
    return p.parse_args(argv)


def main(argv=None) -> List[dict]:
    args = parse_args(argv)
    device = tool_device("bench_savemem", args.device)
    print(card_line(device), flush=True)
    size, win = args.height, args.window
    frames = compute_video_length(args.frames, win, 4)
    n_windows = len(compute_context_windows(frames, win, 4)[0])
    t0 = time.perf_counter()
    pipe = random_pipeline(args.tiny, device)
    sync(device)
    print(f"# startup {time.perf_counter() - t0:.1f}s; clip {frames} frames = {n_windows} "
          "windows", flush=True)
    kwargs = dict(clip_kwargs(frames, size, args.steps, win), save_memory=True)
    rows, old = [], os.environ.get(CACHE_ENV)
    try:
        for tag, cache_mb, group in RUNS:
            os.environ[CACHE_ENV] = str(cache_mb)
            dt, _, bad = timed_call(pipe, dict(kwargs, window_group=group))
            row = {"config": tag, "e2e_s": dt, "fps": frames / dt,
                   "s_per_window_step": dt / (n_windows * args.steps), "nonfinite": bad}
            print(json.dumps(row), flush=True)
            rows.append(row)
    finally:
        if old is None:
            os.environ.pop(CACHE_ENV, None)
        else:
            os.environ[CACHE_ENV] = old
    return rows


if __name__ == "__main__":
    main()
