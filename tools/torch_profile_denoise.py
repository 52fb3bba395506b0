#!/usr/bin/env python3
"""Where the time of vexpress_torch's streamed pipeline goes on one GPU.

Builds chip_smoke.py's full-width configuration (SD1.5 geometry, bf16, seeded
random weights, 512x512, 44 frames) at 2 DDIM steps, runs it once to warm up,
then runs it again under torch.profiler and prints (and writes to
chiprun_out/torch_profile.txt) the device time by kernel, by kernel family,
and the device-busy share of the wall time.

    python3 tools/torch_profile_denoise.py
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS = 2


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from vexpress_torch.tools.common import device_us, families_ms, kernel_events

    card = chip_smoke.card_line()
    pipe, kw = chip_smoke.full_pipeline(torch, STEPS)
    pipe(**kw)  # warm-up: cuDNN autotuning, allocator, kernel build
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe(**kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    phases = dict(pipe.timings)

    kernels = kernel_events(prof)
    total_us = sum(device_us(e) for e in kernels)
    fams = families_ms(prof)
    lines = [f"card: {card}",
             f"pipeline: bf16 {kw['width']}x{kw['height']}, {kw['video_length']} frames, {STEPS} DDIM"
             f" steps, CFG 3.5, wall {wall:.3f} s (profiled), phases {json.dumps(phases)}",
             f"device busy {total_us / 1e6:.3f} s = {100 * total_us / 1e6 / wall:.1f}% of wall",
             "", "by family (device ms, share):"]
    for fam, ms in fams.items():
        lines.append(f"  {fam:24s} {ms:10.1f} ms  {100 * ms * 1e3 / total_us:5.1f}%")
    lines += ["", "top kernels (device ms, calls, name):"]
    for e in sorted(kernels, key=device_us, reverse=True)[:30]:
        lines.append(f"  {device_us(e) / 1e3:10.1f} {e.count:6d}  {e.key[:110]}")
    text = "\n".join(lines)
    print(text)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/torch_profile.txt", "w") as f:
        f.write(text + "\n")
    print(json.dumps({"wall_s": wall, "device_busy_s": total_us / 1e6, "phases": phases,
                      "families_ms": fams, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
