"""Where a stage-2 train step's time goes: the port of
tools/profile_train_step.py.

The step is the training CLI's: configs/stage_{2,3}.yaml's values
(train.recipe), bf16, the denoising UNet checkpointed per block where the
stage asks (stage 2), 8-bit Adam, batch 1 at 512x512, `--frames` frames (20,
the stage-2 config's), seeded random weights and batch, built by
`build_train_step`. Reported:
  - whole-step seconds over `--reps` steps after a warm step, each ended by a
    synchronize;
  - the CUDA-event split of those steps (train.step_split.StepSplit):
    conditioning, UNet forward, backward (with the checkpoint recompute),
    optimizer;
  - one more step under torch.profiler, one session a part (each part ends
    with a synchronize): its wall time, device time by kernel family, and
    device-busy share: the part's device time over its mean time in the
    timed steps' split (`busy_share`), since the profiler's own work slows
    the profiled step, and over the profiled part's wall time
    (`busy_share_of_profiled_wall`);
  - the step's FLOPs (unet_step_flops.count_flops over one step: the aten
    counter's forward, recompute and backward, plus the flash kernels' from
    their launches) and the achieved TFLOP/s and MFU against 989 TFLOP/s;
  - the peak allocated device memory of the timed steps.

    python -m vexpress_torch.tools.profile_train_step [--frames 20] [--stage 2] [--reps 3]
    python -m vexpress_torch.tools.profile_train_step --device cpu --tiny --height 64 --frames 2 --reps 1
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import time
from typing import Dict

import torch

from ..train import TrainState
from ..train.recipe import build_stage_step
from ..train.step_split import MARKS, PARTS, StepSplit
from .common import (PEAK_BF16, add_device_args, card_line, families_ms, kernel_events,
                     device_us, peak_mib, pipeline_models, sync, tool_device)
from .unet_step_flops import count_flops


class PartProfiler:
    """One torch.profiler session (device activity) a part of a step,
    switched at StepSplit's marks; a synchronize closes each part. On the CPU
    only the parts' wall times are taken. `busy_shares(split_s)` sets each
    part's device-busy shares."""

    def __init__(self, device: torch.device):
        self.device, self.prof, self.part, self.t0 = device, None, None, 0.0
        self.parts: Dict[str, dict] = {}
        self.active = False

    def on_mark(self, mark: str) -> None:
        if not self.active:
            return
        cuda = self.device.type == "cuda"
        if self.part is not None:
            sync(self.device)
            part = dict(wall_s=time.perf_counter() - self.t0, device_busy_ms=None,
                        busy_share=None, busy_share_of_profiled_wall=None, families_ms={})
            if cuda:
                self.prof.stop()
                busy_ms = sum(device_us(e) for e in kernel_events(self.prof)) / 1e3
                part.update(device_busy_ms=busy_ms, families_ms=families_ms(self.prof))
            self.parts[self.part], self.part = part, None
        if mark in MARKS[:-1]:
            self.part = PARTS[MARKS.index(mark)]
            if cuda:
                from torch.profiler import ProfilerActivity, profile

                self.prof = profile(activities=[ProfilerActivity.CUDA])
                self.prof.start()
                sync(self.device)
            self.t0 = time.perf_counter()

    def busy_shares(self, split_s: Dict[str, float]) -> None:
        """Each part's device time over its unprofiled seconds (`split_s`,
        the timed steps' mean) and over its profiled wall time."""
        for name, part in self.parts.items():
            if part["device_busy_ms"] is not None:
                part.update(busy_share=part["device_busy_ms"] / 1e3 / split_s[name],
                            busy_share_of_profiled_wall=part["device_busy_ms"] / 1e3
                            / part["wall_s"])


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_args(p)
    p.add_argument("--frames", type=int, default=20)
    p.add_argument("--stage", type=int, default=2, choices=(2, 3))
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--height", type=int, default=512)
    return p.parse_args(argv)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    device = tool_device("profile_train_step", args.device)
    print(card_line(device), flush=True)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    models = pipeline_models(args.tiny, dtype)
    t0 = time.perf_counter()
    run = build_stage_step(models, f"stage_{args.stage}", args.frames, args.height, device)
    sync(device)
    print(f"# startup {time.perf_counter() - t0:.1f}s, {run.trainable_params / 1e6:.1f} M "
          "trainable params", flush=True)
    state = TrainState(run.models, run.optimizer)
    gen = torch.Generator(device=device).manual_seed(0)
    prof = PartProfiler(device)
    split = StepSplit(run.models["denoising_unet"], run.optimizer, device, on_mark=prof.on_mark)
    losses = []

    def step() -> float:
        nonlocal state
        split.begin()
        state, metrics = run.step_fn(state, run.batch, gen)
        losses.append(float(metrics["loss"]))
        sync(device)
        return losses[-1]

    try:
        t0 = time.perf_counter()
        step()  # warm: cuDNN's autotuning, the kernels' build, the allocator
        print(f"# warm step {time.perf_counter() - t0:.1f}s", flush=True)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        times = []
        for _ in range(args.reps):
            sync(device)
            t0 = time.perf_counter()
            step()
            times.append(time.perf_counter() - t0)
        peak = peak_mib(device)  # the timed steps' (the FLOP counter's step keeps more)
        splits = split.splits()[1:]
        split_mean = {k: statistics.mean(s[k] for s in splits) for k in PARTS}
        print(json.dumps({"whole_step_s": times, "split_s": split_mean}), flush=True)

        with count_flops(models.unet_config.attention_head_dim) as flops:
            step()
        prof.active = True
        step()
        prof.active = False
    finally:
        split.remove()
    prof.busy_shares(split_mean)
    whole = statistics.median(times)
    rec = {"stage": args.stage, "frames": args.frames, "whole_step_s": times,
           "median_step_s": whole, "split_s": split_mean, "profiled_parts": prof.parts,
           "train_step_gflop": flops["total"] / 1e9,
           "flash_kernel_gflop": flops["kernels"] / 1e9,
           "aten_gflop": {k: v / 1e9 for k, v in flops["aten"].items()},
           "s_per_frame": whole / args.frames, "peak_alloc_mib": peak,
           "losses": losses, "finite": all(math.isfinite(x) for x in losses),
           "trainable_params": run.trainable_params}
    if device.type == "cuda":
        rec["achieved_tflops"] = flops["total"] / whole / 1e12
        rec["mfu"] = rec["achieved_tflops"] * 1e12 / PEAK_BF16
    for part, p in prof.parts.items():
        share = "" if p["busy_share"] is None else (
            f", device {p['device_busy_ms']:.1f} ms = {p['busy_share']:.1%} of the timed "
            f"{split_mean[part]:.3f} s ({p['busy_share_of_profiled_wall']:.1%} of the profiled)")
        top = ", ".join(f"{k} {v:.1f}" for k, v in list(p["families_ms"].items())[:6])
        print(f"{part:<13} profiled {p['wall_s']:.3f} s{share}; device ms by family: {top}",
              flush=True)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
