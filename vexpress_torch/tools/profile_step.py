"""Per-stage timing of the denoising UNet's forward at the window step's
shape: the port of tools/profile_step.py.

The UNet runs at CFG batch 2 x `--frames` frames, `--height`² (64x64
latents at 512), bf16, seeded random weights, on the zero-uncond-KV path
unless `--cfg_fast 0`. The whole forward is timed by CUDA events over
`--reps` calls, then one forward is split into the JAX runner's stages
(vexpress_tpu/models/piecewise.py): temb, conv_in, down_0..3, mid, up_0..3,
conv_out. The split comes from CUDA events that forward hooks on UNetBody's
submodules record: nothing synchronizes between stages, and the hooks change
no output. `--trace DIR` also writes a torch.profiler trace of 3 forwards
(utils.observability.device_trace).

    python -m vexpress_torch.tools.profile_step                 # on the card
    python -m vexpress_torch.tools.profile_step --device cpu --tiny --height 64 --frames 4
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List

import torch

from ..models.unet_3d import UNetBody
from ..utils.observability import device_trace
from .common import add_device_args, card_line, random_pipeline, sync, time_ms, tool_device
from .unet_step_flops import window_step_inputs

# stage -> (module whose pre-hook opens it, module whose hook closes it)
STAGES = ([("temb", "time_embedding", "time_embedding"), ("conv_in", "conv_in", "conv_in")]
          + [(f"down_{i}", f"down_blocks.{i}", f"down_blocks.{i}") for i in range(4)]
          + [("mid", "mid_block", "mid_block")]
          + [(f"up_{i}", f"up_blocks.{i}", f"up_blocks.{i}") for i in range(4)]
          + [("conv_out", "conv_norm_out", "conv_out")])


class StageTimer:
    """Marks each stage's start and end as the UNet runs: CUDA events on the
    card, the host clock on the CPU. `stage_ms()` reads the last forward."""

    def __init__(self, unet: UNetBody, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: Dict[str, object] = {}
        mods = dict(unet.named_modules())
        self.hooks = []
        for name, first, last in STAGES:
            self.hooks.append(mods[first].register_forward_pre_hook(self._mark(name + ".start")))
            self.hooks.append(mods[last].register_forward_hook(self._mark(name + ".end")))

    def _mark(self, key):
        def hook(*_):
            if self.cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.marks[key] = ev
            else:
                self.marks[key] = time.perf_counter()
        return hook

    def stage_ms(self) -> Dict[str, float]:
        """ms of each stage of the last forward (after a synchronize)."""
        out = {}
        for name, _, _ in STAGES:
            a, b = self.marks[name + ".start"], self.marks[name + ".end"]
            out[name] = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
        return out

    def remove(self) -> None:
        for h in self.hooks:
            h.remove()


def split_forward(unet: UNetBody, call, device: torch.device) -> Dict[str, float]:
    """One forward under a StageTimer: each stage's ms."""
    timer = StageTimer(unet, device)
    try:
        call()
        sync(device)
        return timer.stage_ms()
    finally:
        timer.remove()


def stage_table(stages: Dict[str, float], whole_ms: float) -> List[str]:
    total = sum(stages.values())
    lines = [f"{'stage':<10} {'ms':>9} {'share':>7}"]
    lines += [f"{k:<10} {v:9.2f} {v / total:7.1%}" for k, v in stages.items()]
    lines.append(f"{'stages':<10} {total:9.2f}   (whole forward {whole_ms:.2f} ms; the rest is "
                 "the glue between stages)")
    return lines


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_args(p)
    p.add_argument("--trace", type=str, default="", help="write a torch.profiler trace here")
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--cfg_fast", type=int, default=1,
                   help="use the zero-uncond-KV CFG fast path (production default)")
    return p.parse_args(argv)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    device = tool_device("profile_step", args.device)
    print(card_line(device), flush=True)
    t0 = time.perf_counter()
    pipe = random_pipeline(args.tiny, device)
    unet, dt = pipe.denoising_unet, pipe.m.dtype
    sync(device)
    print(f"startup {time.perf_counter() - t0:.1f}s", flush=True)
    h = w = args.height // 8
    inputs = window_step_inputs(pipe.m.unet_config, 2, args.frames, h, w, dt, device)
    zk = bool(args.cfg_fast)

    def call():
        with torch.inference_mode():
            return unet(*inputs, 0.95, 3.0, zero_uncond_kv=zk)

    whole = time_ms(call, device, args.reps)
    print(f"full UNet forward: {whole:.2f} ms mean of {args.reps} (cfg_fast={zk})", flush=True)
    stages = split_forward(unet, call, device)
    for line in stage_table(stages, whole):
        print(line, flush=True)
    if args.trace:
        with device_trace(args.trace) as path:
            for _ in range(3):
                call()
            sync(device)
        print(f"trace written to {path}", flush=True)
    rec = {"forward_ms": whole, "stages_ms": stages, "frames": args.frames, "latent": [h, w],
           "cfg_fast": zk, "device": device.type}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
