"""The window step's time and its per-stage split: the port of
tools/bench_window_step.py.

Times the pipeline's own `build_blended_denoise_step` (gather the windows,
the denoising UNet under CFG in groups of `--group`, the 1/count-weighted
scatter-add, one DDIM step) over a 124-frame latent: 6 windows of 24 with
an overlap of 4, 25 DDIM steps, CFG 3.5, the banks in CFG order (the zero
uncond half first), seeded random weights and inputs. The steps are chained
(each takes the previous one's latents) and timed by CUDA events; the
124-frame denoise estimate is 25 such steps. At `--group 1` it also splits
one UNet call of the step into profile_step's stages.

    python -m vexpress_torch.tools.bench_window_step [--group 2]     # on the card
    python -m vexpress_torch.tools.bench_window_step --device cpu --tiny --frames 12 --height 64
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import torch

from ..pipelines.context import compute_context_windows
from ..pipelines.pipeline import build_blended_denoise_step
from .common import add_device_args, card_line, random_pipeline, sync, time_ms, tool_device
from .profile_step import split_forward, stage_table

GUIDANCE, STEPS, WINDOW, OVERLAP = 3.5, 25, 24, 4


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_args(p)
    p.add_argument("--group", type=int, default=1, help="windows a UNet call (window_group)")
    p.add_argument("--frames", type=int, default=124, help="the clip's latent frames")
    p.add_argument("--window", type=int, default=WINDOW, help="context frames (overlap 4)")
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--reps", type=int, default=10)
    return p.parse_args(argv)


def step_inputs(pipe, frames: int, h: int, w: int, seed: int = 0):
    """Seeded latents, kps features, audio tokens and CFG-ordered banks."""
    cfg, dt, dev = pipe.m.unet_config, pipe.m.dtype, pipe.device
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, dtype=dt):
        return torch.randn(shape, generator=g).to(device=dev, dtype=dtype)

    latents = rnd(frames, h, w, 4, dtype=torch.float32)
    tokens = pipe.m.audio_projection_kwargs.get("num_queries", 5)
    kps_feat = rnd(frames, h, w, cfg.block_out_channels[0])
    audio_tok = rnd(frames, tokens, cfg.cross_attention_dim)
    refs = tuple(torch.cat([torch.zeros((1, n, c), dtype=dt, device=dev), rnd(1, n, c)])
                 for n, c in cfg.ref_feature_shapes(h, w))
    scales = (torch.tensor(0.95, dtype=dt, device=dev), torch.tensor(3.0, dtype=dt, device=dev))
    return latents, (kps_feat, audio_tok, refs, *scales, False)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    device = tool_device("bench_window_step", args.device)
    print(card_line(device), flush=True)
    t0 = time.perf_counter()
    pipe = random_pipeline(args.tiny, device)
    sync(device)
    print(f"pipeline built in {time.perf_counter() - t0:.1f}s", flush=True)
    h = w = args.height // 8
    windows, inv_counts = compute_context_windows(args.frames, args.window, OVERLAP)
    n_windows = windows.shape[0]
    n_groups = -(-n_windows // args.group)
    latents, cond = step_inputs(pipe, args.frames, h, w)
    predict = pipe._predict_fn(GUIDANCE)
    step_fn = build_blended_denoise_step(predict, pipe.scheduler, windows, inv_counts, STEPS,
                                         window_group=args.group)
    t = int(pipe.scheduler.timesteps(STEPS)[0])
    state = {"lat": latents}

    def one():
        with torch.inference_mode():
            state["lat"] = step_fn(state["lat"], t, cond)
        return state["lat"]

    step_ms = time_ms(one, device, args.reps)
    finite = bool(torch.isfinite(state["lat"]).all())
    est_s = STEPS * step_ms / 1e3
    print(f"window step g={args.group} ({n_windows} windows, {n_groups} UNet calls, chained): "
          f"{step_ms:.1f} ms, {step_ms / n_groups:.1f} ms a UNet call", flush=True)
    print(f"=> denoise estimate for {args.frames} frames at {STEPS} steps: {est_s:.2f}s",
          flush=True)
    rec = {"group": args.group, "frames": args.frames, "windows": n_windows,
           "unet_calls_a_step": n_groups, "step_ms": step_ms, "unet_call_ms": step_ms / n_groups,
           "denoise_estimate_s": est_s, "finite": finite, "device": device.type}
    if args.group == 1:
        stages = split_forward(pipe.denoising_unet, one, device)  # the step's last UNet call
        for line in stage_table(stages, step_ms / n_groups):
            print("  " + line, flush=True)
        rec["stages_ms"] = stages
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
