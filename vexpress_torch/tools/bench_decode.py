"""VAE decode throughput at 512x512 against the chunk size, with its share of
the card's bf16 peak: the port of tools/bench_decode.py.

The decoder (sd-vae-ft-mse geometry, bf16, seeded random weights) decodes
chunks of 4, 8, 16 and 32 latents of 64x64, as `decode_latents` does: ms per
chunk (CUDA events, mean of `--reps`), ms a frame, and MFU against 989
TFLOP/s, the FLOPs counted by unet_step_flops.count_flops on one chunk. A
chunk that runs out of device memory is recorded as such; any other error
raises.

    python -m vexpress_torch.tools.bench_decode                 # on the card
    python -m vexpress_torch.tools.bench_decode --device cpu --tiny --height 64 --chunks 2 4
"""

from __future__ import annotations

import argparse
import json
from typing import List

import torch

from ..models.vae import AutoencoderKL
from ..pipelines.pipeline import LATENT_SCALE
from .common import (PEAK_BF16, add_device_args, card_line, pipeline_models, time_ms,
                     tool_device)
from .unet_step_flops import count_flops


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_args(p)
    p.add_argument("--chunks", type=int, nargs="+", default=(4, 8, 16, 32))
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--reps", type=int, default=3)
    return p.parse_args(argv)


def main(argv=None) -> List[dict]:
    args = parse_args(argv)
    device = tool_device("bench_decode", args.device)
    print(card_line(device), flush=True)
    dt = torch.bfloat16 if device.type == "cuda" else torch.float32
    vae = AutoencoderKL(pipeline_models(args.tiny, dt).vae_config)
    vae = vae.to(device=device, dtype=dt).eval().requires_grad_(False)
    h = args.height // 8
    g = torch.Generator().manual_seed(0)
    rows = []
    for chunk in args.chunks:
        lat = torch.randn((chunk, h, h, 4), generator=g).to(device)

        def decode():
            with torch.inference_mode():
                return vae.decode(lat / LATENT_SCALE)

        try:
            with count_flops(heads=1) as flops:
                decode()
            ms = time_ms(decode, device, args.reps)
        except torch.cuda.OutOfMemoryError as e:
            rows.append({"chunk": chunk, "oom": True, "error": str(e).splitlines()[0][:140]})
            print(f"chunk {chunk:3d}: out of device memory", flush=True)
            torch.cuda.empty_cache()
            continue
        row = {"chunk": chunk, "ms": ms, "ms_per_frame": ms / chunk,
               "gflop": flops["total"] / 1e9, "oom": False}
        if device.type == "cuda":
            row["mfu"] = flops["total"] / (ms * 1e-3) / PEAK_BF16
            print(f"chunk {chunk:3d}: {ms:8.1f} ms  {ms / chunk:6.1f} ms/frame  "
                  f"{flops['total'] / chunk / 1e12:.3f} TFLOP/frame  MFU {row['mfu']:5.1%}",
                  flush=True)
        else:
            print(f"chunk {chunk:3d}: {ms:8.1f} ms  {ms / chunk:6.1f} ms/frame (host clock)",
                  flush=True)
        rows.append(row)
    print(json.dumps({"rows": rows}), flush=True)
    return rows


if __name__ == "__main__":
    main()
