"""Marginal cost of single UNet blocks at the lower resolutions: the port of
tools/bench_blocks.py.

ResnetBlock, MotionModule, SpatialTransformer (not at 8x8, where the UNet has
none) and GroupNorm at 16x16 / 1280, 8x8 / 1280 and 32x32 / 640 channels (for
512x512 frames), CFG batch 2 x 24 frames, bf16, seeded random weights; each
chained N = 6 times with a data dependency (tools.common.chain_ms), the
blocks as bench_perf_table builds them.

    python -m vexpress_torch.tools.bench_blocks                 # on the card
    python -m vexpress_torch.tools.bench_blocks --device cpu --tiny --height 64 --frames 4
"""

from __future__ import annotations

import argparse
import json
from typing import List

import torch

from .bench_perf_table import block_ops
from .common import add_device_args, card_line, chain_ms, pipeline_models, tool_device

KINDS = ("Resnet ", "MotionModule", "SpatialTransformer", "GroupNorm")
LEVELS = (2, 3, 1)  # 16x16, 8x8, 32x32 of a 64x64 latent


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_args(p)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--height", type=int, default=512)
    return p.parse_args(argv)


def main(argv=None) -> List[dict]:
    args = parse_args(argv)
    device = tool_device("bench_blocks", args.device)
    print(card_line(device), flush=True)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    cfg = pipeline_models(args.tiny, dtype).unet_config
    latent = args.height // 8
    rows = []
    with torch.inference_mode():
        for level in LEVELS:
            hw = latent >> level
            for name, op, x0, _ in block_ops(cfg, latent, hw, args.frames, device, dtype):
                if (not name.startswith(KINDS) or "concat" in name
                        or (level == 3 and "Spatial" in name)):
                    continue
                ms = chain_ms(op, x0, device, args.reps)
                print(f"{name:<46} {ms:8.3f} ms/op", flush=True)
                rows.append({"name": name, "ms": ms})
    print(json.dumps({"rows": rows, "device": device.type}), flush=True)
    return rows


if __name__ == "__main__":
    main()
